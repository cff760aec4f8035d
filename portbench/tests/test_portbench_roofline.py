"""The Gram's least time from its shapes, worked by hand."""

import pytest

from portbench import roofline


def test_main_path_step():
    # G_BB 100,000 x 66: 4.422e8 flops (6.60e-6 s) and 52,834,848 bytes
    # (1.5772e-5 s); the Schur block 25,000 x 66: 1.1055e8 flops
    # (1.65e-6 s) and 13,234,848 bytes (3.9507e-6 s): bytes bound both
    assert roofline.gram_flops(100_000, 66) == 442_200_000
    assert roofline.gram_bytes(100_000, 66) == 52_834_848
    step = roofline.gram_least_s(100_000, 66) + roofline.gram_least_s(25_000, 66)
    assert step == pytest.approx(52_834_848 / 3.35e12 + 13_234_848 / 3.35e12)
    assert step == pytest.approx(19.722e-6, rel=1e-4)


def test_pta_evaluation():
    # 68 x (8,824 + 2,206) rows x 106: per member 100,081,808 + 25,020,452
    # flops and 7,572,640 + 1,960,576 bytes: bytes bound, 0.1935 ms
    assert roofline.gram_flops(8_824, 106) == 8_824 * 106 * 107
    assert roofline.gram_bytes(8_824, 106) == 7_572_640
    assert roofline.gram_bytes(2_206, 106) == 1_960_576
    ev = 68 * (roofline.gram_least_s(8_824, 106)
               + roofline.gram_least_s(2_206, 106))
    assert ev == pytest.approx(68 * (7_572_640 + 1_960_576) / 3.35e12)
    assert ev == pytest.approx(0.19351e-3, rel=1e-3)


def test_operations_bound_when_wide():
    # q = 480: 480 * 481 / 2 * 2 flops a row against 3,840 bytes a row
    n, q = 100_000, 480
    assert roofline.gram_least_s(n, q) == pytest.approx(n * q * (q + 1) / 67e12)

"""The test run's thread settings (the root conftest.py) reach the worker.

Each test worker runs torch's intra-op pool, MKL and OpenBLAS on one
thread, and ``tests/conftest.py`` still gives JAX its eight virtual CPU
devices. A test that sets more threads restores them, so this holds in
whichever worker runs this file.
"""

import os

import torch


def test_one_thread_per_worker():
    assert torch.get_num_threads() == 1
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        assert os.environ[var] == "1", var
    assert ("--xla_force_host_platform_device_count=8"
            in os.environ["XLA_FLAGS"].split())

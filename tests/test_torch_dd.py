"""Double-double parity: pint_tpu_torch.ops.dd against pint_tpu.ops.dd.

The error-free transforms are plain IEEE float64 arithmetic, so on
normal-range inputs the two packages agree bit for bit. Subnormals are
left out: XLA:CPU flushes them to zero where PyTorch keeps them
(pint_tpu/ops/dd.py module docstring).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pint_tpu.ops import dd as jdd
from pint_tpu_torch.ops import dd


def _pairs(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    # mixed magnitudes, far from the subnormal range
    a = rng.uniform(-1, 1, n) * 10.0 ** rng.uniform(-30, 30, n)
    b = rng.uniform(-1, 1, n) * 10.0 ** rng.uniform(-30, 30, n)
    return a, b


def _same(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return x.tobytes() == y.tobytes()


@pytest.mark.parametrize("fn", ["two_sum", "quick_two_sum", "two_prod"])
def test_eft_bitwise(fn):
    a, b = _pairs()
    if fn == "quick_two_sum":  # requires |a| >= |b|
        a, b = np.where(np.abs(a) >= np.abs(b), a, b), np.where(
            np.abs(a) >= np.abs(b), b, a)
    ref = getattr(jdd, fn)(jnp.asarray(a), jnp.asarray(b))
    out = getattr(dd, fn)(torch.as_tensor(a), torch.as_tensor(b))
    assert all(_same(r, o.numpy()) for r, o in zip(ref, out))


def test_split_bitwise():
    a, _ = _pairs(1)
    ref = jdd.split(jnp.asarray(a))
    out = dd.split(torch.as_tensor(a))
    assert all(_same(r, o.numpy()) for r, o in zip(ref, out))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_dd_arithmetic_bitwise(op):
    rng = np.random.default_rng(2)
    xh = rng.uniform(1e7, 2.6e8, 2048)
    xl = rng.uniform(-1e-9, 1e-9, 2048)
    yh = rng.uniform(-5e2, 5e2, 2048)
    yl = yh * rng.uniform(-1e-17, 1e-17, 2048)
    ref = getattr(jdd, op)(jdd.DD(jnp.asarray(xh), jnp.asarray(xl)),
                           jdd.DD(jnp.asarray(yh), jnp.asarray(yl)))
    out = getattr(dd, op)(dd.DD(torch.as_tensor(xh), torch.as_tensor(xl)),
                          dd.DD(torch.as_tensor(yh), torch.as_tensor(yl)))
    assert _same(ref.hi, out.hi.numpy()) and _same(ref.lo, out.lo.numpy())


def test_rounding_bitwise():
    rng = np.random.default_rng(3)
    hi = rng.uniform(-1e11, 1e11, 2048)
    hi[:64] = np.round(hi[:64]) + 0.5  # ties and integral hi words
    hi[64:128] = np.round(hi[64:128])
    lo = rng.uniform(-1e-6, 1e-6, 2048)
    jx = jdd.DD(jnp.asarray(hi), jnp.asarray(lo))
    tx = dd.DD(torch.as_tensor(hi), torch.as_tensor(lo))
    jf, tf = jdd.floor(jx), dd.floor(tx)
    assert _same(jf.hi, tf.hi.numpy()) and _same(jf.lo, tf.lo.numpy())
    assert _same(jdd.round_half_even_int(jx), dd.round_half_even_int(tx).numpy())
    jn, jfr = jdd.split_int_frac(jx)
    tn, tfr = dd.split_int_frac(tx)
    assert _same(jn, tn.numpy())
    assert _same(jfr.hi, tfr.hi.numpy()) and _same(jfr.lo, tfr.lo.numpy())


@pytest.mark.parametrize("s", ["53801.38605120074849", "61.485476554",
                               "-1.181D-15", "0.1", "223.9",
                               "50000.000011574074074074074"])
def test_string_round_trip_bitwise(s):
    ref, out = jdd.from_string(s), dd.from_string(s)
    assert float(ref.hi) == out.hi and float(ref.lo) == out.lo
    assert jdd.to_string(ref, 25) == dd.to_string(out, 25)
    assert jdd.to_string(ref, 21) == dd.to_string(out, 21)


def test_from_strings_vector():
    strs = ["53801.38605120074849", "50000.5", "58000.123456789012345"]
    ref = jdd.from_strings(strs)
    out = dd.from_strings(strs, device="cpu")
    assert _same(ref.hi, out.hi.numpy()) and _same(ref.lo, out.lo.numpy())


def test_self_check_cpu():
    assert dd.self_check("cpu")


def test_self_check_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dd.self_check()


def test_jacfwd_through_dd_mul():
    """Forward-mode derivatives flow through the transforms: d(x*y)/dy."""
    x = dd.DD(torch.tensor([2.6e8, -1.5e7], dtype=torch.float64),
              torch.tensor([1e-9, -3e-10], dtype=torch.float64))

    def f(d):
        out = dd.mul(x, dd.add(dd.DD(61.485476554, 0.0), d))
        return out.hi + out.lo

    J = torch.func.jacfwd(f)(torch.zeros((), dtype=torch.float64))
    np.testing.assert_allclose(J.numpy(), (x.hi + x.lo).numpy(), rtol=1e-15)


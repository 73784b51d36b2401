"""The port's ``static_gain_fast``, ``agc_complex_scan`` and
``find_signal_amplitude`` (``ops/agc.py``) against the JAX package's, on
the CPU, in float32 and in float64 (JAX under x64, turned off again in a
``finally``; the port takes the precision of its input).

Tolerance: a relative 2e-6 in float32 and 1e-13 in float64 (a few ulps).
XLA's CPU backend contracts ``avg * (1 - a) + a * |x|`` and the complex
AGC's multiply-adds into fused multiply-adds, which the port's plain
torch (the reference's C order) does not, and ``|z|`` of a complex value
is XLA's own expansion in JAX and libm's ``hypot`` in torch; the sums of
``static_gain_fast`` are of exact power-of-two weights, in XLA's and
torch's orders.  Where no contraction and no ``|z|`` enters, the two agree
bit for bit (the float32 complex AGC's gain on these inputs, not
asserted)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu.ops import agc as J
from project_desert_tortoise_tpu_torch.ops import agc as P

RTOL = {np.float32: 2e-6, np.float64: 1e-13}


def _x64(dtype):
    jax.config.update("jax_enable_x64", dtype == np.float64)


def _complex(rng, shape, dtype):
    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 0.02
    return z.astype(np.complex64 if dtype == np.float32 else np.complex128)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 40, 64, 5000])
def test_static_gain_fast_matches_jax(n, dtype):
    iq = _complex(np.random.default_rng(n), (3, n), dtype)
    _x64(dtype)
    try:
        want = np.asarray(J.static_gain_fast(jnp.asarray(iq), 1.0))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = P.static_gain_fast(torch.from_numpy(iq), 1.0).numpy()
    assert got.dtype == want.dtype == dtype and got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)


def test_static_gain_fast_silent_and_recurrence():
    """Unity gain on silence (no inf); the closed form agrees with the
    recurrence of ``static_gain`` as JAX's test has it."""
    assert float(P.static_gain_fast(np.zeros(100, np.complex64), 0.6366)) \
        == 1.0
    rng = np.random.default_rng(0)
    iq = _complex(rng, 5000, np.float32)
    slow = P.static_gain(iq, 1.0, np.float32)
    fast = float(P.static_gain_fast(iq, 1.0))
    assert abs(fast - slow) < 1e-3 * abs(slow)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_agc_complex_scan_matches_jax(dtype):
    z = _complex(np.random.default_rng(2), (2, 300), dtype) * 50
    g0 = np.full(2, 0.1, dtype)
    _x64(dtype)
    try:
        jg, jy = J.agc_complex_scan(jnp.asarray(g0), jnp.asarray(z), 0.00025)
        jg, jy = np.asarray(jg), np.asarray(jy)
    finally:
        jax.config.update("jax_enable_x64", False)
    g, y = P.agc_complex_scan(torch.from_numpy(g0), torch.from_numpy(z),
                              0.00025)
    assert y.shape == (2, 300) and y.numpy().dtype == jy.dtype
    assert g.numpy().dtype == jg.dtype == dtype
    np.testing.assert_allclose(g.numpy(), jg, rtol=RTOL[dtype], atol=0)
    np.testing.assert_allclose(y.numpy(), jy, rtol=RTOL[dtype] * 10,
                               atol=RTOL[dtype] * 1e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_find_signal_amplitude_matches_jax(dtype):
    x = np.random.default_rng(3).standard_normal((2, 1000)).astype(dtype)
    a0 = np.zeros(2, dtype)
    _x64(dtype)
    try:
        want = np.asarray(J.find_signal_amplitude(jnp.asarray(a0),
                                                  jnp.asarray(x), 0.01))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = P.find_signal_amplitude(torch.from_numpy(a0), torch.from_numpy(x),
                                  0.01).numpy()
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)
    # JAX's own check: a constant input's envelope converges to it
    const = P.find_signal_amplitude(torch.tensor(0.0), torch.full((1000,),
                                                                   2.0),
                                    0.01)
    assert abs(float(const) - 2.0) < 1e-3

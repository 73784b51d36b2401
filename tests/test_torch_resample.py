"""The port's ``ops/resample.py`` against the JAX package's, on the CPU:
``upsample`` (linear and cubic, levels 1 to 5, float32 and float64, the
clamped edges included) and ``uniform_times``, bit for bit (both
accumulate the taps in the same order from zero; float64 under x64,
turned off again in a ``finally``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu.ops import resample as J
from project_desert_tortoise_tpu_torch.ops import resample as P


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["linear", "cubic"])
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_upsample_matches_jax(level, kind, dtype):
    x = np.random.default_rng(level).normal(size=(3, 257)).astype(dtype)
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        want = np.asarray(J.upsample(jnp.asarray(x), level, kind))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = P.upsample(torch.from_numpy(x), level, kind).numpy()
    assert want.dtype == got.dtype == dtype
    assert got.shape == (3, 257 * level)
    assert np.array_equal(got, want)
    assert np.array_equal(got[:, ::level], x)          # the input samples


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_uniform_times_matches_jax(level):
    t = np.cumsum(np.full(1000, np.float32(2e-5)), dtype=np.float32)[None]
    ts_over_l = float(np.float64(1.0) / 150000.0) / level
    want = np.asarray(J.uniform_times(jnp.asarray(t), level, ts_over_l))
    got = P.uniform_times(torch.from_numpy(t), level, ts_over_l).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        P.upsample(torch.zeros(8), 2, "spline")

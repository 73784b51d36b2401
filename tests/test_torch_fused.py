"""The fused chain's plain PyTorch version (CPU) against the JAX Pallas
kernel in interpret mode, on the inputs of tests/test_pallas_fused.py.

Tolerance (docs/DESIGN.md section 4b): per lane, the emitted bits are
identical; bit times are identical on >= 99% of lanes and within one sample
period (1/fs) on the rest.  The two sides differ only where libm and XLA's
fused multiply-adds enter (sin/cos, contracted products), which can move a
Gardner pointer by one sample now and then.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu import chain as JC
from project_desert_tortoise_tpu.ops import pll as JP
from project_desert_tortoise_tpu.ops.pallas.fused_kernel import (
    fused_demod_pallas)
from project_desert_tortoise_tpu.utils.config import POES_TIP
from project_desert_tortoise_tpu_torch import chain as TC
from project_desert_tortoise_tpu_torch.ops import pll as TP
from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
    fused_demod, fused_demod_ref)

torch.set_num_threads(1)
FS = 50000.0


def _input(B, L, seed, sps, noise=0.002):
    rng = np.random.default_rng(seed)
    sym = rng.choice([-1.0, 1.0], size=(B, L // sps + 9))
    base = np.repeat(sym, sps, axis=1)[:, :L]
    re = (base * 0.01 + noise * rng.standard_normal((B, L))).astype(np.float32)
    im = (noise * rng.standard_normal((B, L))).astype(np.float32)
    tn = np.tile(np.arange(1, L + 1, dtype=np.float32) / FS, (B, 1))
    return re, im, tn


def _both(jparams, re, im, tn, gain=17.58, t_seed=None, t_pad0=None,
          ts=0.0):
    """The JAX kernel (interpret mode) and the port's plain version on the
    same inputs; tn=None with t_seed, t_pad0 (B,) numpy and ts runs both in
    time-generation mode."""
    B = re.shape[0]
    pst = JP.init_state(jparams.pll, jnp.float32, (B,))
    g0 = np.full((B,), gain, np.float32)
    kw, tkw = {}, {}
    if tn is None:
        kw = dict(t_seed=jnp.asarray(t_seed), t_pad0=jnp.asarray(t_pad0),
                  ts=ts)
        tkw = dict(t_seed=torch.from_numpy(t_seed),
                   t_pad0=torch.from_numpy(t_pad0), ts=ts)
    j = fused_demod_pallas(jparams, pst, jnp.asarray(g0),
                           (jnp.asarray(re), jnp.asarray(im)),
                           None if tn is None else jnp.asarray(tn),
                           window=512, interpret=True, **kw)
    t = fused_demod(TC.from_jax(jparams), TC.from_jax(pst),
                    torch.from_numpy(g0),
                    (torch.from_numpy(re), torch.from_numpy(im)),
                    None if tn is None else torch.from_numpy(tn), **tkw)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _check_lanes(j, t, min_emitted=100, fs=FS):
    B = j[0].shape[0]
    exact = emitted = 0
    for k in range(B):
        a, ta = j[0][k][j[2][k]], j[1][k][j[2][k]]
        b, tb = t[0][k][t[2][k]], t[1][k][t[2][k]]
        assert len(a) == len(b), k
        assert np.array_equal(a, b), k
        if np.array_equal(ta, tb):
            exact += 1
        else:
            assert np.abs(ta - tb).max() <= 1.0001 / fs, k
        emitted += len(b)
    print(f"bit times identical on {exact}/{B} lanes")
    assert exact >= 0.99 * B
    assert emitted > min_emitted
    # the final PLL quality EWMA agrees to float32 rounding noise
    np.testing.assert_allclose(j[3], t[3], atol=1e-3)


@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_fused_ref_matches_pallas(dtype):
    params = JC.make_params(POES_TIP, FS, quirks=False)
    re, im, tn = _input(128, 2048, 0, 3)
    if dtype == "int16":
        re = np.round(re * 32768.0).astype(np.int16)
        im = np.round(im * 32768.0).astype(np.int16)
    _check_lanes(*_both(params, re, im, tn))


@pytest.mark.parametrize("position", ["after_pll", "after_agc"])
def test_fused_ref_squelch_matches_pallas(position):
    params = JC.make_params(POES_TIP, FS, quirks=False)._replace(
        squelch_threshold=0.05, squelch_position=position)
    re, im, tn = _input(128, 1024, 3, 3)
    _check_lanes(*_both(params, re, im, tn))


def test_fused_ref_tight_latch_geometry():
    """step/2 - err_limit - interp = 0.025: the tightest geometry the
    capture latch admits (test_pallas_fused.py:142-190)."""
    params = JC.make_params(POES_TIP, FS, quirks=False)
    params = params._replace(step_size=6.25, baud=FS * 3 / 6.25)
    re, im, tn = _input(128, 1536, 7, 2)
    _check_lanes(*_both(params, re, im, tn))


@pytest.mark.parametrize("fn", [fused_demod, fused_demod_ref])
def test_latch_guard_and_time_generation_refused(fn):
    """The latch guard, and t_next=None (time generation) without its
    seeds, padded-head counts or a step > 0."""
    params = TC.make_params(POES_TIP, FS)
    bad = params._replace(step_size=4.0, baud=FS * 3 / 4.0)
    z = torch.zeros((4, 64))
    st = TP.init_state(params.pll, (4,), device="cpu")
    g = torch.full((4,), 17.58)
    with pytest.raises(ValueError, match="capture-latch"):
        fn(bad, st, g, (z, z), z)
    seeds = torch.zeros(4)
    for kw in ({}, dict(t_seed=seeds, ts=1.0), dict(t_pad0=seeds, ts=1.0),
               dict(t_seed=seeds, t_pad0=seeds)):
        with pytest.raises(ValueError, match="time generation"):
            fn(params, st, g, (z, z), None, **kw)


def test_pll_scan_close_to_jax():
    """The PLL alone (plain loop) against the JAX scan: the same loop up to
    float rounding (libm sin/cos, XLA's contracted multiply-adds)."""
    params = JC.make_params(POES_TIP, FS, quirks=False)
    re, im, _ = _input(16, 1024, 11, 3)
    pst = JP.init_state(params.pll, jnp.float32, (16,))
    js, jout, jlock = JP.pll_scan(params.pll, pst,
                                  (jnp.asarray(re), jnp.asarray(im)))
    ts, tout, tlock = TP.pll_scan_ref(TC.from_jax(params).pll,
                                      TC.from_jax(pst), torch.from_numpy(re),
                                      torch.from_numpy(im))
    np.testing.assert_allclose(np.asarray(jout), tout.numpy(), atol=2e-5)
    np.testing.assert_allclose(np.asarray(jlock), tlock.numpy(), atol=2e-5)
    assert np.array_equal(np.asarray(js.locked), ts.locked.numpy())
    # one step on its own is the scan's first sample
    _, (o1, l1) = TP.step(TC.from_jax(params).pll, TC.from_jax(pst),
                          torch.from_numpy(re[:, 0]), torch.from_numpy(im[:, 0]))
    assert torch.equal(o1, tout[:, 0]) and torch.equal(l1, tlock[:, 0])

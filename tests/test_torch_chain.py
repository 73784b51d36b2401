"""The modules of the unfused branches against the JAX package, on the
same inputs made with numpy: the front-half chain kernel's plain version
(against ``pll_fir_agc_pallas`` in interpret mode), the PLL scan, the AGC
scan, the squelch, the FIR interpolator and its time axis, the windowed
Gardner/Manchester scan, and the JAX states carried over by ``from_jax``.

Tolerances.  Exact where only comparisons, selects, gathers and single
float32 operations are involved (the squelch, the time axis, the
Gardner/Manchester scan on the same input).  Elsewhere the two sides round
differently: XLA's ``sin``/``cos`` differ from PyTorch's in about 5% of
float32 arguments by an ulp, and XLA contracts ``a*b - c*d`` (and the
AGC's ``gain - error*rate``) into fused multiply-adds where PyTorch rounds
each product; the FIR convolution sums in another order than XLA's conv.
So the front-half chain is held to the envelope the JAX package holds its
own two implementations to (``tests/test_pallas_chain.py``: y 1e-5, lock
1e-6, gain 1e-4), the PLL phase (up to 2*pi) to 4e-6, a few ulps, the
PLL alone at unit input amplitude to 2e-5 (the bound of
``tests/test_torch_fused.py::test_pll_scan_close_to_jax``), and the AGC
and the FIR to 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu import chain as JC
from project_desert_tortoise_tpu.ops import agc as JA, clock as JK
from project_desert_tortoise_tpu.ops import fir as JF, manchester as JM
from project_desert_tortoise_tpu.ops import pll as JP
from project_desert_tortoise_tpu.ops.pallas.chain_kernel import (
    pll_fir_agc_pallas)
from project_desert_tortoise_tpu.ops.pallas.pll_kernel import pll_scan_pallas
from project_desert_tortoise_tpu.utils.config import (
    ARGOS, POES_TIP, POES_TIP_REALTIME)
from project_desert_tortoise_tpu_torch import chain as TC
from project_desert_tortoise_tpu_torch.ops import agc as TA, clock as TK
from project_desert_tortoise_tpu_torch.ops import fir as TF, manchester as TM
from project_desert_tortoise_tpu_torch.ops import pll as TP
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    pll_fir_agc, pll_fir_agc_ref)
from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
    pll_scan_kernel)

torch.set_num_threads(1)


def _noise(shape, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32), \
        (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(a, b, atol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= atol


@pytest.mark.parametrize("cfg,fs,L,window", [
    (POES_TIP, 50000.0, 2048, 1024),
    (POES_TIP_REALTIME, 48000.0, 1024, 512),     # squelch after the PLL
    (ARGOS, 32000.0, 1024, 512),                 # interp 1
])
def test_pll_fir_agc_ref_matches_pallas(cfg, fs, L, window):
    params = JC.make_params(cfg, fs, quirks=False)
    B = 128
    re, im = _noise((B, L), 0)
    pst = JP.init_state(params.pll, jnp.float32, (B,))
    g0 = np.full((B,), 17.58, np.float32)
    jst, jg, jy, jlock = pll_fir_agc_pallas(
        params, pst, jnp.asarray(g0), (jnp.asarray(re), jnp.asarray(im)),
        window=window, interpret=True)
    tst, tg, ty, tlock = pll_fir_agc(
        TC.from_jax(params), TC.from_jax(pst), torch.from_numpy(g0),
        (torch.from_numpy(re), torch.from_numpy(im)))
    assert ty.shape == (B, L * params.interp)
    # the envelope of tests/test_pallas_chain.py
    _close(jy, ty, 1e-5)
    _close(jlock, tlock, 1e-6)
    _close(jg, tg, 1e-4)
    _close(jst.phase, tst.phase, 4e-6)          # a few ulps of 2*pi
    assert np.array_equal(np.asarray(jst.locked), tst.locked.numpy())
    # the wrapper on a CPU tensor is its plain version
    again = pll_fir_agc_ref(TC.from_jax(params), TC.from_jax(pst),
                            torch.from_numpy(g0),
                            (torch.from_numpy(re), torch.from_numpy(im)))
    assert torch.equal(again[2], ty) and torch.equal(again[1], tg)


@pytest.mark.parametrize("warm", [False, True])
def test_pll_scan_matches_jax(warm):
    """Cold (acquisition sweep) and warm (tracking, frequency set) state,
    as tests/test_pallas_pll.py."""
    params = JP.make_params(POES_TIP.pll, 50000.0)
    B, L = 128, 2048
    re, im = _noise((B, L), 1, 1.0 if warm else 0.01)
    st = JP.init_state(params, jnp.float32, (B,))
    if warm:
        st = st._replace(freq=jnp.full((B,), 0.1, jnp.float32),
                         locked=jnp.ones((B,), bool))
    z = (jnp.asarray(re), jnp.asarray(im))
    pst, pout, plock = pll_scan_pallas(params, st, z, window=1024,
                                       interpret=True)
    sst, sout, slock = JP.pll_scan(params, st, z)
    tst, tout, tlock = pll_scan_kernel(TC.from_jax(JC.make_params(
        POES_TIP, 50000.0, quirks=False)).pll, TC.from_jax(st),
        (torch.from_numpy(re), torch.from_numpy(im)))
    for jst, jout, jlock in ((pst, pout, plock), (sst, sout, slock)):
        _close(jout, tout, 2e-5)
        _close(jlock, tlock, 2e-5)
        _close(jst.phase, tst.phase, 4e-6)
        _close(jst.freq, tst.freq, 1e-6)
        assert np.array_equal(np.asarray(jst.locked), tst.locked.numpy())


@pytest.mark.parametrize("window", [0, 512])
def test_agc_scan_matches_jax(window):
    """JAX's windowed and monolithic scans against the port's one scan."""
    B, n = 16, 2048
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((B, n)) * np.linspace(0.01, 2.0, n)).astype(
        np.float32)
    g0 = np.full((B,), 17.58, np.float32)
    params = JC.make_params(POES_TIP, 50000.0, quirks=False)
    js, jy = JA.agc_scan(JA.AGCState(gain=jnp.asarray(g0)), jnp.asarray(x),
                         params.agc_attack, params.agc_decay, window=window)
    ts, ty = TA.agc_scan(TA.agc_init(17.58, (B,), device="cpu"),
                         torch.from_numpy(x), params.agc_attack,
                         params.agc_decay)
    _close(jy, ty, 1e-5)
    _close(js.gain, ts.gain, 1e-5)


def test_squelch_and_out_times_exact():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 300)).astype(np.float32)
    lock = rng.standard_normal((4, 300)).astype(np.float32)
    j = JA.squelch(jnp.asarray(x), jnp.abs(jnp.asarray(lock)), 0.15)
    t = TA.squelch(torch.from_numpy(x), torch.abs(torch.from_numpy(lock)),
                   0.15)
    assert np.array_equal(np.asarray(j), t.numpy())
    tn = rng.random((4, 100)).astype(np.float32)
    for interp in (1, 3):
        assert np.array_equal(np.asarray(JF.fir_out_times(jnp.asarray(tn),
                                                          interp)),
                              TF.fir_out_times(torch.from_numpy(tn),
                                               interp).numpy())


@pytest.mark.parametrize("cfg,fs", [(POES_TIP, 50000.0), (ARGOS, 32000.0)])
@pytest.mark.parametrize("with_history", [False, True])
def test_fir_interp_matches_jax(cfg, fs, with_history):
    params = JC.make_params(cfg, fs, quirks=False)
    taps = np.asarray(params.taps, np.float32)
    hlen = -(-(len(taps) - 1) // params.interp)
    x, h = _noise((6, 777), 4, 1.0)
    hist = h[:, :hlen] if with_history else None
    j = JF.fir_interp(jnp.asarray(x), taps, params.interp,
                      None if hist is None else jnp.asarray(hist))
    t = TF.fir_interp(torch.from_numpy(x), taps, params.interp,
                      None if hist is None else torch.from_numpy(hist))
    _close(j, t, 1e-5)


def _sym_stream(B, n, seed, step):
    """An interpolated-rate stream of +-1 symbols `step` samples long,
    with noise and a per-lane timing offset."""
    rng = np.random.default_rng(seed)
    n_sym = int(n / step) + 2
    out = np.empty((B, n), np.float32)
    for b in range(B):
        sym = rng.choice([-1.0, 1.0], n_sym)
        pos = (np.arange(n) + rng.uniform(0, step)) / step
        out[b] = sym[pos.astype(int)] + 0.1 * rng.standard_normal(n)
    return out


@pytest.mark.parametrize("cfg,fs,n_valid", [
    (POES_TIP, 50000.0, 3 * 4096),
    (POES_TIP, 50000.0, 3 * 4096 - 700),   # the activity bound cuts short
    (ARGOS, 32000.0, 4096),
])
def test_gardner_manchester_windowed_exact(cfg, fs, n_valid):
    params = JC.make_params(cfg, fs, quirks=False)
    B, window = 16, 1024 * params.interp
    cap = 4 * window if params.interp > 1 else 4096
    x = _sym_stream(B, cap, 5, params.step_size)[:, :cap]
    t = np.tile(np.arange(1, cap + 1, dtype=np.float32), (B, 1))
    args = (params.step_size, params.gardner_err_limit, params.gardner_gain,
            params.resync_threshold)
    jg, jm, jbits, jt, je = JK.gardner_manchester_windowed(
        JK.gardner_init(jnp.float32, (B,)), JM.manchester_init(jnp.float32,
                                                               (B,)),
        jnp.asarray(x), jnp.asarray(t), jnp.full((B,), n_valid), *args,
        window=window)
    tg, tm, tbits, tt, te = TK.gardner_manchester_windowed(
        TK.gardner_init((B,), device="cpu"),
        TM.manchester_init((B,), device="cpu"), torch.from_numpy(x),
        torch.from_numpy(t), n_valid, *args, window=window)
    assert tbits.dtype == torch.uint8 and te.dtype == torch.bool
    for a, b in ((jbits, tbits), (jt, tt), (je, te)):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int(np.asarray(je).sum()) > 10 * B
    for a, b in zip((*jg, *jm), (*tg, *tm)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_from_jax_carries_every_state():
    B = 3
    params = JC.make_params(POES_TIP, 50000.0, quirks=False)
    states = [JP.init_state(params.pll, jnp.float32, (B,)),
              JA.agc_init(17.58, jnp.float32, (B,)),
              JK.gardner_init(jnp.float32, (B,))._replace(
                  next_sample=jnp.arange(B, dtype=jnp.float32) + 0.5),
              JM.manchester_init(jnp.float32, (B,))._replace(
                  evenodd=jnp.ones((B,), jnp.int32))]
    kinds = (TP.PLLState, TA.AGCState, TK.GardnerState, TM.ManchesterState)
    for js, kind in zip(states, kinds):
        ts = TC.from_jax(js)
        assert isinstance(ts, kind)
        for f in js._fields:
            a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    with pytest.raises(TypeError):
        TC.from_jax(object())

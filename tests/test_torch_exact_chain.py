"""The port's exact chunk step against the JAX package's, from a carried
state: JAX's ``DemodSession`` runs the first ~0.5 s of a synthetic pass
(acquisition, lock; 0.6 s of the ARGOS one), its ``ChainState`` moves across with ``from_jax``,
and both packages' ``chunk_step`` advance three more chunks, the last one
short (a partial final chunk, which reads the quirks image's stale tail).
Modes: ``poes_tip`` with quirks on and off, ``poes_tip_realtime`` (squelch
after the PLL) and ``argos_realtime`` (interp 1, squelch after the AGC).

Tolerance.  Bits, emit masks, symbol counts, validity masks and the
Manchester state are equal.  The soft values and the states they feed
differ by the float32 envelope of ``tests/test_torch_chain.py``: XLA's
``sin``/``cos`` differ from PyTorch's by an ulp on some arguments, XLA
contracts products into fused multiply-adds, and the FIR convolution sums
in another order.  So the AGC output and the soft symbols are held to
1e-4 at unit level (the AGC's gain carries the front half's 1e-5 over the
chunks), the lock signal to 1e-6, the PLL's state to 2e-5 (the bound of
``tests/test_torch_fused.py::test_pll_scan_close_to_jax``) but its quality
EMA ``avg_phase`` to 1e-4 (it averages the angle of the data arm, whose
two components are small in ARGOS's noise, so an ulp of either moves the
angle more), the AGC gain to 1e-4, the Gardner pointers to 1e-3 samples, and bit and
symbol times to one sample period (equal where the on-time index is).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu import chain as JC
from project_desert_tortoise_tpu.models.demodulator import DemodSession
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu.utils.config import (
    ARGOS_REALTIME, POES_TIP, POES_TIP_REALTIME)
from project_desert_tortoise_tpu_torch import chain as TC

torch.set_num_threads(1)

# mode, rate, quirks, chunk samples, seconds JAX runs first (the ARGOS
# packet starts 0.4 s in)
CASES = {
    "poes_tip": (POES_TIP, 50000.0, True, 2000, 0.5),
    "poes_tip no quirks": (POES_TIP, 50000.0, False, 2000, 0.5),
    "poes_tip_realtime": (POES_TIP_REALTIME, 50000.0, True, 2400, 0.5),
    "argos_realtime": (ARGOS_REALTIME, 32000.0, True, 2400, 0.6),
}


def recording(cfg, fs):
    if cfg.name.startswith("argos"):
        iq, _ = synth.make_argos_recording(n_packets=1, fs=fs)
    else:
        iq, _ = synth.make_poes_recording(n_frames=5, fs=fs)
    iq = (iq / (np.abs(iq).max() * 1.2)).astype(np.complex64)
    t = W.time_axis(len(iq), fs, np.float32)
    ts = np.float32(1.0) / np.float32(fs)
    return iq, t, np.concatenate([t, [t[-1] + ts]]).astype(np.float32)


def _close(a, b, atol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= atol, (what, np.abs(a - b).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_step_from_a_carried_state_matches_jax(case):
    cfg, fs, quirks, chunk, warm_s = CASES[case]
    iq, t, t_ext = recording(cfg, fs)
    sess = DemodSession(cfg, fs, chunk_size=chunk, quirks=quirks)
    warm = int(warm_s * fs) // chunk * chunk
    for start in range(0, warm, chunk):
        sess.process(iq[start:start + chunk], t[start:start + chunk],
                     t_ext[start + 1:start + chunk + 1])
    assert bool(np.asarray(sess.state.pll.locked))
    jstate = sess.state
    tstate = TC.from_jax(jstate)
    params = TC.from_jax(sess.params)
    assert params == TC.make_params(cfg, fs, quirks=quirks)
    for k, n in enumerate((chunk, chunk, chunk * 5 // 8)):
        a = warm + k * chunk
        planes = (iq[a:a + n].real.copy(), iq[a:a + n].imag.copy(),
                  t[a:a + n], t_ext[a + 1:a + n + 1])
        jstate, jout = JC.chunk_step(sess.params, jstate,
                                     *map(jnp.asarray, planes))
        tstate, tout = TC.chunk_step(params, tstate,
                                     *map(torch.from_numpy, planes))
        for f in ("bits", "bit_mask", "sym_count", "sym_valid"):
            assert np.array_equal(np.asarray(getattr(jout, f)),
                                  getattr(tout, f).numpy()), (k, f)
        assert int(np.asarray(jout.bit_mask).sum()) > 0
        _close(jout.agc_stream, tout.agc_stream, 1e-4, "agc_stream")
        _close(jout.syms, tout.syms, 1e-4, "syms")
        _close(jout.locksig, tout.locksig, 1e-6, "locksig")
        _close(jout.bit_times, tout.bit_times, 1.0001 / fs, "bit_times")
    js, ts_ = jstate, tstate
    for f in ("phase", "freq", "locksig"):
        _close(getattr(js.pll, f), getattr(ts_.pll, f), 2e-5, f)
    _close(js.pll.avg_phase, ts_.pll.avg_phase, 1e-4, "avg_phase")
    assert bool(np.asarray(js.pll.locked)) == bool(ts_.pll.locked)
    _close(js.agc.gain, ts_.agc.gain, 1e-4, "gain")
    _close(js.fir_hist, ts_.fir_hist, 1e-4, "fir_hist")
    for f in ("next_sample", "half_raw"):
        _close(getattr(js.gardner, f), getattr(ts_.gardner, f), 1e-3, f)
    for f in ("clockmod", "evenodd"):
        assert int(getattr(js.manchester, f)) == int(getattr(ts_.manchester,
                                                             f))
    _close(js.x_img, ts_.x_img, 1e-4, "x_img")
    _close(js.t_img, ts_.t_img, 1.0001 / fs, "t_img")


def test_from_jax_carries_a_chain_state():
    """Every field of a JAX ``ChainState`` (the FIR history, the buffer
    images and the four stream states) carries over with its values."""
    params = JC.make_params(POES_TIP, 50000.0)
    js = JC.init_state(params, 17.5, 1000, jnp.float32)
    rng = np.random.default_rng(1)
    js = js._replace(
        x_img=jnp.asarray(rng.standard_normal(3000), jnp.float32),
        t_img=jnp.asarray(rng.uniform(0, 9, 3000), jnp.float32),
        fir_hist=jnp.asarray(rng.standard_normal(26), jnp.float32),
        gardner=js.gardner._replace(half_raw=jnp.float32(2999.5)),
        manchester=js.manchester._replace(evenodd=jnp.int32(1)))
    ts = TC.from_jax(js)
    assert isinstance(ts, TC.ChainState)
    for f in ("fir_hist", "x_img", "t_img"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for sub in ("pll", "agc", "gardner", "manchester"):
        for f in getattr(js, sub)._fields:
            a = np.asarray(getattr(getattr(js, sub), f))
            b = getattr(getattr(ts, sub), f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (sub, f)
    fresh = TC.init_state(TC.from_jax(params), 17.5, 1000, device="cpu")
    for a, b in zip(TC.from_jax(JC.init_state(params, 17.5, 1000,
                                              jnp.float32)), fresh):
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_unported_clock_and_dtype_are_refused():
    # every clock of the JAX package is ported (tests/test_torch_clocks.py
    # holds them against JAX); a clock neither package has is refused
    params = TC.make_params(POES_TIP, 50000.0)
    with pytest.raises(ValueError, match="unknown clock"):
        TC.init_state(params._replace(clock_algorithm="early_late"), 1.0,
                      100, device="cpu")
    mm = TC.init_state(params._replace(clock_algorithm="mm"), 1.0, 100,
                       device="cpu")
    assert mm.gardner.half_raw.shape == ()     # the step rides there
    up = TC.init_state(params._replace(clock_algorithm="upsampling_mm"), 1.0,
                       100, device="cpu")
    assert up.gardner.next_sample.shape == (2,)        # split pointers
    upsampling = dataclasses.replace(POES_TIP, gardner=dataclasses.replace(
        POES_TIP.gardner, algorithm="upsampling_gardner"))
    for make in (JC.make_params, TC.make_params):   # as JAX refuses it
        with pytest.raises(ValueError, match="quirks=False"):
            make(upsampling, 50000.0, quirks=True)
    # the float64 argos mode is no longer refused: its session runs in
    # float64 (tests/test_torch_argos_exact.py holds it against JAX)
    from project_desert_tortoise_tpu_torch.models.demodulator import (
        DemodSession as PortSession)
    from project_desert_tortoise_tpu_torch.utils.config import ARGOS
    sess = PortSession(ARGOS, 32000.0, device="cpu")
    t = np.arange(1, 101, dtype=np.float64) / 32000.0
    assert sess.process(np.zeros(100, np.complex128), t, t + t[0]) == []
    assert sess.state.x_img.dtype == sess.state.pll.phase.dtype == \
        torch.float64

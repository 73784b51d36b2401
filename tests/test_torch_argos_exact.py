"""The float64 ``argos`` mode's exact chain: the port against the JAX
package under x64, on the CPU (the kernels' plain versions in float64).

JAX runs this mode with ``jax_enable_x64`` on (its CLI and
``models/argos.py`` turn it on); here a module fixture turns it on and,
in a ``finally``, off again, so that the other tests of the worker run as
they always do.  The input is a synthetic one-packet ARGOS recording
(``utils/synth.make_argos_recording``, its fixed seed) in complex128, the
mode's 2,400-sample chunks.  JAX's ``DemodSession`` runs the first 0.6 s
(acquisition and lock), and its float64 ``ChainState`` carries over with
``from_jax``.  The whole session (``models/argos.py::demodulate``, the
mode's ``DemodSession`` with quality annotations) runs on that recording
written as a WAV, two packets long: the exact chain locks during the
first packet and decodes the second, in both packages.

Tolerance.  Exact where XLA computes what the port computes: the squelch,
the Gardner scan with the Manchester decision (compares, rint, adds and a
clamped product), bits, emit and validity masks, counts, the Manchester
state.  Otherwise the float64 envelope of three differences, each
measured here: XLA contracts products into fused multiply-adds (the AGC's
``gain - error * rate``, the loop's EMAs; an ulp, 2.2e-16, a step), the
FIR convolution sums in another order (4.4e-16), and XLA's ``sin``/``cos``
may round otherwise than PyTorch's.  The PLL's data arm, phase and
frequency are held to 1e-12; its lock signal to 1e-8, because
``q_rsqrt`` squeezes the sample's power through float32 (as the reference
does in double builds), so an ulp of that double can move the projection
by a float32 ulp (6e-8 of it; 5e-10 measured over a chunk).  The AGC, the
FIR and the soft symbols are held to 1e-12 at unit level, the Gardner
pointers to 1e-9 samples; bit and symbol times are equal where the
on-time index is, and within one sample period (``docs/DESIGN.md`` §4b)
in any case.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu import chain as JC
from project_desert_tortoise_tpu.models import argos as JArgos
from project_desert_tortoise_tpu.models.demodulator import (
    DemodSession as JSession)
from project_desert_tortoise_tpu.ops import agc as JA, clock as JCL
from project_desert_tortoise_tpu.ops import fastmath as JFM
from project_desert_tortoise_tpu.ops import fir as JF, manchester as JM
from project_desert_tortoise_tpu.ops import pll as JP
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu.utils.config import ARGOS
from project_desert_tortoise_tpu_torch import chain as TC
from project_desert_tortoise_tpu_torch.models import argos as TArgos
from project_desert_tortoise_tpu_torch.ops import agc as TA, clock as TCL
from project_desert_tortoise_tpu_torch.ops import fastmath as TFM
from project_desert_tortoise_tpu_torch.ops import fir as TF
from project_desert_tortoise_tpu_torch.ops import manchester as TM
from project_desert_tortoise_tpu_torch.ops import pll as TP

torch.set_num_threads(1)
FS = 32000.0
CHUNK = ARGOS.chunk_size            # 2,400
WARM = 8 * CHUNK                    # 0.6 s: the PLL has locked
TAIL = 1234                         # a short final chunk


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def clip():
    """The recording in complex128, its float64 time axis and that axis
    continued by one sample, and the payloads."""
    iq, payloads = synth.make_argos_recording(n_packets=2, fs=FS)
    iq = (iq / (np.abs(iq).max() * 1.2)).astype(np.complex128)
    t = W.time_axis(len(iq), FS, np.float64)
    t_ext = np.concatenate([t, [t[-1] + 1.0 / FS]])
    return iq, t, t_ext, [bytes(p) for p in payloads]


def warm_session(clip, quirks=True):
    """JAX's session after WARM samples (float64 state, PLL locked)."""
    iq, t, t_ext, _ = clip
    sess = JSession(ARGOS, FS, quirks=quirks)
    for a in range(0, WARM, CHUNK):
        sess.process(iq[a:a + CHUNK], t[a:a + CHUNK],
                     t_ext[a + 1:a + CHUNK + 1])
    assert bool(np.asarray(sess.state.pll.locked))
    assert sess.state.x_img.dtype == jnp.float64
    return sess


@pytest.fixture(scope="module")
def warm(clip):
    sess = warm_session(clip)
    return sess.params, sess.state


def _close(a, b, atol, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert a.dtype == b.dtype == np.float64, (what, a.dtype, b.dtype)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= atol, (what, err)


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b), what


def _lane(state_cls, state):
    """A port stream state with each field as a (1,) lane."""
    return state_cls(*(v.reshape(1) for v in state))


def test_fastmath_in_float64_matches_jax_x64():
    """arctan2_approx with its constants in float64, and q_rsqrt squeezing
    float64 through float32 and back: bit for bit."""
    rng = np.random.default_rng(0)
    y, x = rng.standard_normal((2, 4096)) * np.logspace(-6, 3, 4096)
    a = JFM.arctan2_approx(jnp.asarray(y), jnp.asarray(x))
    _equal(a, TFM.arctan2_approx(torch.from_numpy(y), torch.from_numpy(x)),
           "arctan2_approx")
    m = y * y + x * x
    q = JFM.q_rsqrt(jnp.asarray(m))
    assert q.dtype == jnp.float64
    _equal(q, TFM.q_rsqrt(torch.from_numpy(m)), "q_rsqrt")


@pytest.mark.parametrize("n", [CHUNK, TAIL])
def test_pll_scan_matches_jax_x64(clip, warm, n):
    iq, *_ = clip
    params, js = warm
    re, im = (np.ascontiguousarray(v[WARM:WARM + n])
              for v in (iq.real, iq.imag))
    jst, jout, jlock = JP.pll_scan(params.pll, js.pll,
                                   (jnp.asarray(re), jnp.asarray(im)))
    ts = TC.from_jax(js.pll)
    tst, tout, tlock = TP.pll_scan_ref(TC.from_jax(params).pll, ts,
                                       torch.from_numpy(re),
                                       torch.from_numpy(im))
    _close(jout, tout, 1e-12, "out")
    _close(jlock, tlock, 1e-8, "locksig")
    for f in ("phase", "freq", "sweep"):
        _close(getattr(jst, f), getattr(tst, f), 1e-12, f)
    _close(jst.locksig, tst.locksig, 1e-8, "state locksig")
    _close(jst.avg_phase, tst.avg_phase, 1e-12, "avg_phase")
    assert bool(np.asarray(jst.locked)) == bool(tst.locked)


@pytest.mark.parametrize("n", [CHUNK, TAIL])
def test_fir_agc_and_squelch_match_jax_x64(clip, warm, n):
    """The FIR, the AGC and the squelch after it on the same float64
    input: JAX's PLL output of the chunk."""
    iq, *_ = clip
    params, js = warm
    re, im = (np.ascontiguousarray(v[WARM:WARM + n])
              for v in (iq.real, iq.imag))
    _, soft, lock = JP.pll_scan(params.pll, js.pll,
                                (jnp.asarray(re), jnp.asarray(im)))
    soft, lock = np.array(soft), np.array(lock)
    taps = np.asarray(params.taps, np.float64)
    jy = np.array(JF.fir_interp(jnp.asarray(soft), taps, params.interp,
                                  js.fir_hist))
    ty = TF.fir_interp(torch.from_numpy(soft), TC.from_jax(params).taps,
                       params.interp, TC.from_jax(js).fir_hist)
    _close(jy, ty, 1e-12, "fir")
    jg, ja = JA.agc_scan(js.agc, jnp.asarray(jy), params.agc_attack,
                         params.agc_decay)
    tg, tagc = TA.agc_scan(_lane(TA.AGCState, TC.from_jax(js.agc)),
                           torch.from_numpy(jy)[None], params.agc_attack,
                           params.agc_decay)
    _close(ja, tagc[0], 1e-12, "agc")
    _close(jg.gain, tg.gain[0], 1e-12, "gain")
    ja = np.array(ja)
    jq = JA.squelch(jnp.asarray(ja), jnp.asarray(lock),
                    params.squelch_threshold)
    tq = TA.squelch(torch.from_numpy(ja), torch.from_numpy(lock),
                    params.squelch_threshold)
    _equal(jq, tq, "squelch")


@pytest.mark.parametrize("n", [CHUNK, TAIL])
@pytest.mark.parametrize("half", ["carried", "stale inside", "negative"])
def test_gardner_manchester_scan_matches_jax_x64(clip, warm, n, half):
    """JAX's gardner_scan then manchester_scan against the port's plain
    scan on the quirks image of the next chunk (the chunk's squelched AGC
    output over the carried image's tail), from the carried float64 state
    with its mid-bit pointer as carried or moved: bit for bit."""
    iq, t, *_ = clip
    params, js = warm
    rng = np.random.default_rng(n)
    y = rng.standard_normal(n) * 0.1 + np.sign(np.sin(np.arange(n) / 20.0))
    x_img = np.concatenate([y, np.asarray(js.x_img)[n:]])
    t_img = np.concatenate([t[WARM:WARM + n], np.asarray(js.t_img)[n:]])
    cap = len(x_img)
    g = js.gardner
    if half != "carried":
        g = g._replace(half_raw=jnp.float64(
            cap - 7.5 if half == "stale inside" else -3.5))
    msyms = JC.max_symbols(cap, params.step_size)
    jg, syms, times, valid, count = JCL.gardner_scan(
        g, jnp.asarray(x_img), jnp.asarray(t_img), n, params.step_size,
        params.gardner_err_limit, params.gardner_gain, msyms)
    jm, bits, btimes, emit = JM.manchester_scan(js.manchester, syms, times,
                                                valid,
                                                params.resync_threshold)
    out = TCL.gardner_manchester_scan(
        _lane(TCL.GardnerState, TC.from_jax(g)),
        _lane(TM.ManchesterState, TC.from_jax(js.manchester)),
        torch.from_numpy(x_img)[None], torch.from_numpy(t_img)[None], n,
        params.step_size, params.gardner_err_limit, params.gardner_gain,
        params.resync_threshold, msyms)
    tg, tm, tsyms, ttimes, tvalid, tcount, tbits, tbtimes, temit = out
    for what, a, b in (("syms", syms, tsyms), ("times", times, ttimes),
                       ("valid", valid, tvalid), ("bits", bits, tbits),
                       ("bit_times", btimes, tbtimes), ("emit", emit, temit)):
        _equal(a, b[0], what)
    assert int(count) == int(tcount[0]) > 10
    for f in TCL.GardnerState._fields:
        _equal(getattr(jg, f), getattr(tg, f)[0], f)
    for f in TM.ManchesterState._fields:
        _equal(getattr(jm, f), getattr(tm, f)[0], f)


@pytest.mark.parametrize("quirks", [True, False])
def test_chunk_step_from_a_carried_x64_state_matches_jax(clip, quirks):
    """Three chunks (2,400, 2,400 and a final 1,234) of both packages'
    chunk_step from JAX's mid-stream float64 state, carried over by
    from_jax, quirks on and off."""
    iq, t, t_ext, _ = clip
    sess = warm_session(clip, quirks)
    jstate, params = sess.state, TC.from_jax(sess.params)
    assert params == TC.make_params(ARGOS, FS, quirks=quirks)
    tstate = TC.from_jax(jstate)
    for leaf in (tstate.x_img, tstate.t_img, tstate.fir_hist,
                 *tstate.pll[:5], *tstate.gardner, tstate.agc.gain,
                 *tstate.manchester[2:]):
        assert leaf.dtype == torch.float64
    for k, n in enumerate((CHUNK, CHUNK, TAIL)):
        a = WARM + k * CHUNK
        planes = (np.ascontiguousarray(iq[a:a + n].real),
                  np.ascontiguousarray(iq[a:a + n].imag), t[a:a + n],
                  t_ext[a + 1:a + n + 1])
        jstate, jout = JC.chunk_step(sess.params, jstate,
                                     *map(jnp.asarray, planes))
        tstate, tout = TC.chunk_step(params, tstate,
                                     *map(torch.from_numpy, planes))
        for f in ("bits", "bit_mask", "sym_count", "sym_valid"):
            _equal(getattr(jout, f), getattr(tout, f), (k, f))
        assert int(np.asarray(jout.bit_mask).sum()) > 0
        _close(jout.agc_stream, tout.agc_stream, 1e-12, "agc_stream")
        _close(jout.syms, tout.syms, 1e-12, "syms")
        _close(jout.locksig, tout.locksig, 1e-8, "locksig")
        _close(jout.bit_times, tout.bit_times, 1.0001 / FS, "bit_times")
    for f in ("phase", "freq", "avg_phase"):
        _close(getattr(jstate.pll, f), getattr(tstate.pll, f), 1e-12, f)
    _close(jstate.pll.locksig, tstate.pll.locksig, 1e-8, "locksig")
    _close(jstate.agc.gain, tstate.agc.gain, 1e-12, "gain")
    _close(jstate.fir_hist, tstate.fir_hist, 1e-12, "fir_hist")
    for f in ("next_sample", "half_raw"):
        _close(getattr(jstate.gardner, f), getattr(tstate.gardner, f), 1e-9,
               f)
    for f in ("clockmod", "evenodd"):
        _equal(getattr(jstate.manchester, f), getattr(tstate.manchester, f),
               f)
    _close(jstate.x_img, tstate.x_img, 1e-12, "x_img")
    _close(jstate.t_img, tstate.t_img, 1.0001 / FS, "t_img")


def test_demodulate_with_quality_matches_jax_x64(clip, tmp_path):
    """models/argos.py::demodulate (DemodSession over the whole WAV from
    its start, the unlocked PLL's acquisition sweep, annotate_quality on)
    against JAX's: the packet, its payload and time, its quality, SNR and
    carrier annotations, and the counters."""
    iq, _, _, payloads = clip
    wav = str(tmp_path / "argos.wav")
    W.write_iq_wav(wav, iq, int(FS))
    want = JArgos.demodulate(wav)
    got = TArgos.demodulate(wav, device="cpu")
    assert [bytes(f.data) for f in got.frames] == \
        [bytes(f.data) for f in want.frames] == payloads[1:]
    for a, b in zip(want.frames, got.frames):
        assert a.inverted == b.inverted and a.complete == b.complete
        assert abs(a.time - b.time) <= 1.0001 / FS
        assert abs(a.quality_db - b.quality_db) <= 1e-9
        assert abs(a.snr_db - b.snr_db) <= 1e-9
        assert abs(a.carrier_hz - b.carrier_hz) <= 1e-6
    assert (got.total_samples, got.total_symbols, got.total_bits) == \
        (want.total_samples, want.total_symbols, want.total_bits)
    assert abs(got.avg_phase - want.avg_phase) <= 1e-12
    assert abs(got.lock_freq_hz - want.lock_freq_hz) <= 1e-6

"""The exact chain's other clocks in the port against the JAX package, on
the CPU (the kernels' plain versions).

- Each plain clock + Manchester scan (``ops/clock.py``:
  ``mm_manchester_scan``, ``upsampling_gardner_manchester_scan``,
  ``upsampling_mm_manchester_scan``) against JAX's ``mm_scan``,
  ``upsampling_gardner_scan`` or ``upsampling_mm_scan`` followed by
  ``manchester_scan`` on the same images and carried states, float32 and
  float64 (JAX under x64, turned off again in a ``finally``): every output
  and state bit for bit.  Three lanes: valid lengths short of the image,
  mid-bit pointers inside it, before it and past it, inactive slots at the
  end.
- ``DemodSession`` with each clock against JAX's on
  ``make_poes_recording(n_frames=8)``: ``"mm"`` in both quirks modes, the
  upsampling clocks with ``quirks=False``, in the JAX tests' settings
  (``tests/test_clock.py:118-121``, ``tests/test_upsampling_clock.py:
  18-27``).  Tolerance, the ``docs/DESIGN.md`` §4b contract: frame counts,
  payloads and polarity identical, timestamps equal or one input sample
  period apart.  The front of the chain differs from JAX's by float32 ulps
  from the first sample (libm's ``sin``/``cos`` in the PLL, the
  convolution's order); the Gardner clock on the upsampled stream carries
  them in its pointer's fraction, which nothing pulls back below the
  upsampled resolution, so there a shifted timestamp is no rarity (two of
  five frames here), while ``"mm"`` and ``"upsampling_mm"`` give JAX's
  lines exactly.
- Quirks mode rejects the upsampling clocks, as JAX's ``make_params``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu.models.demodulator import (
    DemodSession as JaxSession)
from project_desert_tortoise_tpu.ops import clock as JC
from project_desert_tortoise_tpu.ops import manchester as JM
from project_desert_tortoise_tpu.ops import resample as JR
from project_desert_tortoise_tpu.utils import config as JCFG
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu_torch import chain
from project_desert_tortoise_tpu_torch.models.demodulator import (
    DemodSession as PortSession)
from project_desert_tortoise_tpu_torch.ops import clock as PC
from project_desert_tortoise_tpu_torch.ops import manchester as PM
from project_desert_tortoise_tpu_torch.utils import config as TCFG

torch.set_num_threads(1)
FS = 50000.0
THR = 0.4          # the Manchester resync threshold of the scans
STEP = float(np.float32(FS * 3 / 8320.0))     # poes_tip's interpolated step


def clock_cfg(cfg_mod, algorithm):
    """The JAX tests' configuration of a clock, from either package's
    ``utils/config.py``."""
    P = cfg_mod.POES_TIP
    if algorithm == "mm":
        return dataclasses.replace(P, gardner=dataclasses.replace(
            P.gardner, algorithm="mm", error_limit=3.0, gain=0.15))
    # MATLAB preprocesses at the input rate: a plain LPF (interp 1), then
    # the clock loop upsamples the values L x
    return dataclasses.replace(
        P, fir=cfg_mod.FIRConfig(cutoff_hz=11000.0, base_order=26,
                                 target_rate_hz=None, interp=1),
        gardner=dataclasses.replace(
            P.gardner, algorithm=algorithm, upsample_level=4,
            upsample_kind="cubic", gain=1.0, error_limit=2.0))


def _images(cap, step, dtype, seed):
    """x, t (3, cap): +-1 symbols `step` samples long with noise."""
    rng = np.random.default_rng(seed)
    x = np.empty((3, cap))
    for b in range(3):
        sym = rng.choice([-1.0, 1.0], int(cap / step) + 2)
        pos = (np.arange(cap) + rng.uniform(0, step)) / step
        x[b] = sym[pos.astype(int)] + 0.2 * rng.standard_normal(cap)
    t = np.tile(np.arange(1, cap + 1) / FS, (3, 1))
    return x.astype(dtype), t.astype(dtype)


def _man_states(dtype):
    cur = np.array([0.0, 0.9, -1.2], dtype)
    prev = np.array([0.0, -0.8, -1.1], dtype)
    prevprev = np.array([0.0, 0.7, 0.3], dtype)
    clockmod = np.array([0, 1, 0], np.int32)
    evenodd = np.array([0, 0, 1], np.int32)
    j = JM.ManchesterState(*(jnp.asarray(a) for a in (clockmod, evenodd, cur,
                                                     prev, prevprev)))
    p = PM.ManchesterState(*(torch.from_numpy(a) for a in (
        clockmod, evenodd, cur, prev, prevprev)))
    return j, p


def _eq(want, got, what):
    want = np.asarray(want)
    got = got.numpy()
    assert want.shape == got.shape, what
    assert want.dtype == got.dtype, (what, want.dtype, got.dtype)
    assert np.array_equal(want, got), what


def _check_outputs(jg, jm_state, syms, times, valid, count, p_out):
    """JAX's (state rows, Manchester) against the port's scan outputs."""
    g, m, psyms, ptimes, pvalid, pcount, pbits, pbtimes, pemit = p_out
    jm, bits, btimes, emit = jm_state
    for want, got, what in zip(jg, g, ("next_sample", "half_raw",
                                       "prev_bit")):
        _eq(want, got, what)
    for f in JM.ManchesterState._fields:
        _eq(getattr(jm, f), getattr(m, f), f)
    for want, got, what in ((syms, psyms, "syms"), (times, ptimes, "times"),
                            (valid, pvalid, "valid"),
                            (count, pcount, "count"), (bits, pbits, "bits"),
                            (btimes, pbtimes, "bit_times"),
                            (emit, pemit, "emit")):
        _eq(want, got, what)
    assert 0 < int(pcount.min()) and int(pcount.max()) < psyms.shape[1]


def _x64(dtype):
    jax.config.update("jax_enable_x64", dtype == np.float64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mm_manchester_scan_matches_jax(dtype):
    cap = 3000
    x, t = _images(cap, STEP, dtype, 1)
    n = np.array([cap, cap - 700, cap - 1], np.int32)
    ns = np.array([0.0, 3.4, -0.5], dtype)
    prev = np.array([0.0, 0.8, -1.3], dtype)
    ss = np.array([STEP, STEP * 1.0004, STEP * 0.9991], dtype)
    msyms = int(cap / STEP * 1.05) + 8
    _x64(dtype)
    try:
        jm0, pm0 = _man_states(dtype)
        st, (syms, times, valid, count) = JC.mm_scan(
            tuple(jnp.asarray(a) for a in (ns, prev, ss)), jnp.asarray(x),
            jnp.asarray(t), jnp.asarray(n), 150000.0, 8320.0, 3.0, 0.15,
            msyms)
        jman = JM.manchester_scan(jm0, syms, times, valid, THR)
        jg = (st[0], st[2], st[1])
        jax_out = [np.asarray(a) for a in (syms, times, valid, count)]
        jman = (jman[0]._replace(**{f: np.asarray(v) for f, v in
                                    jman[0]._asdict().items()}),
                *(np.asarray(a) for a in jman[1:]))
        jg = [np.asarray(a) for a in jg]
    finally:
        jax.config.update("jax_enable_x64", False)
    g0 = PC.GardnerState(*(torch.from_numpy(a) for a in (ns, ss, prev)))
    out = PC.mm_manchester_scan(g0, pm0, torch.from_numpy(x),
                                torch.from_numpy(t), torch.from_numpy(n),
                                150000.0, 8320.0, 3.0, 0.15, THR, msyms)
    _check_outputs(jg, jman, *jax_out, out)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("algorithm", ["upsampling_gardner",
                                       "upsampling_mm"])
def test_upsampling_manchester_scan_matches_jax(algorithm, dtype):
    L, cap0 = 4, 1200
    step0 = float(np.float32(FS / 8320.0))         # interp 1
    x0, t0 = _images(cap0, step0, dtype, 2)
    step_u = step0 * L
    n = np.array([cap0 - 2, cap0 - 300, cap0 - 40], np.int32) * L
    # split pointers (int, frac): on time, and mid-bit inside the image,
    # before it and past it
    ns = np.array([[64.0, 0.0], [61.0, 0.37], [70.0, 0.5]], dtype)
    half = np.array([[64.0, 0.0], [-9.0, 0.86], [cap0 * L + 3.0, 0.25]],
                    dtype)
    prev = np.array([0.0, -0.6, 1.1], dtype)
    msyms = int(cap0 / step0 * 1.05) + 8
    _x64(dtype)
    try:
        xu = JR.upsample(jnp.asarray(x0), L, "cubic")
        tu = JR.uniform_times(jnp.asarray(t0), L, float(1.0 / FS) / L)
        jm0, pm0 = _man_states(dtype)
        if algorithm == "upsampling_gardner":
            st, syms, times, valid, count = JC.upsampling_gardner_scan(
                JC.GardnerState(jnp.asarray(ns), jnp.asarray(half),
                                jnp.asarray(prev)),
                xu, tu, jnp.asarray(n), step_u, 2.0, 1.0, msyms)
            jg = (st.next_sample, st.half_raw, st.prev_bit)
        else:
            st, syms, times, valid, count = JC.upsampling_mm_scan(
                (jnp.asarray(ns), jnp.asarray(prev)), xu, tu,
                jnp.asarray(n), step_u, 2.0, 1.0, msyms)
            jg = (st[0], half, st[1])
        jman = JM.manchester_scan(jm0, syms, times, valid, THR)
        jax_out = [np.asarray(a) for a in (syms, times, valid, count)]
        jman = (jman[0]._replace(**{f: np.asarray(v) for f, v in
                                    jman[0]._asdict().items()}),
                *(np.asarray(a) for a in jman[1:]))
        jg = [np.asarray(a) for a in jg]
        xu, tu = np.asarray(xu), np.asarray(tu)
    finally:
        jax.config.update("jax_enable_x64", False)
    g0 = PC.GardnerState(*(torch.from_numpy(a) for a in (ns, half, prev)))
    scan = (PC.upsampling_gardner_manchester_scan
            if algorithm == "upsampling_gardner"
            else PC.upsampling_mm_manchester_scan)
    out = scan(g0, pm0, torch.from_numpy(np.array(xu)),
               torch.from_numpy(np.array(tu)),
               torch.from_numpy(n), step_u, 2.0, 1.0, THR, msyms)
    _check_outputs(jg, jman, *jax_out, out)


def _parity(a, b, fs, shifted_share):
    """§4b: counts, payloads and polarity identical; timestamps within one
    sample period, shifted on at most `shifted_share` of the frames."""
    assert len(a) == len(b) >= 4
    shifted = 0
    for x, y in zip(a, b):
        assert x.inverted == y.inverted and x.complete == y.complete
        assert np.array_equal(x.data, y.data)
        if x.time != y.time:
            assert abs(x.time - y.time) <= 1.0001 / fs
            shifted += 1
    assert shifted <= shifted_share * len(a)
    return shifted


@pytest.fixture(scope="module")
def recording():
    iq, sent = synth.make_poes_recording(n_frames=8, fs=FS, snr_db=28.0)
    return iq, W.time_axis(len(iq), FS, np.float32), sent


@pytest.mark.parametrize("algorithm,quirks,share", [
    ("mm", False, 0.0), ("mm", True, 0.0), ("upsampling_mm", False, 0.0),
    ("upsampling_gardner", False, 0.5)])
def test_session_matches_jax(recording, algorithm, quirks, share):
    iq, t, sent = recording
    want = JaxSession(clock_cfg(JCFG, algorithm), FS, quirks=quirks).run(
        iq, t)
    got = PortSession(clock_cfg(TCFG, algorithm), FS, quirks=quirks,
                      device="cpu").run(iq, t)
    _parity(want.frames, got.frames, FS, share)
    sset = {bytes(f) for f in sent}
    assert sum(bytes(f.data) in sset for f in got.frames) >= 4
    assert got.total_samples == want.total_samples == len(iq)


def test_quirks_mode_rejects_upsampling():
    for algorithm in ("upsampling_gardner", "upsampling_mm"):
        with pytest.raises(ValueError):
            chain.make_params(clock_cfg(TCFG, algorithm), FS, quirks=True)


def test_unknown_clock_raises():
    cfg = clock_cfg(TCFG, "mm")
    cfg = dataclasses.replace(cfg, gardner=dataclasses.replace(
        cfg.gardner, algorithm="early_late"))
    params = chain.make_params(cfg, FS)
    with pytest.raises(ValueError, match="unknown clock"):
        chain.init_state(params, 1.0, 100, device="cpu")


def test_double_instances_need_the_card():
    """The _f64 wrappers launch their kernel or raise: no plain version
    stands in for them on CPU tensors (the float32 wrappers run it)."""
    from project_desert_tortoise_tpu_torch.ops.kernels import (
        scan_kernels as sk)
    x = torch.zeros((1, 64), dtype=torch.float64)
    n = torch.full((1,), 64, dtype=torch.int32)
    f = tuple(torch.zeros(1, dtype=torch.float64) for _ in range(8))
    i = tuple(torch.zeros(1, dtype=torch.int32) for _ in range(2))
    p = sk.upsampling_params(24.0, 2.0, 1.0, THR)
    for name in ("mm", "upsampling_gardner", "upsampling_mm"):
        with pytest.raises(ValueError, match="CUDA"):
            getattr(sk, f"{name}_manchester_scan_f64")(f, i, x, x, n, p, 4)
        assert getattr(sk, f"{name}_manchester_scan_f64").launches == 0

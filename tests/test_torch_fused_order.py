"""The decoupled kernels' order of evaluation, modelled in PyTorch on the
CPU, against the plain versions ``fused_demod_ref`` and ``pll_fir_agc_ref``
bit for bit (``torch.equal``).

``csrc/fused_demod.cu`` and ``csrc/chain_kernel.cu`` split each lane's
short recurrences from its feed-forward work and run them over chunks of
the lane's samples: A, the PLL phase recurrence (the whole PLL step only
while a lane is unlocked); B, the step's feed-forward terms from A's
phases; M, the two EMAs and the squelch after the PLL; C, the FIR over the
chunk with HIST-1 carried history values; D, the AGC and the squelch after
it; E, Gardner, the mid-bit latch and Manchester with indexed reads into
the chunk's AGC output and input times, RING_T-1 outputs and N_TG-1 times
carried over (the kernel runs Gardner's and Manchester's update only on
the samples where a symbol is due; on the others it leaves the state as
the select below does).  The model below
runs each stage over a whole chunk before the next, with those carries,
on all lanes at once; the kernels' schedule (which warp runs which stage
when) does not change any value.  It calls sin/cos on the same (B,) slices
as the plain version does (ATen's vectorised body and scalar tail may
differ by an ulp); every other operation is elementwise and exact on any
shape.

Chunks of K = 64 samples; L = 1, 63 and 1,000 (not multiples of K); warm
(locked) lanes, cold lanes (``pll.init_state``), cold lanes whose lock
signal sits just under its threshold (they lock within a chunk), and
batches that mix them.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu_torch import chain
from project_desert_tortoise_tpu_torch.ops import fastmath
from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    AGC_MAX_GAIN, AGC_MIN_GAIN, AGC_REFERENCE, agc_step, lane_const,
    pll_fir_agc_ref, poly_columns, polyphase)
from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
    fused_demod_ref, geometry)
from project_desert_tortoise_tpu_torch.utils.config import ARGOS, POES_TIP

torch.set_num_threads(1)
K = 64
MODES = {"poes": (POES_TIP, 50000.0, 3), "argos": (ARGOS, 32000.0, 40)}


def _input(B, L, seed, sps, int16=False):
    """BPSK at `sps` samples a symbol with noise, float32 or int16 PCM."""
    rng = np.random.default_rng(seed)
    sym = rng.choice([-1.0, 1.0], size=(B, L // sps + 2))
    base = np.repeat(sym, sps, axis=1)[:, :L]
    re = (base * 0.01 + 0.002 * rng.standard_normal((B, L))).astype(np.float32)
    im = (0.002 * rng.standard_normal((B, L))).astype(np.float32)
    if int16:
        re, im = (np.clip(np.round(a * 32768.0), -32768, 32767).astype(
            np.int16) for a in (re, im))
    return torch.from_numpy(re), torch.from_numpy(im)


def _state(params, B, lanes: str):
    """PLL lanes: "warm" (locked, as the main path's warm start), "cold"
    (pll.init_state), "near" (cold with the lock signal just under its
    threshold), or "mixed" (warm, cold and near in turn)."""
    cold = pll_ops.init_state(params.pll, (B,), device="cpu")
    near = cold._replace(locksig=torch.full(
        (B,), np.float32(params.pll.lock_threshold) - np.float32(1e-4)))
    warm = cold._replace(freq=torch.full((B,), 0.01),
                         locked=torch.ones(B, dtype=torch.bool))
    pick = {"warm": [warm], "cold": [cold], "near": [near],
            "mixed": [warm, cold, near]}[lanes]
    return pll_ops.PLLState(*(torch.stack([pick[b % len(pick)][f][b]
                                           for b in range(B)])
                              for f in range(len(cold))))


class _Front(NamedTuple):
    """The carried state of the front stages, one part per stage."""
    pll: pll_ops.PLLState     # A
    avg: torch.Tensor         # M
    locksig: torch.Tensor     # M
    hist: torch.Tensor        # C: the last HIST-1 soft rows, oldest first
    gain: torch.Tensor        # D


def _advance_locked(k, phase, freq, sample_phase):
    """A's step for a locked lane: the phase/freq update alone."""
    err = sample_phase - phase
    err = torch.where(err > k.pi, err - k.two_pi,
                      torch.where(err < k.neg_pi, err + k.two_pi, err))
    freq = freq + k.beta_track * err
    phase = phase + freq + k.alpha_track * err
    phase = torch.where(phase > k.two_pi, phase - k.two_pi, phase)
    phase = torch.where(phase < k.neg_two_pi, phase + k.two_pi, phase)
    freq = torch.minimum(torch.maximum(freq, k.neg_max_freq), k.max_freq)
    return phase, freq


def pll_chunk(k, pll, avg, locksig, xre, xim):
    """Stages A, B and M over one chunk (n, B) of input rows: returns A's
    new PLL state, M's two EMAs, the data arm and the lock rows (n, B)."""
    n = xre.shape[0]
    sp, zre_n, zim_n = pll_ops.input_terms(xre, xim)
    # A: the phase before each sample's update; the whole step while a
    # lane is unlocked (it stays locked once it locks)
    phases = []
    for i in range(n):
        phases.append(pll.phase)
        whole, _ = pll_ops.step_with_terms(k, pll, xre[i], xim[i], sp[i],
                                           zre_n[i], zim_n[i])
        phase, freq = _advance_locked(k, pll.phase, pll.freq, sp[i])
        fast = pll._replace(phase=phase, freq=freq)
        pll = pll_ops.PLLState(*(torch.where(pll.locked, f, w)
                                 for f, w in zip(fast, whole)))
    # B: the feed-forward terms from A's phases
    t_im = torch.stack([torch.sin(p) for p in phases])
    t_re = torch.stack([torch.cos(p) for p in phases])
    out = xim * t_re - xre * t_im
    pll_re = xre * t_re + xim * t_im
    avg_term = k.avg_alpha * torch.abs(fastmath.arctan2_approx(out, pll_re))
    lock_term = k.lock_alpha * (zre_n * t_re + zim_n * t_im)
    # M: the EMAs in sample order
    locks = []
    for i in range(n):
        avg = avg * k.one_minus_avg + avg_term[i]
        locksig = locksig * k.one_minus_lock + lock_term[i]
        locks.append(locksig)
    return pll, avg, locksig, out, torch.stack(locks)


def agc_chunk(agc, gain, rows, mute=None):
    """Stage D over a chunk's AGC inputs (m, B) in order (`agc`: the
    constants of agc_step after the gain, zero last), each output zero
    where `mute` (m, B) is set; returns the new gain and the outputs."""
    ys = []
    for j in range(rows.shape[0]):
        y, gain = agc_step(rows[j], gain, *agc)
        if mute is not None:
            y = torch.where(mute[j], agc[-1], y)
        ys.append(y)
    return gain, torch.stack(ys)


def _front_chunk(cp, k, s: _Front, xre, xim, squelch_after_agc: bool):
    """Stages A, B, M, C and D over one chunk (n, B) of input rows; returns
    the new carry, the AGC output (n * interp, B) and the lock rows."""
    n = xre.shape[0]
    zero = torch.zeros_like(s.gain)
    pll, avg, locksig, out, locks = pll_chunk(k, s.pll, s.avg, s.locksig,
                                              xre, xim)
    # M's squelch after the PLL
    squelch = lane_const(cp.squelch_threshold or 0.0, zero)
    soft = out
    if cp.squelch_position == "after_pll":
        soft = torch.where(torch.abs(locks) < squelch, zero, out)
    # C: every output of the chunk at once, history carried
    poly = polyphase(cp.taps, cp.interp)
    hist_len = len(poly[0]) - 1
    h = torch.cat([s.hist, soft])
    acc = torch.zeros((n, cp.interp) + zero.shape)
    for m, col in enumerate(poly_columns(poly, zero)):
        acc = acc + col * h[hist_len - m:hist_len - m + n, None]
    # D: the AGC over the chunk's outputs in order, the squelch after it
    c = lambda v: lane_const(v, zero)
    agc = (c(cp.agc_attack), c(cp.agc_decay), c(AGC_REFERENCE),
           c(AGC_MIN_GAIN), c(AGC_MAX_GAIN), zero)
    mute = None
    if squelch_after_agc:
        mute = (torch.abs(locks) < squelch).repeat_interleave(cp.interp, 0)
    gain, ys = agc_chunk(agc, s.gain, acc.reshape(n * cp.interp, -1), mute)
    carry = _Front(pll=pll, avg=avg, locksig=locksig,
                   hist=h[h.shape[0] - hist_len:], gain=gain)
    return carry, ys, locks


def _front_init(cp, pll_state, agc_gain):
    B = agc_gain.shape[0]
    hist = len(polyphase(cp.taps, cp.interp)[0]) - 1
    return _Front(pll=pll_state, avg=pll_state.avg_phase,
                  locksig=pll_state.locksig, hist=torch.zeros((hist, B)),
                  gain=agc_gain)


def _planes(z):
    """Time-major float32 rows, int16 PCM scaled by exactly 1/32768."""
    xre, xim = (x.t().contiguous() for x in z)
    if xre.dtype == torch.int16:
        xre = xre.to(torch.float32) * (1.0 / 32768.0)
        xim = xim.to(torch.float32) * (1.0 / 32768.0)
    return xre, xim


def pll_fir_agc_order(cp, pll_state, agc_gain, z):
    """pll_fir_agc_ref's results in the decoupled kernel's order."""
    xre, xim = _planes(z)
    k = pll_ops.loop_consts(cp.pll, agc_gain)
    s = _front_init(cp, pll_state, agc_gain)
    ys, locks = [], []
    for c0 in range(0, xre.shape[0], K):
        s, y, lock = _front_chunk(cp, k, s, xre[c0:c0 + K], xim[c0:c0 + K],
                                  False)
        ys.append(y)
        locks.append(lock)
    pll = s.pll._replace(locksig=s.locksig, avg_phase=s.avg)
    return pll, s.gain, torch.cat(ys).t(), torch.cat(locks).t()


def fused_demod_order(cp, pll_state, agc_gain, z, t_next, t_seed=None,
                      t_pad0=None, ts=0.0):
    """fused_demod_ref's results in the decoupled kernel's order."""
    g = geometry(cp)
    interp, ring_t, n_tg = g.interp, g.ring_t, g.n_tg
    xre, xim = _planes(z)
    L, B = xre.shape
    k = pll_ops.loop_consts(cp.pll, agc_gain)
    s = _front_init(cp, pll_state, agc_gain)
    f32 = torch.float32
    zero = torch.zeros(B)
    c = lambda v: lane_const(v, zero)
    gardner_gain, err_limit = c(cp.gardner_gain), c(cp.gardner_err_limit)
    neg_err_limit = c(-np.float32(cp.gardner_err_limit))
    step, resync = c(cp.step_size), c(cp.resync_threshold)
    half_step = c(np.float32(cp.step_size) / np.float32(2.0))
    tn = None if t_next is None else t_next.t().contiguous()
    t_cur, pcnt = (None, None) if t_seed is None else (t_seed, t_pad0)
    tstep, one = c(ts), torch.ones(B)
    # E's carry: Gardner and Manchester, the last outputs and input times
    hlatch = ns = half_raw = clockmod = evenodd = prev_sym = mprev = zero
    ycarry = torch.zeros((ring_t - 1, B))
    tcarry = torch.zeros((n_tg - 1, B))
    lanes = torch.arange(B)
    be, btime = [], []
    for c0 in range(0, L, K):
        s, y, _ = _front_chunk(cp, k, s, xre[c0:c0 + K], xim[c0:c0 + K],
                               cp.squelch_position == "after_agc")
        n = y.shape[0] // interp
        if tn is None:                        # time generation, the chunk's
            times = []
            for _ in range(n):
                times.append(torch.where(pcnt > 0, zero, t_cur))
                t_cur = torch.where(pcnt <= 0, t_cur + tstep, t_cur)
                pcnt = pcnt - one
            times = torch.stack(times)
        else:
            times = tn[c0:c0 + n]
        ybuf = torch.cat([ycarry, y])         # ring_t-1 carried rows first
        tbuf = torch.cat([tcarry, times])     # n_tg-1 carried rows first
        for i in range(n):
            j_base = (c0 + i) * interp
            j_hi = j_base + interp - 1
            row = ring_t - 1 + i * interp     # ybuf row of output j_base
            off = torch.round(half_raw).to(torch.int32) - j_base
            inside = (off >= 0) & (off < interp)
            hlatch = torch.where(
                inside, ybuf[row + off.clamp(0, interp - 1), lanes], hlatch)
            target = torch.round(ns)
            emit_sym = target <= j_hi
            tgt_i = torch.clamp(target.to(torch.int32), min=0)
            age = torch.clamp(j_hi - tgt_i, 0, ring_t - 1)
            cur = ybuf[row + interp - 1 - age, lanes]
            sym_t = tbuf[n_tg - 1 + i - age // interp, lanes]
            err = torch.clamp(gardner_gain * (cur - prev_sym) * hlatch,
                              neg_err_limit, err_limit)
            ns_adj = ns - err
            ns = torch.where(emit_sym, ns_adj + step, ns)
            half_raw = torch.where(emit_sym, ns_adj + half_step, half_raw)
            hlatch = torch.where(emit_sym, zero, hlatch)
            prevprev, prev = mprev, prev_sym
            strong = (torch.abs(prevprev) > resync) & (torch.abs(prev) > resync)
            resyncd = (evenodd != clockmod) & strong & (
                fastmath.sign(prevprev) == fastmath.sign(prev))
            clockmod_n = torch.where(resyncd, evenodd, clockmod)
            bit = torch.where(torch.abs(prev) > torch.abs(cur),
                              (prev > 0).to(f32), 1.0 - (cur > 0).to(f32))
            emit_bit = emit_sym & (evenodd == clockmod_n)
            be.append(bit + 2.0 * emit_bit.to(f32))
            btime.append(sym_t)
            clockmod = torch.where(emit_sym, clockmod_n, clockmod)
            evenodd = torch.where(emit_sym, torch.remainder(evenodd + 1.0,
                                                            2.0), evenodd)
            prev_sym = torch.where(emit_sym, cur, prev_sym)
            mprev = torch.where(emit_sym, prev, mprev)
        ycarry = ybuf[ybuf.shape[0] - (ring_t - 1):]
        tcarry = tbuf[tbuf.shape[0] - (n_tg - 1):]
    be = torch.stack(be, 1)
    emit = be > 1.5
    return be - 2.0 * emit.to(f32), torch.stack(btime, 1), emit, s.avg


def _params(mode, squelch="mode"):
    cfg, fs, sps = MODES[mode]
    params = chain.make_params(cfg, fs)
    if squelch != "mode":
        params = params._replace(squelch_threshold=0.05 if squelch else None,
                                 squelch_position=squelch)
    return params, fs, sps


def _times(fs, B, L, tgen: bool):
    """A staged time plane, or time generation's seeds (lane 0 with a
    padded head of 40 samples) and step."""
    ts = float(np.float32(1.0) / np.float32(fs))
    if not tgen:
        plane = np.tile(np.arange(1, L + 1, dtype=np.float32) / fs, (B, 1))
        return (torch.from_numpy(plane),)
    pad0 = torch.zeros(B)
    pad0[0] = 40.0
    return None, torch.arange(B, dtype=torch.float32) * 0.25 + ts, pad0, ts


def _equal(got, want):
    for a, b in zip(got, want):
        if isinstance(a, tuple):
            _equal(a, b)
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("L", [1, 63, 1000])
@pytest.mark.parametrize("lanes", ["warm", "cold", "mixed"])
@pytest.mark.parametrize("mode", ["poes", "argos"])
def test_fused_order_matches_plain(mode, lanes, L):
    """The mode's own squelch; POES on time generation, ARGOS on a staged
    time plane (the other sources in the next test)."""
    params, fs, sps = _params(mode)
    B = 5
    z = _input(B, L, L + B, sps)
    st = _state(params, B, lanes)
    gain = torch.full((B,), 17.58)
    args = (params, st, gain, z, *_times(fs, B, L, mode == "poes"))
    _equal(fused_demod_order(*args), fused_demod_ref(*args))


@pytest.mark.parametrize("tgen", [False, True])
@pytest.mark.parametrize("squelch", [None, "after_pll", "after_agc"])
@pytest.mark.parametrize("mode", ["poes", "argos"])
def test_fused_order_variants(mode, squelch, tgen):
    """Every squelch position and time source, int16 PCM input, mixed
    lanes, L = 200 (three chunks and a part)."""
    params, fs, sps = _params(mode, squelch)
    B, L = 3, 200
    z = _input(B, L, 7, sps, int16=True)
    st = _state(params, B, "mixed")
    gain = torch.full((B,), 17.58)
    args = (params, st, gain, z, *_times(fs, B, L, tgen))
    _equal(fused_demod_order(*args), fused_demod_ref(*args))


def test_near_lanes_lock_inside_a_chunk():
    """The "near" lanes of the tests above do lock, and not at a chunk's
    edge, so the unlocked-to-locked switch of stage A is exercised."""
    for mode in MODES:
        params, fs, sps = _params(mode)
        B, L = 4, 1000
        st = _state(params, B, "near")
        _, _, _, lock = pll_fir_agc_ref(params, st, torch.full((B,), 17.58),
                                        _input(B, L, L + B, sps))
        first = (lock > np.float32(params.pll.lock_threshold)).int().argmax(1)
        assert bool((lock > params.pll.lock_threshold).any(1).all())
        assert bool((first % K != K - 1).all()), (mode, first)


@pytest.mark.parametrize("L", [63, 1000])
@pytest.mark.parametrize("squelch", [None, "after_pll"])
@pytest.mark.parametrize("lanes", ["warm", "mixed"])
@pytest.mark.parametrize("mode", ["poes", "argos"])
def test_chain_order_matches_plain(mode, lanes, squelch, L):
    params, fs, sps = _params(mode, squelch)
    B = 5
    z = _input(B, L, L + 2 * B, sps)
    st = _state(params, B, lanes)
    gain = torch.full((B,), 17.58)
    _equal(pll_fir_agc_order(params, st, gain, z),
           pll_fir_agc_ref(params, st, gain, z))

"""Fused demodulation chain: PLL -> polyphase FIR -> AGC -> Gardner ->
Manchester in one pass per block lane.

Counterpart of ``project_desert_tortoise_tpu/ops/pallas/fused_kernel.py``
(``fused_demod_pallas``).  Per lane and per input sample it runs the Costas
PLL, the 1:interp polyphase FIR, the AGC on each of the `interp` outputs,
Gardner timing with a shallow on-time ring, a time ring grouped per interp
and a one-plane mid-bit capture latch, and the Manchester decision.  At most
one bit is emitted per input sample, so outputs are dense (B, L) planes with
an emit mask.  The bit times come from a staged (B, L) time plane or, with
``t_next=None``, from in-kernel time generation: per-block seeds, counts of
zero-padded head samples and a step ``ts``, as the JAX kernel's
(``fused_kernel.py:152-162``).

- :func:`fused_demod` is the entry point.  A CUDA tensor launches the
  hand-written decoupled kernel of ``csrc/fused_demod.cu`` (built at first
  use by ``ops/kernels/build.py``) or raises; a CPU tensor runs
  :func:`fused_demod_ref`.  ``fused_demod.launches`` counts kernel launches.
- :func:`fused_demod_serial` launches the serial kernel of the same file,
  every stage of a sample in turn: the card-side oracle and timing
  baseline of the decoupled kernel, on no path.
- :func:`fused_demod_ref` is the plain PyTorch version, on any device: a
  loop over the samples of :func:`_step`, the twin of the JAX kernel's body,
  on all lanes at once.  Every value is the same sequence of float32
  operations as in the CUDA kernel, so on the card the two agree bit for
  bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from project_desert_tortoise_tpu_torch.ops import fastmath
from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
# the AGC constants are those of JAX fused_kernel.py:362-363, the same as
# the front-half chain's
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    AGC_MAX_GAIN, AGC_MIN_GAIN, AGC_REFERENCE, MAX_HIST, MAX_INTERP,
    fir_agc, lane_const, poly_columns, polyphase)
from project_desert_tortoise_tpu_torch.ops.kernels.common import (
    check, kernel_config, launch, on_card, state_rows)
from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
    pll_param_block)

# geometries csrc/fused_demod.cu instantiates: (interp, hist, ring_t, n_tg)
KERNEL_GEOMETRIES = {(3, 26, 6, 2),      # POES at 50 kHz
                     (1, 50, 4, 4)}      # ARGOS at 32 kHz
_SQUELCH_CODE = {None: 0, "after_pll": 1, "after_agc": 2}


def check_time_source(t_next, t_seed, t_pad0, ts: float):
    """Raise ``ValueError`` unless the bit times have a source: a staged
    time plane, or (``t_next=None``) seeds, padded-head counts and a step
    ``ts > 0`` for in-kernel time generation."""
    if t_next is None and (t_seed is None or t_pad0 is None or not ts > 0.0):
        raise ValueError(
            "t_next=None (in-kernel time generation) needs t_seed (B,), "
            f"t_pad0 (B,) and a step ts > 0 (got ts={ts})")


def ring_size(step_size: float, err_limit: float, interp: int) -> int:
    """Mid-bit history depth of the JAX windowed path; bounds the time
    ring below (JAX fused_kernel.py:48-60)."""
    need = int(np.ceil(step_size / 2.0 + err_limit)) + interp + 2
    return max(16, -(-need // 2) * 2)


def ring_t_size(step_size: float, err_limit: float, interp: int) -> int:
    """On-time ring depth: the on-time read's age is at most ``interp - 1``
    plus the clamped timing error (JAX fused_kernel.py:63-79)."""
    need = interp + int(np.ceil(err_limit)) + 2
    return min(max(4, -(-need // 2) * 2),
               ring_size(step_size, err_limit, interp))


class Geometry(NamedTuple):
    interp: int
    poly: list          # [interp][hist] taps
    hist: int           # FIR history planes
    ring_t: int         # on-time value ring depth
    n_tg: int           # time-ring group planes


def geometry(chain_params) -> Geometry:
    """Static geometry of the fused chain; raises ``ValueError`` where the
    mid-bit capture latch is unsound (JAX fused_kernel.py:338-355)."""
    interp = chain_params.interp
    margin = (chain_params.step_size / 2.0
              - chain_params.gardner_err_limit - interp)
    if margin <= 0:
        raise ValueError(
            "fused kernel capture-latch invariant violated: "
            f"step_size/2 - err_limit - interp = {margin:.3f} <= 0 "
            f"(step_size={chain_params.step_size}, interp={interp}); this "
            "geometry's mid-bit target can be produced before its emission "
            "is consumed — use the XLA path (use_pallas=False)")
    poly = polyphase(chain_params.taps, interp)
    ring_t = ring_t_size(chain_params.step_size,
                         chain_params.gardner_err_limit, interp)
    return Geometry(interp=interp, poly=poly, hist=len(poly[0]),
                    ring_t=ring_t, n_tg=-(-ring_t // interp))


class _Consts(NamedTuple):
    """The chain's float32 constants as (B,) lane tensors (tensor-tensor
    ops dispatch fastest), each rounded as the JAX kernel's ``c(v)``."""
    pll: pll_ops.LoopConsts
    poly: list              # poly[m]: (interp, 1) taps of history plane m
    zero: torch.Tensor
    squelch: torch.Tensor
    attack: torch.Tensor
    decay: torch.Tensor
    reference: torch.Tensor
    min_gain: torch.Tensor
    max_gain: torch.Tensor
    gardner_gain: torch.Tensor
    err_limit: torch.Tensor
    neg_err_limit: torch.Tensor
    step: torch.Tensor
    half_step: torch.Tensor
    resync: torch.Tensor


def _consts(cp, g: Geometry, like: torch.Tensor) -> _Consts:
    full = lambda v: lane_const(v, like)
    return _Consts(
        pll=pll_ops.loop_consts(cp.pll, like),
        poly=poly_columns(g.poly, like),
        zero=full(0.0),
        squelch=full(cp.squelch_threshold or 0.0),
        attack=full(cp.agc_attack), decay=full(cp.agc_decay),
        reference=full(AGC_REFERENCE), min_gain=full(AGC_MIN_GAIN),
        max_gain=full(AGC_MAX_GAIN), gardner_gain=full(cp.gardner_gain),
        err_limit=full(cp.gardner_err_limit),
        neg_err_limit=full(-np.float32(cp.gardner_err_limit)),
        step=full(cp.step_size),
        half_step=full(np.float32(cp.step_size) / np.float32(2.0)),
        resync=full(cp.resync_threshold))


class _Carry(NamedTuple):
    """The kernel's carried state planes (JAX fused_kernel.py:104-115).
    The JAX kernel also carries ``mprevprev``, which it writes and never
    reads; it is left out here."""
    pll: pll_ops.PLLState
    hist: list               # hist[m]: PLL output m samples back, 0 = newest
    gain: torch.Tensor       # AGC gain
    ring: list               # ring[k]: interp output of age k, 0 = newest
    hlatch: torch.Tensor     # mid-bit capture latch
    tgroups: list            # tgroups[k]: time of the input sample k back
    ns: torch.Tensor         # Gardner next on-time index
    half_raw: torch.Tensor   # Gardner next mid-bit index
    clockmod: torch.Tensor   # Manchester clock phase
    evenodd: torch.Tensor
    prev_sym: torch.Tensor   # Gardner prev_bit == Manchester current symbol
    mprev: torch.Tensor      # Manchester previous symbol


def ring_read(ring, age, zero):
    """Unrolled compare-select over the shift-register ring (age 0 =
    newest), JAX fused_kernel.py:82-88."""
    acc = zero
    for k in range(len(ring)):
        acc = torch.where(age == k, ring[k], acc)
    return acc


def _step(cp, g: Geometry, c: _Consts, s: _Carry, x, tval_in, i: int):
    """One input sample on every lane: the body of the JAX kernel
    (fused_kernel.py:129-263) in its order.  x: the sample and its
    :func:`pll_ops.input_terms`.  Returns the new carry, the merged
    ``bit + 2*emit`` value and the bit time."""
    f32 = torch.float32
    interp = g.interp
    pll, (soft, lock) = pll_ops.step_with_terms(c.pll, s.pll, *x)
    if cp.squelch_position == "after_pll":
        # |lock|: block relock may settle at the inverted BPSK point
        soft = torch.where(torch.abs(lock) < c.squelch, c.zero, soft)

    # polyphase FIR and AGC on the interp outputs of this sample
    hist = [soft] + s.hist[:-1]
    produced, gain = fir_agc(c.poly, hist, s.gain, c.attack, c.decay,
                             c.reference, c.min_gain, c.max_gain, c.zero)
    if cp.squelch_position == "after_agc":
        produced = [torch.where(torch.abs(lock) < c.squelch, c.zero, y)
                    for y in produced]
    ring = produced[::-1] + s.ring[:g.ring_t - interp]
    tgroups = [tval_in] + s.tgroups[:-1]

    # --- Gardner: emit at most one symbol this input sample ---
    j_base = i * interp
    j_hi = j_base + interp - 1
    # mid-bit capture latch: grab the value at round(half_raw) the step it
    # is produced
    off = torch.round(s.half_raw).to(torch.int32) - j_base
    capv = c.zero
    for p in range(interp):
        capv = torch.where(off == p, produced[p], capv)
    hlatch = torch.where((off >= 0) & (off < interp), capv, s.hlatch)

    target = torch.round(s.ns)
    emit_sym = target <= j_hi
    tgt_i = torch.clamp(target.to(torch.int32), min=0)
    age = torch.clamp(j_hi - tgt_i, 0, g.ring_t - 1)
    cur = ring_read(ring, age, c.zero)
    # the time ring holds one entry per input sample: group age // interp
    sym_t = tgroups[-1]
    for k in reversed(range(g.n_tg - 1)):
        sym_t = torch.where(age < (k + 1) * interp, tgroups[k], sym_t)

    err = torch.clamp(c.gardner_gain * (cur - s.prev_sym) * hlatch,
                      c.neg_err_limit, c.err_limit)
    ns_adj = s.ns - err
    half_new = ns_adj + c.half_step
    ns_new = ns_adj + c.step
    ns = torch.where(emit_sym, ns_new, s.ns)
    half_raw = torch.where(emit_sym, half_new, s.half_raw)
    # a consumed mid-bit resets the latch for the new (future) target
    hlatch = torch.where(emit_sym, c.zero, hlatch)

    # --- Manchester on the emitted symbol ---
    prevprev, prev = s.mprev, s.prev_sym
    mismatch = s.evenodd != s.clockmod
    strong = (torch.abs(prevprev) > c.resync) & (torch.abs(prev) > c.resync)
    resync = mismatch & (fastmath.sign(prevprev) == fastmath.sign(prev)) \
        & strong
    clockmod_n = torch.where(resync, s.evenodd, s.clockmod)
    boundary = s.evenodd == clockmod_n
    use_prev = torch.abs(prev) > torch.abs(cur)
    bit = torch.where(use_prev, (prev > 0).to(f32), 1.0 - (cur > 0).to(f32))
    emit_bit = emit_sym & boundary
    be = bit + 2.0 * emit_bit.to(f32)     # 2 + bit on emission

    carry = _Carry(
        pll=pll, hist=hist, gain=gain, ring=ring, hlatch=hlatch,
        tgroups=tgroups, ns=ns, half_raw=half_raw,
        clockmod=torch.where(emit_sym, clockmod_n, s.clockmod),
        evenodd=torch.where(emit_sym, torch.remainder(s.evenodd + 1.0, 2.0),
                            s.evenodd),
        prev_sym=torch.where(emit_sym, cur, s.prev_sym),
        mprev=torch.where(emit_sym, prev, s.mprev))
    return carry, be, sym_t


def _generated_times(t_seed, t_pad0, ts: float, L: int):
    """The time values of in-kernel time generation, one (B,) row per step
    (JAX fused_kernel.py:156-162): 0 while the padded-head countdown is
    above 0, then the seed, then the sequential float32 fold t + ts."""
    f32 = torch.float32
    t_cur, pcnt = t_seed.to(f32), t_pad0.to(f32)
    zero = torch.zeros_like(t_cur)
    step = torch.full_like(t_cur, float(np.float32(ts)))
    one = torch.ones_like(t_cur)
    for _ in range(L):
        yield torch.where(pcnt > zero, zero, t_cur)
        t_cur = torch.where(pcnt <= zero, t_cur + step, t_cur)
        pcnt = pcnt - one


def fused_demod_ref(chain_params, pll_state, agc_gain, z, t_next,
                    t_seed=None, t_pad0=None, ts: float = 0.0):
    """Plain PyTorch version of :func:`fused_demod`, on any device: a loop
    of :func:`_step` over the samples, all lanes at once."""
    g = geometry(chain_params)
    check_time_source(t_next, t_seed, t_pad0, ts)
    f32 = torch.float32
    # initial state (JAX fused_kernel.py:368-377): PLL planes, AGC gain,
    # every other plane 0
    zero = torch.zeros(z[0].shape[:1], dtype=f32, device=z[0].device)
    s = _Carry(
        pll=pll_ops.PLLState(*(x.to(f32) for x in pll_state[:5]),
                             locked=pll_state.locked.to(torch.bool)),
        hist=[zero] * g.hist, gain=agc_gain.to(f32), ring=[zero] * g.ring_t,
        hlatch=zero, tgroups=[zero] * g.n_tg, ns=zero, half_raw=zero,
        clockmod=zero, evenodd=zero, prev_sym=zero, mprev=zero)
    c = _consts(chain_params, g, zero)
    # time-major (L, B): each sample's lanes are one contiguous row
    xre, xim = (x.t().contiguous() for x in z)
    if xre.dtype == torch.int16:      # PCM planes: exact /32768 (wave.c:117)
        xre = xre.to(f32) * (1.0 / 32768.0)
        xim = xim.to(f32) * (1.0 / 32768.0)
    # the step's terms that depend on the input sample alone are computed
    # elementwise over the block: the same float32 operations in far fewer
    # op dispatches, which bound this loop
    cols = zip(*(x.unbind(0) for x in
                 (xre, xim, *pll_ops.input_terms(xre, xim))))
    times = (_generated_times(t_seed, t_pad0, ts, xre.shape[0])
             if t_next is None else t_next.to(f32).t().contiguous())
    be, btime = [], []
    for i, (x, tn) in enumerate(zip(cols, times)):
        s, be_i, t_i = _step(chain_params, g, c, s, x, tn, i)
        be.append(be_i)
        btime.append(t_i)
    be = torch.stack(be, 1)
    emit = be > 1.5                   # merged plane: 2 + bit on emission
    bits = be - 2.0 * emit.to(f32)
    return bits, torch.stack(btime, 1), emit, s.pll.avg_phase


def _param_block(cp, g: Geometry, ts: float) -> np.ndarray:
    """The float block of FusedParams in csrc/fused_demod.cu, in its
    order; `ts` is the time-generation step (unused with a time plane)."""
    poly = np.zeros((MAX_INTERP, MAX_HIST), np.float32)
    poly[:g.interp, :g.hist] = g.poly
    return np.concatenate([
        pll_param_block(cp.pll),
        np.array([cp.agc_attack, cp.agc_decay, cp.squelch_threshold or 0.0,
                  cp.step_size, cp.gardner_gain, cp.gardner_err_limit,
                  cp.resync_threshold, ts], np.float32),
        poly.ravel()])


def _kernel_args(chain_params, pll_state, agc_gain, z, t_next, t_seed,
                 t_pad0, ts: float, name: str):
    """Check a kernel launch's arguments; returns (geometry key, the
    checked (B, L) planes, time generation on?, state rows, param
    block)."""
    g = geometry(chain_params)
    key = (g.interp, g.hist, g.ring_t, g.n_tg)
    if key not in KERNEL_GEOMETRIES:
        raise NotImplementedError(
            f"CUDA {name} has no instantiation for geometry "
            f"(interp, hist, ring_t, n_tg) = {key}; "
            f"available: {sorted(KERNEL_GEOMETRIES)}")
    zre, zim = z
    dev = zre.device
    B, L = zre.shape
    check("zre", zre, (B, L), (torch.float32, torch.int16), dev)
    check("zim", zim, (B, L), (zre.dtype,), dev)
    tgen = t_next is None
    if tgen:
        check("t_seed", t_seed, (B,), (torch.float32,), dev)
        check("t_pad0", t_pad0, (B,), (torch.float32,), dev)
    else:
        check("t_next", t_next, (B, L), (torch.float32,), dev)
    for name_, s in zip(pll_ops.PLLState._fields, pll_state):
        check(name_, s, (B,), (torch.bool if name_ == "locked"
                                else torch.float32,), dev)
    check("agc_gain", agc_gain, (B,), (torch.float32,), dev)
    st_in = state_rows(pll_state, agc_gain,
                       *((t_seed, t_pad0) if tgen else ()))
    params = _param_block(chain_params, g, ts if tgen else 0.0)
    return key, (zre, zim, t_next), tgen, st_in, params


def _outputs(be, btime, avg_phase):
    """(bits, bit_times, emit, avg_phase) from the merged plane."""
    emit = be > 1.5                   # merged plane: 2 + bit on emission
    bits = be - 2.0 * emit.to(torch.float32)
    return bits, btime, emit, avg_phase


def fused_demod(chain_params, pll_state, agc_gain, z, t_next, t_seed=None,
                t_pad0=None, ts: float = 0.0, *, unlocked=None):
    """Full chain on (B, L) block lanes.

    z: (zre, zim) float32 or int16 PCM planes (scaled by exactly 1/32768);
    t_next: (B, L) float32 stage time axis, or None for in-kernel time
    generation from ``t_seed`` (B,), the time of each block's first valid
    sample, ``t_pad0`` (B,), its count of zero-padded head samples, and
    the step ``ts`` (JAX ``fused_demod_pallas``); pll_state: (B,) lanes;
    agc_gain: (B,).  Returns (bits (B, L) float 0/1, bit_times (B, L),
    emit (B, L) bool, avg_phase (B,)).

    CPU tensors run :func:`fused_demod_ref`.  CUDA tensors launch the
    decoupled kernel of ``csrc/fused_demod.cu``; a geometry it does not
    instantiate raises ``NotImplementedError``,
    ``t_next=None`` without seeds ``ValueError``.  ``unlocked``, a (B,)
    int32 tensor on the card, receives the steps each lane ran before its
    PLL locked.
    """
    geometry(chain_params)
    check_time_source(t_next, t_seed, t_pad0, ts)
    if not on_card("fused_demod", z[0].device):
        return fused_demod_ref(chain_params, pll_state, agc_gain, z, t_next,
                               t_seed, t_pad0, ts)
    key, (zre, zim, tn), tgen, st_in, params = _kernel_args(
        chain_params, pll_state, agc_gain, z, t_next, t_seed, t_pad0, ts,
        "fused_demod")
    dev = zre.device
    B, L = zre.shape
    if unlocked is not None:
        check("unlocked", unlocked, (B,), (torch.int32,), dev)
    # lane-major (B, L) planes: a CTA's chunk of a lane is contiguous
    zre, zim = zre.contiguous(), zim.contiguous()
    tn = None if tgen else tn.contiguous()
    be = torch.empty((B, L), dtype=torch.float32, device=dev)
    btime = torch.empty((B, L), dtype=torch.float32, device=dev)
    avg_phase = torch.empty((B,), dtype=torch.float32, device=dev)
    launch(dev, "pdt_fused_demod", zre.data_ptr(), zim.data_ptr(),
           None if tgen else tn.data_ptr(), st_in.data_ptr(),
           be.data_ptr(), btime.data_ptr(), avg_phase.data_ptr(),
           None if unlocked is None else unlocked.data_ptr(), B, L,
           int(zre.dtype == torch.int16),
           _SQUELCH_CODE[chain_params.squelch_position], int(tgen), *key,
           params.ctypes.data_as(ctypes.c_void_p), params.size)
    fused_demod.launches += 1
    return _outputs(be, btime, avg_phase)


fused_demod.launches = 0


def fused_demod_serial(chain_params, pll_state, agc_gain, z, t_next,
                       t_seed=None, t_pad0=None, ts: float = 0.0):
    """:func:`fused_demod` on the serial kernel, which runs every stage of a
    sample in turn, one thread a lane, on time-major planes.  No path
    calls it: the card checks and ``chip_smoke.py`` hold the decoupled
    kernel to it over whole passes and time the two in one run.  CUDA
    tensors only."""
    check_time_source(t_next, t_seed, t_pad0, ts)
    if not on_card("fused_demod_serial", z[0].device):
        raise ValueError("fused_demod_serial runs on a CUDA device only")
    key, (zre, zim, tn), tgen, st_in, params = _kernel_args(
        chain_params, pll_state, agc_gain, z, t_next, t_seed, t_pad0, ts,
        "fused_demod_serial")
    dev = zre.device
    B, L = zre.shape
    # time-major (L, B) planes: a warp reads 32 neighbouring lanes per step
    xre = zre.t().contiguous()
    xim = zim.t().contiguous()
    tn = None if tgen else tn.t().contiguous()
    be = torch.empty((L, B), dtype=torch.float32, device=dev)
    btime = torch.empty((L, B), dtype=torch.float32, device=dev)
    avg_phase = torch.empty((B,), dtype=torch.float32, device=dev)
    launch(dev, "pdt_fused_demod_serial", xre.data_ptr(), xim.data_ptr(),
           None if tgen else tn.data_ptr(), st_in.data_ptr(),
           be.data_ptr(), btime.data_ptr(), avg_phase.data_ptr(), B, L,
           int(zre.dtype == torch.int16),
           _SQUELCH_CODE[chain_params.squelch_position], int(tgen), *key,
           params.ctypes.data_as(ctypes.c_void_p), params.size)
    fused_demod_serial.launches += 1
    return _outputs(be.t(), btime.t(), avg_phase)


fused_demod_serial.launches = 0


def launch_config(chain_params, dtype=torch.float32, tgen: bool = True,
                  device="cuda") -> dict:
    """The decoupled kernel's launch configuration for this chain: lanes
    per CTA, chunk samples, threads and dynamic shared memory bytes a CTA,
    registers and local (spill) bytes a thread, as the card reports
    them."""
    g = geometry(chain_params)
    return kernel_config(device, "pdt_fused_demod_config", g.interp, g.hist,
                         g.ring_t, g.n_tg, int(dtype == torch.int16),
                         _SQUELCH_CODE[chain_params.squelch_position],
                         int(tgen))

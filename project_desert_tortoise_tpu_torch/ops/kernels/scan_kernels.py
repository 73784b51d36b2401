"""The per-lane recurrences of the scan branch and the exact chain: the AGC,
and symbol timing (Gardner, and the exact chain's other clocks) with the
Manchester decision.

Counterparts of the JAX package's XLA scans ``ops/agc.py::agc_scan``
(``agc.py:65-98``), ``ops/clock.py::gardner_manchester_windowed``
(``clock.py:151-263``) and ``ops/clock.py::gardner_scan`` followed by
``ops/manchester.py::manchester_scan`` (``clock.py:58-108``,
``manchester.py:34-74``); as per-sample torch loops they would take minutes
per launch at the main path's size, so each is a hand-written kernel in
``csrc/scan_kernels.cu``.

- :func:`agc_scan`, :func:`gardner_manchester` and
  :func:`gardner_manchester_scan` are the entry points.  A CUDA tensor
  launches the kernel or raises; a CPU tensor runs the plain version.
  ``.launches`` on each counts kernel launches.  The AGC kernel is stage D
  of ``csrc/front_stages.cuh`` alone, one lane a CTA; the windowed Gardner
  kernel runs one lane a CTA too, each window staged in shared memory, and
  reads and writes lane-major rows in place; the whole-image Gardner
  kernel of the exact chain (and of the block path's unwindowed
  fallback) runs one lane a CTA too, the image staged in a ring of
  shared-memory tiles, one thread on the slot chain's timing, one on the
  Manchester decision over its records and three warps storing them.
- :func:`agc_scan_serial`, :func:`gardner_manchester_serial` and
  :func:`gardner_manchester_scan_serial` launch the serial kernels, one
  thread a lane (over time-major copies for the first two, over the image
  in device memory for the third): the card-side oracles and timing
  baselines of the three, on no path.
- :func:`agc_scan_f64` launches the serial AGC kernel instantiated in
  double, :func:`gardner_manchester_scan_f64` the whole-image kernel in
  double: the float64 ``argos`` mode's exact chain (JAX runs its scans
  under x64 there).  :func:`agc_scan` and :func:`gardner_manchester_scan`
  launch them for float64 tensors.
  :func:`gardner_manchester_scan_f64_serial` launches the serial
  whole-image kernel in double, the card-side oracle and timing baseline
  of :func:`gardner_manchester_scan_f64`, on no path.
- :func:`agc_scan_ref`, :func:`gardner_manchester_ref` and
  :func:`gardner_manchester_scan_ref` are the plain PyTorch versions, on
  any device: loops over the steps, all lanes at once, in the JAX scans'
  order of operations in the stream's dtype (float32; float64 for the
  first and the third), so on the card they agree with the kernels bit for
  bit.
- :func:`mm_manchester_scan`, :func:`upsampling_gardner_manchester_scan`
  and :func:`upsampling_mm_manchester_scan` are the exact chain's other
  clocks (JAX ``clock.py::mm_scan``, ``upsampling_gardner_scan``,
  ``upsampling_mm_scan``, each followed by ``manchester_scan``), float32,
  and float64 through their ``_f64`` instances; ``*_ref`` are their plain
  versions.  Each runs the whole-image kernel of
  :func:`gardner_manchester_scan` under its clock
  (:func:`clock_scan_launch_config`); their ``*_serial`` twins (and
  ``*_f64_serial``) launch the simple design, one thread a lane over the
  image in device memory, on no path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from project_desert_tortoise_tpu_torch.ops import fastmath
from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    AGC_MAX_GAIN, AGC_MIN_GAIN, AGC_REFERENCE, agc_step, lane_const)
from project_desert_tortoise_tpu_torch.ops.kernels.common import (
    check, kernel_config, launch, on_card)


class AGCParams(NamedTuple):
    attack: float
    decay: float
    reference: float = AGC_REFERENCE
    max_gain: float = AGC_MAX_GAIN
    min_gain: float = AGC_MIN_GAIN


def agc_scan_ref(gain, x, p: AGCParams):
    """Plain PyTorch version of :func:`agc_scan`, in the dtype of `x`
    (float32 or float64)."""
    gain = gain.to(pll_ops.stream_dtype(x))
    c = lambda v: lane_const(v, gain)
    attack, decay, reference = c(p.attack), c(p.decay), c(p.reference)
    max_gain, min_gain, zero = c(p.max_gain), c(p.min_gain), c(0.0)
    ys = []
    for xi in x.t().contiguous().unbind(0):
        y, gain = agc_step(xi, gain, attack, decay, reference, min_gain,
                           max_gain, zero)
        ys.append(y)
    return gain, torch.stack(ys, 1)


def _agc_args(gain, x, dtype=torch.float32):
    """Check a launch's arguments."""
    dev = x.device
    B, n = x.shape
    check("x", x, (B, n), (dtype,), dev)
    check("gain", gain, (B,), (dtype,), dev)


def agc_scan(gain, x, p: AGCParams):
    """Attack/decay AGC over the last axis of (B, n) float32 `x` from
    (B,) gains.  Returns (gain (B,), y (B, n)).  Float64 tensors on the
    card launch :func:`agc_scan_f64`; CPU tensors run
    :func:`agc_scan_ref`."""
    dev = x.device
    if not on_card("agc_scan", dev):
        return agc_scan_ref(gain, x, p)
    if x.dtype == torch.float64:
        return agc_scan_f64(gain, x, p)
    _agc_args(gain, x)
    B, n = x.shape
    x = x.contiguous()                # lane-major: a chunk is contiguous
    y = torch.empty_like(x)
    g_in = gain.contiguous()
    g_out = torch.empty_like(g_in)
    params = np.array(p, np.float32)
    launch(dev, "pdt_agc_scan", x.data_ptr(), g_in.data_ptr(), y.data_ptr(),
           g_out.data_ptr(), B, n, params.ctypes.data_as(ctypes.c_void_p),
           params.size)
    agc_scan.launches += 1
    return g_out, y


agc_scan.launches = 0


def _launch_agc_serial(entry: str, gain, x, p: AGCParams, dtype):
    """Launch the serial AGC kernel `entry` in `dtype` (float32 or
    float64) on a time-major copy of `x`; returns (gain, y)."""
    _agc_args(gain, x, dtype)
    B, n = x.shape
    xt = x.t().contiguous()           # time-major: coalesced warp access
    y = torch.empty_like(xt)
    g_in = gain.contiguous()
    g_out = torch.empty_like(g_in)
    params = np.array(p, np.float64 if dtype == torch.float64
                      else np.float32)
    launch(x.device, entry, xt.data_ptr(), g_in.data_ptr(), y.data_ptr(),
           g_out.data_ptr(), B, n, params.ctypes.data_as(ctypes.c_void_p),
           params.size)
    return g_out, y.t()


def agc_scan_serial(gain, x, p: AGCParams):
    """:func:`agc_scan` on the serial kernel, one thread a lane over
    time-major planes.  No path calls it: the card checks and
    ``chip_smoke.py`` hold :func:`agc_scan` to it over whole passes and
    time the two in one run.  CUDA tensors only."""
    if not on_card("agc_scan_serial", x.device):
        raise ValueError("agc_scan_serial runs on a CUDA device only")
    out = _launch_agc_serial("pdt_agc_scan_serial", gain, x, p,
                             torch.float32)
    agc_scan_serial.launches += 1
    return out


agc_scan_serial.launches = 0


def agc_scan_f64(gain, x, p: AGCParams):
    """:func:`agc_scan` in float64 (the ``argos`` mode's exact chain): the
    serial kernel instantiated in double, one thread a lane; (B, n)
    float64 `x`, (B,) float64 gains.  CUDA tensors only."""
    if not on_card("agc_scan_f64", x.device):
        raise ValueError("agc_scan_f64 runs on a CUDA device only")
    out = _launch_agc_serial("pdt_agc_scan_f64", gain, x, p, torch.float64)
    agc_scan_f64.launches += 1
    return out


agc_scan_f64.launches = 0


def agc_launch_config(device="cuda") -> dict:
    """The AGC kernel's launch configuration: lanes per CTA, chunk
    samples, threads and (static) shared memory bytes a CTA, registers and
    local (spill) bytes a thread, as the card reports them."""
    return kernel_config(device, "pdt_agc_scan_config")


class GardnerParams(NamedTuple):
    step_size: float
    err_limit: float
    kp: float
    resync_threshold: float


class Layout(NamedTuple):
    """Window layout of the windowed Gardner scan (JAX clock.py:171-181)."""
    n_win: int         # windows
    window: int        # interpolated samples per window
    margin: int        # left context of each window
    spw: int           # symbol slots per window


def layout(cap: int, window: int, step_size: float, err_limit: float,
           margin=None) -> Layout:
    if margin is None:
        # the mid-bit sample lies step_size/2 behind the on-time read
        margin = max(16, int(np.ceil(step_size / 2.0 + err_limit)) + 2)
    if cap % window:
        raise ValueError(f"length {cap} is not a multiple of the window "
                         f"{window}")
    return Layout(n_win=cap // window, window=window, margin=margin,
                  spw=int(window / step_size * 1.08) + 4)


class _SlotConsts(NamedTuple):
    """The Gardner/Manchester constants of the plain versions as (B,) lane
    tensors in the stream's dtype, rounded as the JAX scans round them."""
    kp: torch.Tensor
    err_limit: torch.Tensor
    neg_limit: torch.Tensor
    step: torch.Tensor
    half_step: torch.Tensor
    thr: torch.Tensor
    zero: torch.Tensor
    one_u8: torch.Tensor


def _slot_consts(p: GardnerParams, like: torch.Tensor) -> _SlotConsts:
    c = lambda v: lane_const(v, like)
    step, err_limit = c(p.step_size), c(p.err_limit)
    return _SlotConsts(
        kp=c(p.kp), err_limit=err_limit, neg_limit=-err_limit, step=step,
        half_step=step / 2.0, thr=c(p.resync_threshold), zero=c(0.0),
        one_u8=torch.ones(like.shape, dtype=torch.uint8, device=like.device))


def _plain_slot(st, cur, hval, active, k: _SlotConsts):
    """One symbol slot of the plain versions (JAX ``clock.py:84-100`` and
    ``manchester.py:43-70``): the timing error and update from the slot's
    on-time value `cur` and mid-bit value `hval`, then the Manchester
    resync and decision on this symbol.  st: (next_sample, half_raw,
    prev_bit, Manchester cur, prev, prevprev, clockmod, evenodd); an
    active slot advances it.  Returns (state, bit uint8, emit)."""
    ns, half_raw, prev_bit = st[:3]
    err = torch.clamp(k.kp * (cur - prev_bit) * hval, k.neg_limit,
                      k.err_limit)
    ns_adj = ns - err
    half_new = ns_adj + k.half_step
    ns_new = ns_adj + k.step
    keep = lambda new, old: torch.where(active, new, old)
    man, bit, emit = _plain_manchester(st[3:], cur, active, k.thr, k.one_u8)
    return ((keep(ns_new, ns), keep(half_new, half_raw), keep(cur, prev_bit),
             *man), bit, emit)


def _plain_manchester(mst, cur, active, thr, one_u8):
    """The Manchester decision on one slot's symbol `cur`
    (``manchester.py:43-70``, ManchesterDecode.c:27-97) with (B,) lane
    tensors `thr` (the resync threshold) and `one_u8` (uint8 ones).  mst:
    (cur, prev, prevprev, clockmod, evenodd); an active slot advances it.
    Returns (mst, bit uint8, emit)."""
    m_cur, m_prev, m_prevprev, clockmod, evenodd = mst
    prevprev, prev = m_prev, m_cur
    mismatch = evenodd != clockmod
    strong = (torch.abs(prevprev) > thr) & (torch.abs(prev) > thr)
    resync = mismatch & (fastmath.sign(prevprev)
                         == fastmath.sign(prev)) & strong
    cm = torch.where(resync, evenodd, clockmod)
    boundary = evenodd == cm
    use_prev = torch.abs(prev) > torch.abs(cur)
    bit = torch.where(use_prev, (prev > 0).to(torch.uint8),
                      one_u8 - (cur > 0).to(torch.uint8))
    keep = lambda new, old: torch.where(active, new, old)
    mst = (keep(cur, m_cur), keep(prev, m_prev), keep(prevprev, m_prevprev),
           keep(cm, clockmod), keep((evenodd + 1) & 1, evenodd))
    return mst, bit, active & boundary


def _plain_result(st, n):
    """The plain versions' final state: fstate and istate rows, with the
    chunk rollover of next_sample (JAX clock.py:104-107); half_raw is
    kept."""
    ns, *rest = st
    return (ns - n.to(ns.dtype), *rest[:5]), tuple(rest[5:])


def gardner_manchester_ref(fstate, istate, x, t, n, p: GardnerParams,
                           lay: Layout):
    """Plain PyTorch version of :func:`gardner_manchester`: the JAX windowed
    scan, slot by slot, with the window buffers read in place (window w's
    buffer entry k is sample w*window - margin + k, zero before the
    stream)."""
    f32, i32 = torch.float32, torch.int32
    st = (*fstate, *istate)
    k = _slot_consts(p, fstate[0])
    span = lay.window + lay.margin
    # xp[j] = x[j - margin]: every window's buffer is a slice of it
    xp = torch.nn.functional.pad(x.to(f32), (lay.margin, 0))
    tp = torch.nn.functional.pad(t.to(f32), (lay.margin, 0))
    bits, btimes, emits = [], [], []
    for w in range(lay.n_win):
        w_end = torch.clamp(n, max=(w + 1) * lay.window).to(f32)
        base = w * lay.window - lay.margin
        for _ in range(lay.spw):
            ns, half_raw = st[0], st[1]
            idxf = torch.round(ns)
            active = idxf < w_end
            ii = torch.clamp(idxf.to(i32) - base, 0, span - 1)
            at = (ii + w * lay.window).to(torch.int64)[:, None]
            cur = torch.gather(xp, 1, at)[:, 0]
            tval = torch.gather(tp, 1, at)[:, 0]
            hidxf = torch.round(half_raw)
            hl = hidxf.to(i32) - base
            h_ok = (hl >= 0) & (hl < span) & (hidxf >= 0)
            hat = (torch.clamp(hl, 0, span - 1)
                   + w * lay.window).to(torch.int64)[:, None]
            hval = torch.where(h_ok, torch.gather(xp, 1, hat)[:, 0], k.zero)
            st, bit, emit = _plain_slot(st, cur, hval, active, k)
            bits.append(bit)
            btimes.append(tval)
            emits.append(emit)
    return (*_plain_result(st, n), torch.stack(bits, 1),
            torch.stack(btimes, 1), torch.stack(emits, 1))


def _gardner_args(fstate, istate, x, t, n, lay=None, dtype=torch.float32):
    """Check a launch's arguments (and the layout, if any); returns the
    state as (6, B) `dtype` and (2, B) int32 rows."""
    dev = x.device
    B, cap = x.shape
    if lay is not None and cap != lay.n_win * lay.window:
        raise ValueError(f"x has {cap} samples, layout {lay} needs "
                         f"{lay.n_win * lay.window}")
    check("x", x, (B, cap), (dtype,), dev)
    check("t", t, (B, cap), (dtype,), dev)
    check("n", n, (B,), (torch.int32,), dev)
    for k, s in enumerate(fstate):
        check(f"fstate[{k}]", s, (B,), (dtype,), dev)
    for k, s in enumerate(istate):
        check(f"istate[{k}]", s, (B,), (torch.int32,), dev)
    return (torch.stack(list(fstate)).contiguous(),
            torch.stack(list(istate)).contiguous())


def gardner_manchester(fstate, istate, x, t, n, p: GardnerParams,
                       lay: Layout, *, filled=None):
    """Gardner timing + Manchester decision over (B, cap) float32 `x` and
    time plane `t`, cap = lay.n_win * lay.window; n: (B,) int32 valid
    lengths.  fstate: six (B,) float32 planes (next_sample, half_raw,
    prev_bit, Manchester cur, prev, prevprev); istate: two (B,) int32
    planes (clockmod, evenodd).  Returns (fstate, istate, bits
    (B, n_win*spw) uint8, bit_times float32, emit bool), the three
    contiguous.  CPU tensors run :func:`gardner_manchester_ref`.
    ``filled``, a (B,) int32 tensor on the card, receives each lane's
    slots that followed an inactive slot in their window (filled, not
    computed)."""
    dev = x.device
    if not on_card("gardner_manchester", dev):
        return gardner_manchester_ref(fstate, istate, x, t, n, p, lay)
    f_in, i_in = _gardner_args(fstate, istate, x, t, n, lay)
    B = x.shape[0]
    if filled is not None:
        check("filled", filled, (B,), (torch.int32,), dev)
    # lane-major rows, read in place: a window of a lane is contiguous
    x, t, n = x.contiguous(), t.contiguous(), n.contiguous()
    slots = lay.n_win * lay.spw
    bits = torch.empty((B, slots), dtype=torch.uint8, device=dev)
    btimes = torch.empty((B, slots), dtype=torch.float32, device=dev)
    emit = torch.empty((B, slots), dtype=torch.bool, device=dev)
    f_out = torch.empty_like(f_in)
    i_out = torch.empty_like(i_in)
    params = np.array(p, np.float32)
    launch(dev, "pdt_gardner_manchester", x.data_ptr(), t.data_ptr(),
           n.data_ptr(), f_in.data_ptr(), i_in.data_ptr(), bits.data_ptr(),
           btimes.data_ptr(), emit.data_ptr(), f_out.data_ptr(),
           i_out.data_ptr(), None if filled is None else filled.data_ptr(),
           B, lay.n_win, lay.window, lay.margin, lay.spw,
           params.ctypes.data_as(ctypes.c_void_p), params.size)
    gardner_manchester.launches += 1
    return (tuple(f_out.unbind(0)), tuple(i_out.unbind(0)), bits, btimes,
            emit)


gardner_manchester.launches = 0


def gardner_manchester_serial(fstate, istate, x, t, n, p: GardnerParams,
                              lay: Layout):
    """:func:`gardner_manchester` on the serial kernel, one thread a lane
    over time-major copies of `x` and `t`; its outputs are transposed
    views of time-major planes.  No path calls it: the card checks and
    ``chip_smoke.py`` hold :func:`gardner_manchester` to it over whole
    passes and time the two in one run.  CUDA tensors only."""
    dev = x.device
    if not on_card("gardner_manchester_serial", dev):
        raise ValueError("gardner_manchester_serial runs on a CUDA device "
                         "only")
    f_in, i_in = _gardner_args(fstate, istate, x, t, n, lay)
    B = x.shape[0]
    xt = x.t().contiguous()           # time-major (cap, B)
    tt = t.t().contiguous()
    n = n.contiguous()
    slots = lay.n_win * lay.spw
    bits = torch.empty((slots, B), dtype=torch.uint8, device=dev)
    btimes = torch.empty((slots, B), dtype=torch.float32, device=dev)
    emit = torch.empty((slots, B), dtype=torch.bool, device=dev)
    f_out = torch.empty_like(f_in)
    i_out = torch.empty_like(i_in)
    params = np.array(p, np.float32)
    launch(dev, "pdt_gardner_manchester_serial", xt.data_ptr(),
           tt.data_ptr(), n.data_ptr(), f_in.data_ptr(), i_in.data_ptr(),
           bits.data_ptr(), btimes.data_ptr(), emit.data_ptr(),
           f_out.data_ptr(), i_out.data_ptr(), B, lay.n_win, lay.window,
           lay.margin, lay.spw, params.ctypes.data_as(ctypes.c_void_p),
           params.size)
    gardner_manchester_serial.launches += 1
    return (tuple(f_out.unbind(0)), tuple(i_out.unbind(0)), bits.t(),
            btimes.t(), emit.t())


gardner_manchester_serial.launches = 0

# what pdt_gardner_manchester_config reports, in order
GARDNER_CONFIG_FIELDS = ("lanes_per_cta", "buffers", "threads",
                         "dynamic_smem_bytes", "ctas_per_sm", "registers",
                         "local_bytes")


def gardner_launch_config(lay: Layout, device="cuda") -> dict:
    """The Gardner kernel's launch configuration for a layout: lanes per
    CTA, window buffers in shared memory, threads and dynamic shared
    memory bytes a CTA, the CTAs resident on an SM at that size, and
    registers and local (spill) bytes a thread, as the card reports
    them."""
    return kernel_config(device, "pdt_gardner_manchester_config",
                         lay.window, lay.margin, lay.spw,
                         fields=GARDNER_CONFIG_FIELDS)


def gardner_manchester_scan_ref(fstate, istate, x, t, n, p: GardnerParams,
                                max_syms: int):
    """Plain PyTorch version of :func:`gardner_manchester_scan`: JAX's
    ``gardner_scan`` then ``manchester_scan`` (``clock.py:58-108``,
    ``manchester.py:34-74``), slot by slot over all lanes at once, in the
    state's dtype (float32, or float64)."""
    i32 = torch.int32
    B, cap = x.shape
    st = (*fstate, *istate)
    k = _slot_consts(p, fstate[0])
    dt = k.zero.dtype
    n_f, cap_f = n.to(dt), lane_const(cap, fstate[0])
    x, t = x.to(dt), t.to(dt)
    syms, times, valid, bits, emits = [], [], [], [], []
    for _ in range(max_syms):
        ns, half_raw = st[0], st[1]
        idxf = torch.round(ns)
        active = idxf < n_f
        ii = torch.clamp(idxf.to(i32), 0, cap - 1).to(torch.int64)[:, None]
        cur = torch.gather(x, 1, ii)[:, 0]
        tval = torch.gather(t, 1, ii)[:, 0]
        hidxf = torch.round(half_raw)
        in_img = (hidxf >= k.zero) & (hidxf < cap_f)
        hi = torch.clamp(hidxf.to(i32), 0, cap - 1).to(torch.int64)[:, None]
        hval = torch.where(in_img, torch.gather(x, 1, hi)[:, 0], k.zero)
        st, bit, emit = _plain_slot(st, cur, hval, active, k)
        syms.append(cur)
        times.append(tval)
        valid.append(active)
        bits.append(bit)
        emits.append(emit)
    valid = torch.stack(valid, 1)
    return (*_plain_result(st, n), torch.stack(syms, 1),
            torch.stack(times, 1), valid, torch.stack(bits, 1),
            torch.stack(emits, 1), valid.sum(1, dtype=i32))


def _launch_scan(entry: str, fstate, istate, x, t, n, p: GardnerParams,
                 max_syms: int, *extra, dtype=torch.float32):
    """Launch a whole-image scan kernel (`extra`: its arguments after
    max_syms) on `dtype` images and state; returns the wrapper's
    outputs."""
    dev = x.device
    f_in, i_in = _gardner_args(fstate, istate, x, t, n, dtype=dtype)
    B, cap = x.shape
    x, t, n = x.contiguous(), t.contiguous(), n.contiguous()
    syms = torch.empty((B, max_syms), dtype=dtype, device=dev)
    times = torch.empty_like(syms)
    flags = torch.empty((3, B, max_syms), dtype=torch.bool, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    f_out = torch.empty_like(f_in)
    i_out = torch.empty_like(i_in)
    params = np.array(p, np.float64 if dtype == torch.float64
                      else np.float32)
    launch(dev, entry, x.data_ptr(), t.data_ptr(), n.data_ptr(),
           f_in.data_ptr(), i_in.data_ptr(), syms.data_ptr(),
           times.data_ptr(), flags[0].data_ptr(), flags[1].data_ptr(),
           flags[2].data_ptr(), f_out.data_ptr(), i_out.data_ptr(),
           count.data_ptr(), B, cap, max_syms, *extra,
           params.ctypes.data_as(ctypes.c_void_p), params.size)
    valid, bits, emit = flags.unbind(0)
    return (tuple(f_out.unbind(0)), tuple(i_out.unbind(0)), syms, times,
            valid, bits.view(torch.uint8), emit, count)


def gardner_manchester_scan(fstate, istate, x, t, n, p: GardnerParams,
                            max_syms: int, *, ring_floats: int = 0):
    """Gardner timing + Manchester decision over whole (B, cap) float32
    buffer images `x` and `t` (no windows), max_syms slots; n: (B,) int32
    valid lengths; fstate, istate as :func:`gardner_manchester`.  Returns
    (fstate, istate, syms, times (B, max_syms) float32, valid, bits uint8,
    emit bool (B, max_syms), count (B,) int32 active slots); a slot's time
    is its symbol's and its bit's.  CPU tensors run
    :func:`gardner_manchester_scan_ref`; float64 tensors on the card launch
    :func:`gardner_manchester_scan_f64`.  The kernel stages each lane's
    image in a ring of shared memory that it sizes itself
    (:func:`gardner_scan_launch_config`); ``ring_floats`` > 0 caps the
    ring (so that a small image recycles its tiles), for tests; it counts
    elements of the image's dtype."""
    dev = x.device
    if not on_card("gardner_manchester_scan", dev):
        return gardner_manchester_scan_ref(fstate, istate, x, t, n, p,
                                           max_syms)
    if x.dtype == torch.float64:
        return gardner_manchester_scan_f64(fstate, istate, x, t, n, p,
                                           max_syms, ring_floats=ring_floats)
    out = _launch_scan("pdt_gardner_scan", fstate, istate, x, t, n, p,
                       max_syms, int(ring_floats))
    gardner_manchester_scan.launches += 1
    return out


gardner_manchester_scan.launches = 0


def gardner_manchester_scan_serial(fstate, istate, x, t, n,
                                   p: GardnerParams, max_syms: int):
    """:func:`gardner_manchester_scan` on the serial kernel, one thread a
    lane reading the image from device memory.  No path calls it: the
    card checks and ``chip_smoke.py`` hold :func:`gardner_manchester_scan`
    to it and time the two in one run.  CUDA tensors only."""
    dev = x.device
    if not on_card("gardner_manchester_scan_serial", dev):
        raise ValueError("gardner_manchester_scan_serial runs on a CUDA "
                         "device only")
    out = _launch_scan("pdt_gardner_scan_serial", fstate, istate, x, t, n,
                       p, max_syms)
    gardner_manchester_scan_serial.launches += 1
    return out


gardner_manchester_scan_serial.launches = 0


def gardner_manchester_scan_f64(fstate, istate, x, t, n, p: GardnerParams,
                                max_syms: int, *, ring_floats: int = 0):
    """:func:`gardner_manchester_scan` in float64 (the ``argos`` mode's
    exact chain): the whole-image kernel instantiated in double, one lane
    a CTA, the image staged in shared memory; float64 `x`, `t` and
    fstate, float64 syms and times; ``ring_floats`` as
    :func:`gardner_manchester_scan`, in doubles.  CUDA tensors only."""
    dev = x.device
    if not on_card("gardner_manchester_scan_f64", dev):
        raise ValueError("gardner_manchester_scan_f64 runs on a CUDA "
                         "device only")
    out = _launch_scan("pdt_gardner_scan_f64", fstate, istate, x, t, n, p,
                       max_syms, int(ring_floats), dtype=torch.float64)
    gardner_manchester_scan_f64.launches += 1
    return out


gardner_manchester_scan_f64.launches = 0


def gardner_manchester_scan_f64_serial(fstate, istate, x, t, n,
                                       p: GardnerParams, max_syms: int):
    """:func:`gardner_manchester_scan_f64` on the serial kernel in double,
    one thread a lane reading the image from device memory.  No path calls
    it: the card checks and ``chip_smoke.py`` hold
    :func:`gardner_manchester_scan_f64` to it and time the two in one run.
    CUDA tensors only."""
    dev = x.device
    if not on_card("gardner_manchester_scan_f64_serial", dev):
        raise ValueError("gardner_manchester_scan_f64_serial runs on a "
                         "CUDA device only")
    out = _launch_scan("pdt_gardner_scan_f64_serial", fstate, istate, x, t,
                       n, p, max_syms, dtype=torch.float64)
    gardner_manchester_scan_f64_serial.launches += 1
    return out


gardner_manchester_scan_f64_serial.launches = 0

# what pdt_gardner_scan_config reports, in order
GARDNER_SCAN_CONFIG_FIELDS = (
    "ring_floats", "tiles", "tile_floats", "resident", "segment_slots",
    "threads", "dynamic_smem_bytes", "ctas_per_sm", "registers",
    "local_bytes")


def gardner_scan_launch_config(B: int, cap: int, ring_floats: int = 0,
                               device="cuda", dtype=torch.float32) -> dict:
    """The whole-image Gardner kernel's launch configuration in `dtype`
    (float32 or float64) for B lanes of cap samples: the ring's elements
    ("floats": of the dtype), tiles and elements a tile, whether it holds
    the whole image (1) or recycles its tiles (0), slots a record segment,
    threads and dynamic shared memory bytes a CTA, the CTAs resident on an
    SM at that size, and registers and local (spill) bytes a thread, as
    the card reports them."""
    return clock_scan_launch_config("gardner", B, cap, ring_floats, device,
                                    dtype)


# --- the other clocks of the exact chain: "mm", "upsampling_gardner" and
# "upsampling_mm", each followed by the Manchester decision


class MMParams(NamedTuple):
    """The Mueller & Muller clock's constants (JAX ``clock.py:122-123``):
    the adaptive step's clamp [step_min, step_max] = fs / (baud +- range),
    the loop gain and the Manchester resync threshold."""
    step_min: float
    step_max: float
    kp: float
    resync_threshold: float


def mm_params(fs: float, baud: float, step_range: float, kp: float,
              resync_threshold: float) -> MMParams:
    """The step clamp computed in double, as JAX computes it before
    rounding it to the stream's dtype."""
    return MMParams(fs / (baud + step_range), fs / (baud - step_range), kp,
                    resync_threshold)


class UpsamplingParams(NamedTuple):
    """The upsampling clocks' constants (JAX ``clock.py:296-300``): the step
    and the half step, each split in double into an integer part and a
    fraction, the error limit, the loop gain and the Manchester resync
    threshold.  The M&M variant reads no half step."""
    step_int: float
    step_frac: float
    half_int: float
    half_frac: float
    err_limit: float
    kp: float
    resync_threshold: float


def upsampling_params(step_size: float, err_limit: float, kp: float,
                      resync_threshold: float) -> UpsamplingParams:
    hs = step_size / 2.0
    return UpsamplingParams(
        float(np.floor(step_size)), float(step_size - np.floor(step_size)),
        float(np.floor(hs)), float(hs - np.floor(hs)), err_limit, kp,
        resync_threshold)


def _read(img, i):
    """img[b, i[b]] for each lane, i an int32 (B,) index."""
    return torch.gather(img, 1, i.to(torch.int64)[:, None])[:, 0]


def _split_norm(i, f):
    """A split pointer renormalised so that the fraction lies in [0, 1)
    (JAX ``clock.py:266-269``)."""
    k = torch.floor(f)
    return i + k, f - k


def _mm_timing(p: MMParams, like):
    """The M&M clock's slot (JAX ``clock.py:128-141``) over timing rows
    (next_sample, step, prev_bit): returns step(rows, x, n_f) -> (rows,
    cur, on-time index, active)."""
    c = lambda v: lane_const(v, like)
    kp, smin, smax = c(p.kp), c(p.step_min), c(p.step_max)

    def step(rows, x, n_f):
        ns, ss, prev = rows
        idxf = torch.round(ns)
        active = idxf < n_f
        ii = torch.clamp(idxf.to(torch.int32), 0, x.shape[1] - 1)
        cur = _read(x, ii)
        err = fastmath.sign(prev) * cur - fastmath.sign(cur) * prev
        ss_new = torch.clamp(ss + kp * err, smin, smax)
        ns_new = ns + ss_new
        keep = lambda new, old: torch.where(active, new, old)
        return ((keep(ns_new, ns), keep(ss_new, ss), keep(cur, prev)), cur,
                ii, active)
    return step


def _upsampling_timing(p: UpsamplingParams, like, gardner: bool):
    """An upsampling clock's slot over split pointers: Gardner (JAX
    ``clock.py:305-335``, timing rows next_sample int, frac, half_raw
    int, frac, prev_bit) or M&M (``clock.py:362-377``, rows next_sample
    int, frac, prev_bit).  Reads at int + (frac >= 0.5).  Returns
    step(rows, x, n_f) -> (rows, cur, on-time index, active)."""
    c = lambda v: lane_const(v, like)
    kp, lim, zero, half = c(p.kp), c(p.err_limit), c(0.0), c(0.5)
    si, sf, hsi, hsf = (c(p.step_int), c(p.step_frac), c(p.half_int),
                        c(p.half_frac))

    def step(rows, x, n_f):
        cap = x.shape[1]
        if gardner:
            ni, nf, hi, hf, prev = rows
        else:
            ni, nf, prev = rows
        idx = ni + (nf >= half).to(ni.dtype)
        active = idx < n_f
        ii = torch.clamp(idx.to(torch.int32), 0, cap - 1)
        cur = _read(x, ii)
        keep = lambda new, old: torch.where(active, new, old)
        if gardner:
            hidx = hi + (hf >= half).to(hi.dtype)
            in_img = (hidx >= zero) & (hidx < c(cap))
            hval = torch.where(in_img, _read(x, torch.clamp(
                hidx.to(torch.int32), 0, cap - 1)), zero)
            err = torch.clamp(kp * (cur - prev) * hval, -lim, lim)
            ai, af = _split_norm(ni, nf - err)            # -= Error
            nhi, nhf = _split_norm(ai + hsi, af + hsf)    # + step/2
            nni, nnf = _split_norm(ai + si, af + sf)      # + step
            rows = (keep(nni, ni), keep(nnf, nf), keep(nhi, hi),
                    keep(nhf, hf), keep(cur, prev))
        else:
            err = torch.clamp(kp * (fastmath.sign(prev) * cur
                                    - fastmath.sign(cur) * prev), -lim, lim)
            ai, af = _split_norm(ni, nf + err)            # += Error
            nni, nnf = _split_norm(ai + si, af + sf)      # + step
            rows = (keep(nni, ni), keep(nnf, nf), keep(cur, prev))
        return rows, cur, ii, active
    return step


def _clock_manchester_ref(timing, n_rows: int, fstate, istate, x, t, n,
                          thr: float, max_syms: int, rollover: bool):
    """The plain clock + Manchester scan: `timing`'s slot over the first
    `n_rows` rows of fstate, then the Manchester decision on its symbol,
    max_syms slots over all lanes at once; next_sample rolled over by n
    where `rollover` (the M&M clock, JAX ``clock.py:146``).  Returns what
    :func:`gardner_manchester_scan` returns."""
    i32 = torch.int32
    like = fstate[0]
    dt = pll_ops.stream_dtype(like)
    thr = lane_const(thr, like)
    one_u8 = torch.ones(like.shape, dtype=torch.uint8, device=like.device)
    rows, man = tuple(fstate[:n_rows]), (*fstate[n_rows:], *istate)
    n_f, x, t = n.to(dt), x.to(dt), t.to(dt)
    syms, times, valid, bits, emits = [], [], [], [], []
    for _ in range(max_syms):
        rows, cur, ii, active = timing(rows, x, n_f)
        man, bit, emit = _plain_manchester(man, cur, active, thr, one_u8)
        syms.append(cur)
        times.append(_read(t, ii))
        valid.append(active)
        bits.append(bit)
        emits.append(emit)
    if rollover:
        rows = (rows[0] - n_f, *rows[1:])
    valid = torch.stack(valid, 1)
    return ((*rows, *man[:3]), tuple(man[3:]), torch.stack(syms, 1),
            torch.stack(times, 1), valid, torch.stack(bits, 1),
            torch.stack(emits, 1), valid.sum(1, dtype=i32))


def mm_manchester_scan_ref(fstate, istate, x, t, n, p: MMParams,
                           max_syms: int):
    """Plain PyTorch version of :func:`mm_manchester_scan`: JAX's
    ``mm_scan`` then ``manchester_scan`` (``clock.py:111-148``,
    ``manchester.py:34-74``), slot by slot over all lanes at once, in the
    state's dtype."""
    return _clock_manchester_ref(_mm_timing(p, fstate[0]), 3, fstate,
                                 istate, x, t, n, p.resync_threshold,
                                 max_syms, rollover=True)


def upsampling_gardner_manchester_scan_ref(fstate, istate, x, t, n,
                                           p: UpsamplingParams,
                                           max_syms: int):
    """Plain PyTorch version of :func:`upsampling_gardner_manchester_scan`:
    JAX's ``upsampling_gardner_scan`` then ``manchester_scan``
    (``clock.py:272-341``)."""
    return _clock_manchester_ref(_upsampling_timing(p, fstate[0], True), 5,
                                 fstate, istate, x, t, n,
                                 p.resync_threshold, max_syms,
                                 rollover=False)


def upsampling_mm_manchester_scan_ref(fstate, istate, x, t, n,
                                      p: UpsamplingParams, max_syms: int):
    """Plain PyTorch version of :func:`upsampling_mm_manchester_scan`:
    JAX's ``upsampling_mm_scan`` then ``manchester_scan``
    (``clock.py:344-383``)."""
    return _clock_manchester_ref(_upsampling_timing(p, fstate[0], False), 3,
                                 fstate, istate, x, t, n,
                                 p.resync_threshold, max_syms,
                                 rollover=False)


def _clock_wrapper(name: str, entry: str, ref=None, f64=None,
                   dtype=torch.float32, ring: bool = False):
    """A clock kernel's wrapper that launches `entry` on `dtype` tensors on
    the card and counts its launches.  `ring`: `entry` is the whole-image
    kernel (one lane a CTA, the image staged in shared memory), and the
    wrapper takes :func:`gardner_manchester_scan`'s ``ring_floats``
    keyword; else the simple design (one thread a lane).  The float32
    wrapper runs `ref` on CPU tensors and hands float64 tensors on the card
    to `f64`, the double instance's wrapper; without `ref` (the double
    instances, the serial twins) it raises on CPU tensors."""
    def run(fstate, istate, x, t, n, p, max_syms, extra, kw):
        dev = x.device
        if not on_card(name, dev):
            if ref is None:
                raise ValueError(f"{name} runs on a CUDA device only")
            return ref(fstate, istate, x, t, n, p, max_syms)
        if f64 is not None and x.dtype == torch.float64:
            return f64(fstate, istate, x, t, n, p, max_syms, **kw)
        out = _launch_scan(entry, fstate, istate, x, t, n, p, max_syms,
                           *extra, dtype=dtype)
        wrapper.launches += 1
        return out
    if ring:
        def wrapper(fstate, istate, x, t, n, p, max_syms: int, *,
                    ring_floats: int = 0):
            return run(fstate, istate, x, t, n, p, max_syms,
                       (int(ring_floats),), dict(ring_floats=ring_floats))
    else:
        def wrapper(fstate, istate, x, t, n, p, max_syms: int):
            return run(fstate, istate, x, t, n, p, max_syms, (), {})
    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.launches = 0
    return wrapper


def _serial_twin(clock: str, entry: str, dtype):
    """The serial twin of a redesigned clock kernel: its simple design, one
    thread a lane over the image in device memory.  No path calls it: the
    card checks and ``chip_smoke.py`` hold the whole-image kernel to it and
    time the two in one run.  CUDA tensors only."""
    suffix = "_f64" if dtype == torch.float64 else ""
    w = _clock_wrapper(f"{clock}_manchester_scan{suffix}_serial", entry,
                       dtype=dtype)
    w.__doc__ = (f":func:`{clock}_manchester_scan{suffix}` on its serial "
                 "twin, one thread a lane reading the image from device "
                 "memory; on no path.  CUDA tensors only.")
    return w


mm_manchester_scan_f64 = _clock_wrapper(
    "mm_manchester_scan_f64", "pdt_mm_scan_f64", dtype=torch.float64,
    ring=True)
mm_manchester_scan = _clock_wrapper(
    "mm_manchester_scan", "pdt_mm_scan", mm_manchester_scan_ref,
    mm_manchester_scan_f64, ring=True)
mm_manchester_scan.__doc__ = """The M&M clock with its adaptive step, then
the Manchester decision, over whole (B, cap) buffer images `x`, `t`,
max_syms slots (JAX ``mm_scan`` + ``manchester_scan``).  fstate: six (B,)
planes in the images' dtype (next_sample, step, prev_bit, Manchester cur,
prev, prevprev); istate: (clockmod, evenodd) int32; n: (B,) int32 valid
lengths; p: :func:`mm_params`.  Returns (fstate, istate, syms, times,
valid, bits uint8, emit, count) as :func:`gardner_manchester_scan`,
next_sample rolled over by n.  The kernel is the whole-image one, each
lane's image staged in a ring of shared memory, ``ring_floats`` as
:func:`gardner_manchester_scan`'s.  CPU tensors run
:func:`mm_manchester_scan_ref`; float64 tensors on the card launch
:func:`mm_manchester_scan_f64`."""
mm_manchester_scan_f64.__doc__ = """:func:`mm_manchester_scan` in float64,
the kernel's double instance (``ring_floats`` in doubles).  CUDA tensors
only."""
mm_manchester_scan_serial = _serial_twin("mm", "pdt_mm_scan_serial",
                                         torch.float32)
mm_manchester_scan_f64_serial = _serial_twin(
    "mm", "pdt_mm_scan_f64_serial", torch.float64)

upsampling_gardner_manchester_scan_f64 = _clock_wrapper(
    "upsampling_gardner_manchester_scan_f64",
    "pdt_upsampling_gardner_scan_f64", dtype=torch.float64, ring=True)
upsampling_gardner_manchester_scan = _clock_wrapper(
    "upsampling_gardner_manchester_scan", "pdt_upsampling_gardner_scan",
    upsampling_gardner_manchester_scan_ref,
    upsampling_gardner_manchester_scan_f64, ring=True)
upsampling_gardner_manchester_scan.__doc__ = """The Gardner clock on an
upsampled stream with split (integer part, fraction) pointers, then the
Manchester decision (JAX ``upsampling_gardner_scan`` +
``manchester_scan``).  fstate: eight (B,) planes (next_sample int, frac,
half_raw int, frac, prev_bit, Manchester cur, prev, prevprev); p:
:func:`upsampling_params` of the upsampled step.  The pointers are not
rolled over (the chain shifts their integer parts).  Otherwise as
:func:`mm_manchester_scan`."""
upsampling_gardner_manchester_scan_f64.__doc__ = """
:func:`upsampling_gardner_manchester_scan` in float64, the kernel's double
instance.  CUDA tensors only."""
upsampling_gardner_manchester_scan_serial = _serial_twin(
    "upsampling_gardner", "pdt_upsampling_gardner_scan_serial",
    torch.float32)
upsampling_gardner_manchester_scan_f64_serial = _serial_twin(
    "upsampling_gardner", "pdt_upsampling_gardner_scan_f64_serial",
    torch.float64)

upsampling_mm_manchester_scan_f64 = _clock_wrapper(
    "upsampling_mm_manchester_scan_f64", "pdt_upsampling_mm_scan_f64",
    dtype=torch.float64, ring=True)
upsampling_mm_manchester_scan = _clock_wrapper(
    "upsampling_mm_manchester_scan", "pdt_upsampling_mm_scan",
    upsampling_mm_manchester_scan_ref, upsampling_mm_manchester_scan_f64,
    ring=True)
upsampling_mm_manchester_scan.__doc__ = """The M&M clock on an upsampled
stream with a fixed step and a split next-sample pointer, then the
Manchester decision (JAX ``upsampling_mm_scan`` + ``manchester_scan``).
fstate: six (B,) planes (next_sample int, frac, prev_bit, Manchester cur,
prev, prevprev).  Otherwise as
:func:`upsampling_gardner_manchester_scan`."""
upsampling_mm_manchester_scan_f64.__doc__ = """
:func:`upsampling_mm_manchester_scan` in float64, the kernel's double
instance.  CUDA tensors only."""
upsampling_mm_manchester_scan_serial = _serial_twin(
    "upsampling_mm", "pdt_upsampling_mm_scan_serial", torch.float32)
upsampling_mm_manchester_scan_f64_serial = _serial_twin(
    "upsampling_mm", "pdt_upsampling_mm_scan_f64_serial", torch.float64)

# the whole-image kernel's clocks: their config entry points' stems
SCAN_CLOCKS = {"gardner": "pdt_gardner_scan", "mm": "pdt_mm_scan",
               "upsampling_gardner": "pdt_upsampling_gardner_scan",
               "upsampling_mm": "pdt_upsampling_mm_scan"}


def clock_scan_launch_config(clock: str, B: int, cap: int,
                             ring_floats: int = 0, device="cuda",
                             dtype=torch.float32) -> dict:
    """The whole-image kernel's launch configuration under `clock` (a key
    of :data:`SCAN_CLOCKS`), in `dtype`, for B lanes of cap samples: the
    fields of :func:`gardner_scan_launch_config`, as the card reports
    them."""
    entry = SCAN_CLOCKS[clock] + ("_f64" if dtype == torch.float64 else "")
    return kernel_config(device, entry + "_config", B, cap, ring_floats,
                         fields=GARDNER_SCAN_CONFIG_FIELDS)

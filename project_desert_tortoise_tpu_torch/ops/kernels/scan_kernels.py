"""The per-lane recurrences of the scan branch and the exact chain: the AGC
and Gardner timing with the Manchester decision.

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
    ns, half_raw, prev_bit, m_cur, m_prev, m_prevprev, clockmod, evenodd = st
    err = torch.clamp(k.kp * (cur - prev_bit) * hval, k.neg_limit,
                      k.err_limit)
    ns_adj = ns - err
    half_new = ns_adj + k.half_step
    ns_new = ns_adj + k.step

    # Manchester on this symbol (ManchesterDecode.c:27-97)
    prevprev, prev = m_prev, m_cur
    mismatch = evenodd != clockmod
    strong = (torch.abs(prevprev) > k.thr) & (torch.abs(prev) > k.thr)
    resync = mismatch & (fastmath.sign(prevprev)
                         == fastmath.sign(prev)) & strong
    cm = torch.where(resync, evenodd, clockmod)
    boundary = evenodd == cm
    use_prev = torch.abs(prev) > torch.abs(cur)
    bit = torch.where(use_prev, (prev > 0).to(torch.uint8),
                      k.one_u8 - (cur > 0).to(torch.uint8))
    keep = lambda new, old: torch.where(active, new, old)
    st = (keep(ns_new, ns), keep(half_new, half_raw), keep(cur, prev_bit),
          keep(cur, m_cur), keep(prev, m_prev), keep(prevprev, m_prevprev),
          keep(cm, clockmod), keep((evenodd + 1) & 1, evenodd))
    return st, bit, active & boundary


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
    entry = ("pdt_gardner_scan_f64_config" if dtype == torch.float64
             else "pdt_gardner_scan_config")
    return kernel_config(device, entry, B, cap, ring_floats,
                         fields=GARDNER_SCAN_CONFIG_FIELDS)

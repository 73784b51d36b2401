"""Symbol timing: the Gardner step size, and Gardner timing with the
Manchester decision over the interpolated stream, windowed or whole; the
exact chain's other clocks, Mueller & Muller and the two upsampling
variants, each with the Manchester decision.

Twins of ``project_desert_tortoise_tpu/ops/clock.py``: ``gardner_step_size``,
``GardnerState``, ``gardner_init``, ``gardner_manchester_windowed``
(``clock.py:34-42, 151-263``) and ``gardner_scan`` (``clock.py:58-108``)
followed by ``ops/manchester.py::manchester_scan``, which are one function
here, :func:`gardner_manchester_scan`, as one kernel computes both.  The
windowed recurrence runs in the kernel
``ops/kernels/scan_kernels.py::gardner_manchester`` on the card, the whole
one in ``scan_kernels.py::gardner_manchester_scan``; on the fused path it
runs inside the fused kernel instead.  ``mm_scan`` (``clock.py:111-148``),
``upsampling_gardner_scan`` (``:272-341``) and ``upsampling_mm_scan``
(``:344-383``) are likewise each one function with the Manchester scan
after them, :func:`mm_manchester_scan`,
:func:`upsampling_gardner_manchester_scan` and
:func:`upsampling_mm_manchester_scan`, on their kernels in
``scan_kernels.py``; the upsampling ones keep split (integer part,
fraction) pointers, ``upsampling_init`` (``clock.py:45-49``).

Reference quirks kept from the JAX scan: the fractional pointer rolls over
between chunks without the pending mid-bit pointer
(``GardenerClockRecovery.c:111``), so the exact chain's first mid-bit read
of a chunk lands at a stale index of the buffer image, and reads outside
the image yield 0.0; ``rint`` rounds half to even.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from project_desert_tortoise_tpu_torch.ops import manchester as man_ops
from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels


class GardnerState(NamedTuple):
    next_sample: torch.Tensor   # fractional on-time pointer (block-relative)
    half_raw: torch.Tensor      # pending mid-bit pointer (not rolled over)
    prev_bit: torch.Tensor


def gardner_init(batch_shape=(), *, device,
                 dtype=torch.float32) -> GardnerState:
    z = torch.zeros(batch_shape, dtype=dtype, device=device)
    return GardnerState(next_sample=z, half_raw=z, prev_bit=z)


def upsampling_init(batch_shape=(), *, device,
                    dtype=torch.float32) -> GardnerState:
    """State of the upsampling clocks: next_sample and half_raw shaped
    (..., 2) = [integer part (an exact float), fraction in [0, 1)]."""
    z2 = torch.zeros(tuple(batch_shape) + (2,), dtype=dtype, device=device)
    return GardnerState(next_sample=z2, half_raw=z2.clone(),
                        prev_bit=torch.zeros(batch_shape, dtype=dtype,
                                             device=device))


def gardner_step_size(fs: float, baud: float, dtype=np.float32) -> float:
    """stepSize = Fs/baud computed in double then stored in stream dtype,
    as the C mixed-precision expression does (GardenerClockRecovery.c:19)."""
    return float(np.dtype(dtype).type(np.float64(fs) / np.float64(baud)))


def _state_rows(g_state: GardnerState, m_state: man_ops.ManchesterState,
                dtype=torch.float32):
    i32 = torch.int32
    return (tuple(s.to(dtype) for s in (*g_state, m_state.cur, m_state.prev,
                                        m_state.prevprev)),
            (m_state.clockmod.to(i32), m_state.evenodd.to(i32)))


def gardner_manchester_windowed(g_state: GardnerState,
                                m_state: man_ops.ManchesterState, x, t, n,
                                step_size: float, err_limit: float,
                                kp: float, resync_threshold: float,
                                window: int, margin: int = None):
    """Gardner timing + Manchester decision over length-`window` chunks of
    (B, cap) `x` (JAX ``gardner_manchester_windowed``): each window's
    symbols fill its ``spw = int(window/step_size*1.08) + 4`` slots, the
    on-time read is clamped into the window's buffer (the window plus
    `margin` samples of left context), and the mid-bit read yields 0
    outside it.

    x, t: (B, cap) with cap % window == 0; n: valid length, an int or (B,).
    Returns (g_state, m_state, bits uint8, bit_times, emit_mask), the
    outputs (B, n_win*spw).  CUDA tensors launch the kernel, CPU tensors
    run its plain version.
    """
    B, cap = x.shape
    lay = scan_kernels.layout(cap, window, step_size, err_limit, margin)
    n = torch.as_tensor(n, dtype=torch.int32, device=x.device).expand(B)
    p = scan_kernels.GardnerParams(step_size, err_limit, kp, resync_threshold)
    fstate, istate = _state_rows(g_state, m_state)
    (ns, half_raw, prev_bit, cur, prev, prevprev), (clockmod, evenodd), \
        bits, btimes, emit = scan_kernels.gardner_manchester(
            fstate, istate, x, t, n.contiguous(), p, lay)
    return (GardnerState(ns, half_raw, prev_bit),
            man_ops.ManchesterState(clockmod=clockmod, evenodd=evenodd,
                                    cur=cur, prev=prev, prevprev=prevprev),
            bits, btimes, emit)


def gardner_manchester_scan(g_state: GardnerState,
                            m_state: man_ops.ManchesterState, x, t, n,
                            step_size: float, err_limit: float, kp: float,
                            resync_threshold: float, max_syms: int):
    """Gardner timing over `max_syms` slots of (B, cap) buffer images `x`,
    `t`, then the Manchester decision on the recovered symbols: JAX's
    ``gardner_scan`` followed by ``manchester_scan``.

    n: valid length, an int or (B,).  Returns (g_state, m_state, syms,
    sym_times, sym_valid, sym_count, bits uint8, bit_times, emit_mask),
    the planes (B, max_syms); the bit times are the symbol times, as in
    JAX.  The state and the outputs are in the dtype of `x` (float32, or
    float64 for the ``argos`` mode's exact chain).  CUDA tensors launch the
    kernel, CPU tensors run its plain version."""
    B = x.shape[0]
    if isinstance(n, int):      # filled on the device: no host copy, no sync
        n = torch.full((B,), n, dtype=torch.int32, device=x.device)
    n = n.to(torch.int32).expand(B)
    fstate, istate = _state_rows(g_state, m_state, x.dtype)
    p = scan_kernels.GardnerParams(step_size, err_limit, kp, resync_threshold)
    (ns, half_raw, prev_bit, cur, prev, prevprev), (clockmod, evenodd), \
        syms, times, valid, bits, emit, count = \
        scan_kernels.gardner_manchester_scan(fstate, istate, x, t,
                                             n.contiguous(), p, max_syms)
    return (GardnerState(ns, half_raw, prev_bit),
            man_ops.ManchesterState(clockmod=clockmod, evenodd=evenodd,
                                    cur=cur, prev=prev, prevprev=prevprev),
            syms, times, valid, count, bits, times, emit)


def _valid_lengths(n, B: int, device):
    """n (an int, filled on the device: no host copy) as (B,) int32."""
    if isinstance(n, int):
        n = torch.full((B,), n, dtype=torch.int32, device=device)
    return n.to(torch.int32).expand(B).contiguous()


def _man_rows(m_state: man_ops.ManchesterState, dtype):
    i32 = torch.int32
    return ((m_state.cur.to(dtype), m_state.prev.to(dtype),
             m_state.prevprev.to(dtype)),
            (m_state.clockmod.to(i32), m_state.evenodd.to(i32)))


def _man_state(f_man, i_man) -> man_ops.ManchesterState:
    cur, prev, prevprev = f_man
    clockmod, evenodd = i_man
    return man_ops.ManchesterState(clockmod=clockmod, evenodd=evenodd,
                                   cur=cur, prev=prev, prevprev=prevprev)


def mm_manchester_scan(g_state: GardnerState,
                       m_state: man_ops.ManchesterState, x, t, n, fs: float,
                       baud: float, step_range: float, kp: float,
                       resync_threshold: float, max_syms: int):
    """Mueller & Muller timing with its adaptive step (JAX ``mm_scan``,
    ``common/MMClockRecovery.c``) over `max_syms` slots of (B, cap) buffer
    images, then the Manchester decision.  The step rides in half_raw's
    slot of `g_state`, as the chain carries it (the caller replaces 0 with
    Fs/baud).  Returns what :func:`gardner_manchester_scan` returns, with
    next_sample rolled over by n and the step in half_raw."""
    B, dt = x.shape[0], x.dtype
    f_man, i_man = _man_rows(m_state, dt)
    fstate = tuple(s.to(dt) for s in g_state) + f_man
    p = scan_kernels.mm_params(fs, baud, step_range, kp, resync_threshold)
    f, i, syms, times, valid, bits, emit, count = \
        scan_kernels.mm_manchester_scan(fstate, i_man, x, t,
                                        _valid_lengths(n, B, x.device), p,
                                        max_syms)
    return (GardnerState(*f[:3]), _man_state(f[3:], i), syms, times, valid,
            count, bits, times, emit)


def upsampling_gardner_manchester_scan(g_state: GardnerState,
                                       m_state: man_ops.ManchesterState, x,
                                       t, n, step_size: float,
                                       err_limit: float, kp: float,
                                       resync_threshold: float,
                                       max_syms: int):
    """Gardner timing on an upsampled stream with split (integer part,
    fraction) pointers (JAX ``upsampling_gardner_scan``,
    ``UpsamplingGardenerClockRecovery2.m:60-95``), then the Manchester
    decision.  g_state: next_sample and half_raw (B, 2); step_size in
    upsampled samples.  Reads at int + (frac >= 0.5); the pointers are not
    rolled over.  Returns what :func:`gardner_manchester_scan` returns."""
    B, dt = x.shape[0], x.dtype
    ns, half = g_state.next_sample.to(dt), g_state.half_raw.to(dt)
    f_man, i_man = _man_rows(m_state, dt)
    fstate = (ns[:, 0], ns[:, 1], half[:, 0], half[:, 1],
              g_state.prev_bit.to(dt)) + f_man
    p = scan_kernels.upsampling_params(step_size, err_limit, kp,
                                       resync_threshold)
    f, i, syms, times, valid, bits, emit, count = \
        scan_kernels.upsampling_gardner_manchester_scan(
            tuple(s.contiguous() for s in fstate), i_man, x, t,
            _valid_lengths(n, B, x.device), p, max_syms)
    g = GardnerState(next_sample=torch.stack(f[:2], -1),
                     half_raw=torch.stack(f[2:4], -1), prev_bit=f[4])
    return (g, _man_state(f[5:], i), syms, times, valid, count, bits, times,
            emit)


def upsampling_mm_manchester_scan(g_state: GardnerState,
                                  m_state: man_ops.ManchesterState, x, t, n,
                                  step_size: float, err_limit: float,
                                  kp: float, resync_threshold: float,
                                  max_syms: int):
    """M&M timing on an upsampled stream with a fixed step and a split
    next-sample pointer (JAX ``upsampling_mm_scan``,
    ``UpsamplingMMClockRecovery.m``: ``nextSample += Error; nextSample +=
    stepSize``), then the Manchester decision.  half_raw is carried
    through unchanged.  Otherwise as
    :func:`upsampling_gardner_manchester_scan`."""
    B, dt = x.shape[0], x.dtype
    ns = g_state.next_sample.to(dt)
    f_man, i_man = _man_rows(m_state, dt)
    fstate = (ns[:, 0], ns[:, 1], g_state.prev_bit.to(dt)) + f_man
    p = scan_kernels.upsampling_params(step_size, err_limit, kp,
                                       resync_threshold)
    f, i, syms, times, valid, bits, emit, count = \
        scan_kernels.upsampling_mm_manchester_scan(
            tuple(s.contiguous() for s in fstate), i_man, x, t,
            _valid_lengths(n, B, x.device), p, max_syms)
    g = GardnerState(next_sample=torch.stack(f[:2], -1),
                     half_raw=g_state.half_raw, prev_bit=f[2])
    return (g, _man_state(f[3:], i), syms, times, valid, count, bits, times,
            emit)

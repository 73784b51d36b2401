"""Symbol timing: the Gardner step size, and Gardner timing with the
Manchester decision over windows of the interpolated stream.

Twins of ``project_desert_tortoise_tpu/ops/clock.py``: ``gardner_step_size``,
``GardnerState``, ``gardner_init`` and ``gardner_manchester_windowed``
(``clock.py:34-42, 151-263``).  The windowed recurrence runs in the kernel
``ops/kernels/scan_kernels.py::gardner_manchester`` on the card; on the
fused path it runs inside the fused kernel instead.
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


def gardner_step_size(fs: float, baud: float, dtype=np.float32) -> float:
    """stepSize = Fs/baud computed in double then stored in stream dtype,
    as the C mixed-precision expression does (GardenerClockRecovery.c:19)."""
    return float(np.dtype(dtype).type(np.float64(fs) / np.float64(baud)))


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
    f32, i32 = torch.float32, torch.int32
    fstate = tuple(s.to(f32) for s in (*g_state, m_state.cur, m_state.prev,
                                       m_state.prevprev))
    istate = (m_state.clockmod.to(i32), m_state.evenodd.to(i32))
    (ns, half_raw, prev_bit, cur, prev, prevprev), (clockmod, evenodd), \
        bits, btimes, emit = scan_kernels.gardner_manchester(
            fstate, istate, x, t, n.contiguous(), p, lay)
    return (GardnerState(ns, half_raw, prev_bit),
            man_ops.ManchesterState(clockmod=clockmod, evenodd=evenodd,
                                    cur=cur, prev=prev, prevprev=prevprev),
            bits, btimes, emit)

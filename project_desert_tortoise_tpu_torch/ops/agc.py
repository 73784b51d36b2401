"""Gain control: the static normalisation probe (and its closed form), the
running AGC, the complex AGC, the squelch and the envelope tracker.

Twins of ``project_desert_tortoise_tpu/ops/agc.py`` (``common/AGC.c``).
The AGC recurrence runs in the kernel ``ops/kernels/scan_kernels.py::
agc_scan`` on the card (and inside the chain kernels on the fused and
front paths); the squelch is elementwise.  ``static_gain_fast``,
``agc_complex_scan`` and ``find_signal_amplitude`` (JAX ``agc.py:39``,
``:101``, ``:121``) are plain torch: no code of either package calls them
on a path, and the two scans are per-sample loops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    AGC_MAX_GAIN, AGC_MIN_GAIN, AGC_REFERENCE)


def static_gain(iq: np.ndarray, desired_level: float, dtype=np.float32) -> float:
    """Normalization probe over the first chunk (``AGC.c:48-75``).

    Reproduces the reference's exponential halving recurrence exactly,
    including seeding with |z[0]| and then adding it again in the loop:
    ``avg = |z0|; for i: avg = (avg + |z_i|) / 2``.  Host-side numpy; this
    runs once per stream.
    """
    dt = np.dtype(dtype)
    mags = np.abs(iq).astype(dt)
    avg = mags[0] if len(mags) else dt.type(0)
    for m in mags:
        # C: avg = (avg + |z|) / 2.0 with a double intermediate
        avg = dt.type((np.float64(avg) + np.float64(m)) / 2.0)
    if avg == 0.0:
        # silent or empty input decodes nothing either way; unity gain keeps
        # inf out of the stream
        return 1.0
    return float(dt.type(np.float64(desired_level) / np.float64(avg)))


def static_gain_fast(iq, desired_level: float):
    """Closed form of :func:`static_gain` (JAX ``agc.py:39-56``): avg =
    |z0|*2^-n + sum_i |z_i| * 2^(i-n), over the trailing 64 samples (the
    only ones that can move the result), with exact power-of-two weights.
    JAX sums in float64 under its global x64 switch and in float32 without
    it; the port takes the precision of its input instead: float64 for a
    complex128 (or float64) `iq`, float32 for complex64.  iq: (..., n) a
    tensor or numpy array; returns the (...) gains, 1 where avg is 0."""
    mags = torch.abs(torch.as_tensor(iq))
    n = mags.shape[-1]
    k = min(n, 64)
    tail = mags[..., -k:]
    w = 2.0 ** torch.arange(-k, 0, dtype=tail.dtype, device=tail.device)
    avg = (tail * w).sum(-1)
    return torch.where(avg > 0, desired_level / torch.where(avg > 0, avg, 1.0),
                       torch.ones((), dtype=avg.dtype, device=avg.device))


class AGCState(NamedTuple):
    gain: torch.Tensor


def agc_init(initial_gain, batch_shape=(), *, device,
             dtype=torch.float32) -> AGCState:
    """The gain `initial_gain`, rounded to `dtype`, on each lane."""
    return AGCState(gain=torch.full(batch_shape, float(initial_gain),
                                    dtype=dtype, device=device))


def agc_scan(state: AGCState, x, attack_rate: float, decay_rate: float,
             reference: float = AGC_REFERENCE, max_gain: float = AGC_MAX_GAIN,
             min_gain: float = AGC_MIN_GAIN):
    """GNURadio-style attack/decay AGC (``AGC.c:78-132``) over the last
    axis of (B, n) `x`, float32 or float64.  Returns (state, y).

    JAX's ``window`` argument (VMEM-sized chunks of its scan) has no
    counterpart: the arithmetic does not depend on it.  CUDA tensors launch
    the kernel, CPU tensors run its plain version."""
    gain, y = scan_kernels.agc_scan(
        state.gain, x, scan_kernels.AGCParams(attack_rate, decay_rate,
                                              reference, max_gain, min_gain))
    return AGCState(gain=gain), y


def agc_complex_scan(gain, z, loop_gain: float, desired: float = 5.0):
    """First-order complex AGC (``AGC.c:164-200``, JAX ``agc.py:101-111``)
    over the last axis of complex `z` from the real gain(s) `gain`, in
    their dtype: y = z * g; g += loop_gain * (desired - g * |y|).  Returns
    (gain, y)."""
    gain = torch.as_tensor(gain)
    ys = []
    for zi in torch.as_tensor(z).unbind(-1):
        y = zi * gain
        error = desired - (gain * torch.abs(y))
        gain = gain + loop_gain * error
        ys.append(y)
    return gain, torch.stack(ys, -1)


def find_signal_amplitude(state, x, alpha: float):
    """One-pole envelope tracker (``AGC.c:6-20``, JAX ``agc.py:121-131``):
    avg = avg * (1 - alpha) + alpha * |x_i| over the last axis of `x`,
    alpha rounded to its dtype.  Returns the final avg."""
    x = torch.as_tensor(x)
    a = torch.tensor(alpha, dtype=x.dtype, device=x.device)
    avg = torch.as_tensor(state)
    for xi in x.unbind(-1):
        avg = avg * (1.0 - a) + a * torch.abs(xi)
    return avg


def squelch(x, squelch_stream, threshold: float):
    """Zero samples whose side channel (the PLL lock) is below threshold
    (``AGC.c:24-46``), the threshold rounded to the dtype of `x`."""
    thr = torch.tensor(threshold, dtype=x.dtype).item()
    return torch.where(squelch_stream < thr,
                       torch.zeros((), dtype=x.dtype, device=x.device), x)

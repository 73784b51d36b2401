"""Value-interpolating upsamplers for the upsampling clock-recovery
variants.

Twin of ``project_desert_tortoise_tpu/ops/resample.py``: the
``interp1(x, 1:1/L:numel(x), 'cubic'|'linear')`` upsampling inside
``UpsamplingGardenerClockRecovery2.m:7-10`` and
``UpsamplingMMClockRecovery.m``.  The sample values are interpolated with
a small fixed kernel (2-tap linear, or the 4-tap Keys cubic convolution
with a = -1/2) and clock recovery runs on the denser stream.

Every output phase ``p/L`` is a fixed-tap combination of shifted inputs,
so the upsample is L-wide elementwise work on whole tensors (stock torch
ops, no recurrence), accumulated in the JAX package's order so that the
CPU result is the same bit for bit.  Convention: ``out[j*L + p]``
interpolates input position ``j + p/L`` (``out[::L] == x``); edges
clamp-replicate.
"""

from __future__ import annotations

import numpy as np
import torch


def _phase_taps(level: int, kind: str):
    """(L, T) float64 tap matrix and the first tap's offset k0:
    out[j*L+p] = sum_k taps[p, k] * x[j + k + k0]."""
    f = np.arange(level) / level
    if kind == "linear":
        return np.stack([1.0 - f, f], axis=1), 0
    if kind == "cubic":
        # Keys cubic convolution, a = -0.5 (Catmull-Rom): taps over
        # x[j-1], x[j], x[j+1], x[j+2]
        a = -0.5
        t = f
        k_m1 = a * t ** 3 - 2 * a * t ** 2 + a * t
        k_0 = (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
        k_p1 = -(a + 2) * t ** 3 + (2 * a + 3) * t ** 2 - a * t
        k_p2 = -a * t ** 3 + a * t ** 2
        return np.stack([k_m1, k_0, k_p1, k_p2], axis=1), -1
    raise ValueError(f"unknown upsample kind: {kind!r}")


def upsample(x: torch.Tensor, level: int, kind: str = "cubic"):
    """Interpolate (..., n) -> (..., n*L) at positions j + p/L, in the
    dtype of `x`, the taps rounded to it.  The shifted inputs clamp to
    [0, n-1] (index tensors, as JAX's ``jnp.take``), and the phases
    accumulate tap by tap from zero (``resample.py:74-76``)."""
    if level == 1:
        return x
    taps, k0 = _phase_taps(level, kind)
    n = x.shape[-1]
    out = torch.zeros(tuple(x.shape[:-1]) + (n, level), dtype=x.dtype,
                      device=x.device)
    for k in range(taps.shape[1]):
        idx = torch.clamp(torch.arange(n, device=x.device) + (k + k0), 0,
                          n - 1)
        tap = torch.from_numpy(taps[:, k]).to(dtype=x.dtype,
                                              device=x.device)
        out = out + x.index_select(-1, idx)[..., :, None] * tap
    return out.reshape(tuple(x.shape[:-1]) + (n * level,))


def uniform_times(t: torch.Tensor, level: int, ts_over_l: float):
    """The rebuilt time axis of the upsampled stream,
    ``t_up[j*L + p] = t[j] + p * (Ts / L)`` in the dtype of `t` (the
    MATLAB scripts regenerate ``0:Ts:...`` rather than interpolating the
    input axis, UpsamplingGardenerClockRecovery2.m:16)."""
    if level == 1:
        return t
    p = (torch.arange(level, dtype=t.dtype, device=t.device)
         * torch.tensor(ts_over_l, dtype=t.dtype, device=t.device))
    out = t[..., :, None] + p
    return out.reshape(tuple(t.shape[:-1]) + (t.shape[-1] * level,))

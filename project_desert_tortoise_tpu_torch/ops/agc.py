"""Gain control: the static normalisation probe, the running AGC and the
squelch.

Twins of ``project_desert_tortoise_tpu/ops/agc.py`` (``common/AGC.c``).
The AGC recurrence runs in the kernel ``ops/kernels/scan_kernels.py::
agc_scan`` on the card (and inside the chain kernels on the fused and
front paths); the squelch is elementwise.
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


def squelch(x, squelch_stream, threshold: float):
    """Zero samples whose side channel (the PLL lock) is below threshold
    (``AGC.c:24-46``), the threshold rounded to the dtype of `x`."""
    thr = torch.tensor(threshold, dtype=x.dtype).item()
    return torch.where(squelch_stream < thr,
                       torch.zeros((), dtype=x.dtype, device=x.device), x)

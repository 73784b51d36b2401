"""Manchester decoder state and bit compaction.

Twins of ``project_desert_tortoise_tpu/ops/manchester.py``:
``ManchesterState``, ``manchester_init`` (``manchester.py:20-31``),
``compress_stream``, ``compress_sorted`` and ``compress_spaced``
(``manchester.py:77-135``).  The Manchester decision itself runs inside the
kernels (the fused kernel, and ``ops/kernels/scan_kernels.py``'s
``gardner_manchester`` and ``gardner_manchester_scan``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ManchesterState(NamedTuple):
    clockmod: torch.Tensor   # int32 0/1
    evenodd: torch.Tensor    # int32 0/1 (uchar counter mod 2)
    cur: torch.Tensor
    prev: torch.Tensor
    prevprev: torch.Tensor


def manchester_init(batch_shape=(), *, device,
                    dtype=torch.float32) -> ManchesterState:
    z = torch.zeros(batch_shape, dtype=dtype, device=device)
    zi = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    return ManchesterState(clockmod=zi, evenodd=zi, cur=z, prev=z, prevprev=z)


def compress_stream(values, times, mask, capacity: int):
    """Pack masked entries of the last axis to the front of fixed-capacity
    arrays, order-preserving, zeros past the count (a cumulative-sum
    scatter).  Returns (values (..., capacity), times, count)."""
    lead = tuple(mask.shape[:-1])
    idx = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    idx = torch.where(mask, idx, capacity)       # parked past the end
    out_v = torch.zeros(lead + (capacity + 1,), dtype=values.dtype,
                        device=values.device)
    out_t = torch.zeros(lead + (capacity + 1,), dtype=times.dtype,
                        device=times.device)
    idx = torch.clamp(idx, max=capacity)         # beyond capacity: dropped
    out_v.scatter_(-1, idx, values)
    out_t.scatter_(-1, idx, times)
    count = mask.sum(-1, dtype=torch.int32)
    return out_v[..., :capacity], out_t[..., :capacity], count


def compress_sorted(values, times, mask, capacity: int):
    """Pack masked entries of the last axis to the front of fixed-capacity
    arrays, order-preserving (a stable sort on the mask), zeros past the
    count.  Returns (values (..., capacity), times, count)."""
    n = values.shape[-1]
    key = (~mask).to(torch.int8)              # 0 = keep, sorted first
    _, order = torch.sort(key, dim=-1, stable=True)
    sv = torch.gather(values, -1, order)
    st = torch.gather(times, -1, order)
    count = mask.sum(-1, dtype=torch.int32)
    if n < capacity:
        pad = (0, capacity - n)
        sv = torch.nn.functional.pad(sv, pad)
        st = torch.nn.functional.pad(st, pad)
    else:
        sv, st = sv[..., :capacity], st[..., :capacity]
    live = torch.arange(capacity, device=values.device) < count[..., None]
    return (torch.where(live, sv, torch.zeros_like(sv)),
            torch.where(live, st, torch.zeros_like(st)),
            count)


def compress_spaced(values, times, mask, capacity: int, min_spacing: int = 4):
    """`compress_sorted` for sample-dense streams whose set entries are at
    least `min_spacing` apart (the fused kernel's output: bit emissions are
    >= ~6 input samples apart, ``GardenerClockRecovery.c:57``).  Each
    `min_spacing` chunk is reduced to one slot first, then the 1/P-size slot
    stream is sort-compacted."""
    p = min_spacing
    n = values.shape[-1]
    if n % p:
        raise ValueError(f"length {n} is not a multiple of {p}")
    lead = tuple(values.shape[:-1])
    m = mask.reshape(lead + (n // p, p))
    cm = m.any(-1)
    vv = values.to(times.dtype).reshape(lead + (n // p, p))
    cv = (vv * m).sum(-1)                 # at most one set entry per chunk
    ct = (times.reshape(lead + (n // p, p)) * m).sum(-1)
    out_v, out_t, count = compress_sorted(cv, ct, cm, capacity)
    return out_v.to(values.dtype), out_t, count

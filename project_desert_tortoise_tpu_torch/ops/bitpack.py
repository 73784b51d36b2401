"""Lossless bit-packing of int16 PCM planes for host-to-device staging.

Twin of ``project_desert_tortoise_tpu/ops/bitpack.py``.  The staged int16
planes are the WAV's PCM samples (``common/wave.c:117``), whose amplitude
rarely fills 16 bits (the golden clip peaks at 13 signed bits).  Packing
each sample to the file's true significant width ``w`` cuts upload bytes
by ``16/w`` with exact reconstruction: the unpacked int16 values are
bit-identical, so the frames are too.

Layout: groups of 32 samples -> ``w`` little-endian uint32 words a group
(32*w bits, no spill between groups).  Sample ``i`` of a group occupies
bits ``[i*w, (i+1)*w)`` of the group's words; a field may straddle one word
boundary.  :func:`pack_width` and :func:`pack` are the JAX package's numpy
code; :func:`unpack` is the device-side inverse in torch: 32 static
shift/mask column extractions over all groups, in int64 (torch's uint32
lacks shifts and bitwise operations on some backends).
"""

from __future__ import annotations

import numpy as np
import torch

GROUP = 32  # samples a packed group (one uint32 word a bit of width)


def pack_width(*planes) -> int:
    """Minimal signed bit width covering every sample of every plane."""
    m = 0
    for x in planes:
        if len(x):
            m = max(m, int(np.max(np.abs(np.asarray(x, np.int32)))))
    # value range [-2^(w-1), 2^(w-1)-1]; |x| <= 2^(w-1) needs w bits
    # (np.abs(int16 -32768) is handled in int32 above)
    w = int(m).bit_length() + 1
    return min(max(w, 2), 16)


def pack(x: np.ndarray, w: int) -> np.ndarray:
    """Pack int16/int32 samples (n,) -> (ceil(n/32), w) uint32.

    The caller guarantees every value fits ``w`` signed bits (use
    :func:`pack_width`).  The trailing partial group is zero-padded.
    """
    n = len(x)
    ng = -(-n // GROUP)
    v = np.zeros(ng * GROUP, np.uint32)
    # two's-complement field: offset to unsigned [0, 2^w)
    v[:n] = (np.asarray(x, np.int32) + (1 << (w - 1))).astype(np.uint32)
    v = v.reshape(ng, GROUP)
    out = np.zeros((ng, w), np.uint32)
    for i in range(GROUP):
        off = i * w
        j0, sh = off >> 5, off & 31
        out[:, j0] |= v[:, i] << np.uint32(sh)
        if sh + w > 32:
            out[:, j0 + 1] |= v[:, i] >> np.uint32(32 - sh)
    return out


def unpack(packed: torch.Tensor, w: int, n: int) -> torch.Tensor:
    """Exact inverse of :func:`pack` on the tensor's device (JAX
    ``unpack_jax``, ``bitpack.py:63-82``).

    packed: (ng, w) words as int32 (the uint32 bit patterns, e.g. a numpy
    ``pack`` result viewed as int32), uint32 or int64; returns (n,)
    int32 samples."""
    words = packed.to(torch.int64) & 0xFFFFFFFF
    mask = (1 << w) - 1
    cols = []
    for i in range(GROUP):
        off = i * w
        j0, sh = off >> 5, off & 31
        lo = words[:, j0] >> sh
        if sh + w > 32:
            lo = lo | (words[:, j0 + 1] << (32 - sh))
        cols.append(lo & mask)
    vals = torch.stack(cols, dim=1).reshape(-1)[:n]
    return (vals - (1 << (w - 1))).to(torch.int32)

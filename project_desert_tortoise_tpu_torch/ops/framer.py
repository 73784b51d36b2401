"""Sync-word framers and core-interval stitching.

Twins of ``project_desert_tortoise_tpu/ops/framer.py`` (reference per-app
``ByteSync.c``):

- ``Frame`` and ``StreamFramer`` (``framer.py:28-117``), line for line:
  the exact streaming framer of the exact chain, host-side numpy, one bit
  at a time (``POESTIPdemod/ByteSync.c:16``, ``ARGOSdemod/ByteSync.c:17``).
- ``FrameBatch``, ``frame_extract``, ``stitch_frames`` and the two
  correlations (``framer.py:120-290``): the fast path's data-parallel
  framer.  Match all sync positions of a bit block at once, greedily
  suppress syncs inside a frame being shifted, pre-pack byte values with
  two small correlations and gather one value per output byte; then keep
  the frames whose sync time falls inside their block's core interval and
  sort them into stream order.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Frame:
    time: float
    inverted: bool
    data: np.ndarray          # uint8 payload including prefix bytes
    complete: bool = True
    quality_db: float = None  # PLL quality at emission (optional annotation)
    snr_db: float = None      # M2M4 SNR at emission (closes README.md:42 TODO)
    carrier_hz: float = None  # PLL carrier offset at emission (Doppler track)

    def hex_line(self, time_decimals: int = 5,
                 with_quality: bool = False, inverted_mark: bool = True) -> str:
        ts = f"{self.time:.{time_decimals}f}"
        if self.inverted and inverted_mark:
            ts += "i"
        body = " ".join(f"{b:02X}" for b in self.data)
        line = f"{ts} {body}"
        if with_quality and self.quality_db is not None:
            line += f" | q={self.quality_db:.1f}dB snr={self.snr_db:.1f}dB"
            if self.carrier_hz is not None:
                line += f" f={self.carrier_hz:+.1f}Hz"
        return line


class StreamFramer:
    """Exact streaming framer; one instance per channel."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.sync = cfg.sync_bits()          # uint8 0/1
        self.n_sync = len(self.sync)
        self.history = np.zeros(self.n_sync, np.uint8)  # memset '0' equivalent
        self.shifting = False
        self.inverted = False
        self.bit_idx = 0
        self.byte = 0
        self.frame: List[int] = []
        self.frame_time = 0.0
        self.frames: List[Frame] = []

    def process(self, bits: np.ndarray, times: np.ndarray) -> List[Frame]:
        """Consume a chunk of bits (uint8 0/1) with per-bit times; returns
        frames completed or started during this chunk (completed ones only)."""
        cfg = self.cfg
        done_before = len(self.frames)
        for i in range(len(bits)):
            b = int(bits[i])
            if self.shifting:
                eff = (1 - b) if self.inverted else b
                self.byte = ((self.byte << 1) | eff) & 0xFF
                self.bit_idx += 1
                if self.bit_idx > 7:
                    self.frame.append(self.byte)
                    self.byte = 0
                    self.bit_idx = 0
                    if len(self.frame) >= cfg.frame_bytes - cfg.data_start_byte + len(cfg.prefix_bytes):
                        self._finish(complete=True)

            self.history = np.roll(self.history, -1)
            self.history[-1] = b

            if not self.shifting:
                if np.array_equal(self.history, self.sync):
                    self._start(float(times[i]), inverted=False)
                elif cfg.detect_inverted and np.array_equal(self.history, 1 - self.sync):
                    self._start(float(times[i]), inverted=True)
        return self.frames[done_before:]

    def _start(self, t: float, inverted: bool):
        cfg = self.cfg
        self.shifting = True
        self.inverted = inverted
        self.frame_time = t
        self.frame = list(cfg.prefix_bytes)
        self.byte = 0
        self.bit_idx = cfg.first_bit_index

    def _finish(self, complete: bool):
        self.frames.append(Frame(self.frame_time, self.inverted,
                                 np.array(self.frame, np.uint8), complete))
        self.shifting = False
        self.frame = []

    def flush(self) -> Optional[Frame]:
        """At end of stream: surface a partial frame, if any (the reference
        leaves it as an unterminated output line)."""
        if self.shifting and self.frame:
            self._finish(complete=False)
            return self.frames[-1]
        return None


class FrameBatch(NamedTuple):
    """Fixed-capacity frame output of the data-parallel framer."""
    times: torch.Tensor      # (..., cap)
    inverted: torch.Tensor   # (..., cap) bool
    data: torch.Tensor       # (..., cap, frame_bytes_out) uint8
    count: torch.Tensor      # (...,)


def frame_extract(bits, times, n_bits, cfg, max_frames: int) -> FrameBatch:
    """Data-parallel frame extraction over a bit block.

    bits: (..., nb) uint8 0/1; times: (..., nb); n_bits: (...,) valid count.
    Frames whose payload would run past n_bits are dropped (the block-parallel
    path gives every block a tail halo so real frames never do).
    """
    dev = bits.device
    n_sync = len(cfg.sync_word)
    payload = cfg.payload_bits
    nb = bits.shape[-1]
    lead = tuple(bits.shape[:-1])
    n_valid = n_bits[..., None]

    bipolar = bits.to(torch.int32) * 2 - 1
    pat = cfg.sync_bits().astype(np.int32) * 2 - 1
    # correlation: windows ending at i; position i = last sync bit
    corr = _corr_last(bipolar, pat)
    pos_ids = torch.arange(nb, device=dev).expand(lead + (nb,))
    in_range = (pos_ids >= n_sync - 1) & (pos_ids < n_valid)
    match_n = (corr == n_sync) & in_range
    match_i = ((corr == -n_sync) & in_range if cfg.detect_inverted
               else torch.zeros_like(match_n))
    match = match_n | match_i

    # Greedy suppression: a sync inside a shifting frame is ignored.  With
    # windows of the suppression span (payload bits) an accepted sync
    # suppresses the rest of its own window, so each window accepts at most
    # the first match at or past the carried re-arm position.
    nw = -(-nb // payload)
    m_w = F.pad(match, (0, nw * payload - nb)).reshape(lead + (nw, payload))
    rel = torch.arange(payload, device=dev)
    carry_end = torch.zeros(lead, dtype=torch.int64, device=dev)
    accepted = []
    for w in range(nw):
        base = w * payload
        ok_row = m_w[..., w, :] & (base + rel >= carry_end[..., None])
        has = ok_row.any(-1)
        first_rel = torch.argmax(ok_row.to(torch.int8), dim=-1)
        accepted.append(ok_row & (rel == first_rel[..., None]))
        carry_end = torch.where(has, base + first_rel + payload, carry_end)
    accepted = torch.stack(accepted, -2).reshape(lead + (nw * payload,))
    # complete frames only: payload must fit in the valid region
    accepted = accepted[..., :nb] & (pos_ids + payload < n_valid)

    # the first max_frames accepted positions per lane, in position order
    big = nb + 1
    keyed = torch.where(accepted, -pos_ids, -big)
    topv, topi = torch.topk(keyed, max_frames, dim=-1)
    got = topv != -big
    sync_pos = torch.where(got, -topv, 0)
    inv = torch.gather(match_i, -1, torch.where(got, topi, 0)) & got
    count = accepted.sum(-1, dtype=torch.int32)

    f_times = torch.gather(times, -1, sync_pos)

    # byteval[i] = sum_b bits[i+b] * 2^(7-b); firstval likewise over the
    # first byte's remaining bits; an inverted frame's complemented bits
    # become (2^w - 1) - value
    first_bits = 8 - cfg.first_bit_index
    n_data = cfg.frame_bytes - cfg.data_start_byte
    byteval = _corr_first(bits, 2 ** np.arange(7, -1, -1))
    firstval = _corr_first(bits, 2 ** np.arange(first_bits - 1, -1, -1))

    start = sync_pos + 1                                   # first payload bit
    first = torch.gather(firstval, -1, torch.clamp(start, 0, nb - 1))
    first = torch.where(inv, (2 ** first_bits - 1) - first, first)
    bidx = (start[..., None] + first_bits
            + 8 * torch.arange(n_data - 1, device=dev))   # (..., F, n_data-1)
    rest = torch.gather(
        byteval, -1, torch.clamp(bidx, 0, nb - 1).reshape(lead + (-1,))
    ).reshape(bidx.shape)
    rest = torch.where(inv[..., None], 255 - rest, rest)

    parts = [first[..., None].to(torch.uint8), rest.to(torch.uint8)]
    if cfg.prefix_bytes:
        parts.insert(0, torch.tensor(cfg.prefix_bytes, dtype=torch.uint8,
                                     device=dev).expand(
            tuple(first.shape) + (len(cfg.prefix_bytes),)))
    data = torch.cat(parts, -1)
    return FrameBatch(times=f_times, inverted=inv, data=data, count=count)


def stitch_frames(fb: FrameBatch, bounds, cap: int, chan=None):
    """Keep frames whose sync time falls inside their block's core interval
    ``[bounds[b,0], bounds[b,1])`` (exact and dedup-free: cores tile the
    recording and sync times are values of the shared time axis) and pack
    the survivors of all blocks into one time-sorted array.

    fb: times/inverted (B, F), data (B, F, nbytes), count (B,); bounds
    (B, 2).  Returns (times (cap,), inverted (cap,), data (cap, nbytes), n)
    with the first ``n`` entries valid, in stream order.  When ``chan``
    (B,) channel ids are given the batch may mix channels: the sort is by
    (channel, time), two stable sorts where JAX has ``lexsort``, and a
    fifth array of per-frame channel ids is returned.
    """
    times = fb.times
    B, nf = times.shape
    valid = torch.arange(nf, device=times.device)[None, :] < fb.count[:, None]
    b = bounds.to(times.dtype)
    keep = valid & (times >= b[:, :1]) & (times < b[:, 1:2])
    tflat = torch.where(keep, times, torch.inf).reshape(-1)
    order = torch.argsort(tflat, stable=True)
    if chan is not None:
        cflat = chan.to(torch.int32)[:, None].expand(B, nf).reshape(-1)
        cflat = torch.where(keep.reshape(-1), cflat,
                            torch.iinfo(torch.int32).max)
        order = order[torch.argsort(cflat[order], stable=True)]
    order = order[:cap]
    n = torch.clamp(keep.sum(), max=cap)
    data = fb.data.reshape((B * nf,) + tuple(fb.data.shape[2:]))
    out = (tflat[order], fb.inverted.reshape(-1)[order], data[order], n)
    if chan is not None:
        out = out + (cflat[order],)
    return out


def _shifted_sum(x, weights, pad):
    """sum_k weights[k] * xp[..., i + k] over the zero-padded input, in
    int32: the weights and inputs are small integers, so this is the exact
    value the JAX package's float convolution rounds to."""
    p = len(weights)
    n = x.shape[-1]
    xp = F.pad(x.to(torch.int32), pad)
    out = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for k in range(p):
        out = out + int(weights[k]) * xp[..., k:k + n]
    return out


def _corr_first(x, weights):
    """out[i] = sum_k weights[k] * x[i + k]: window STARTING at i
    (zero-padded past the end).  Returns int32."""
    return _shifted_sum(x, weights, (0, len(weights) - 1))


def _corr_last(bipolar, pat):
    """corr[i] = sum_k pat[k] * x[i - (P-1) + k]: window ENDING at i."""
    return _shifted_sum(bipolar, pat, (len(pat) - 1, 0))

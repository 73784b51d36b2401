"""Batched multi-channel streaming serving on one card.

Twin of ``project_desert_tortoise_tpu/parallel/serving.py``.  The
reference realtime apps are one process per channel, one sample at a time
(``POESTIPdemodPortAudio/main.c:324-401``).  Here each channel's live
stream accumulates in a host buffer, and whenever enough samples exist to
cut finished blocks (core + relock halos, see ``parallel/blocked.py``),
the blocks of ALL channels are batched into one launch of the same demod
path the offline fast mode uses (any of the three branches of
``demod_blocks``), with channel-aware stitching on sample positions.

Latency model: a block covering core interval [k*core, (k+1)*core) is cut
once (k+1)*core + tail samples have arrived, so end-to-end latency is
bounded by core + tail samples (~2.5 s at the POES default plan) plus the
batching wait (``pump`` dispatches whatever is ready; it never waits for a
full batch).

Parity contract: the same frames as ``blocked.demodulate_many`` over the
same recordings (lanes are independent, so how blocks share batches does
not change them).

Differences from the JAX package, none of them visible in the frames:
- frames are stitched on exact sample positions and labelled with the
  channel's float32 accumulated time axis afterwards (as the port's
  offline path does, ROADMAP fault (f));
- the fused branch always generates its positions in the kernel, at any
  lane count; ``pad_batches`` only fixes the batch shape, and both of its
  settings give the same frames;
- a channel's history lives in buffers that are appended to and never
  rewritten: trimming moves an offset and a full buffer is replaced by a
  new one, so the views a staged batch holds (its samples, and the time
  axis that labels its frames when it is collected one pump later) stay
  valid without a copy.  Producers only touch host buffers under the
  lock; ``pump`` alone touches the device, and collecting batch k-1 after
  dispatching batch k is its only wait on the device.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from project_desert_tortoise_tpu_torch import chain as chain_lib
from project_desert_tortoise_tpu_torch.ops import agc as agc_ops
from project_desert_tortoise_tpu_torch.ops.framer import Frame
from project_desert_tortoise_tpu_torch.ops.kernels.common import (
    resolve_device)
from project_desert_tortoise_tpu_torch.parallel import blocked as BL

_MIN_CAPACITY = 1 << 16


class _Channel:
    """Per-channel sample/time history between pumps.

    Buffer slots [start, end) hold samples base .. count-1; the time buffer
    holds one entry more (t_ext[i] = the reference accumulated float32 time
    of sample base + i, up to the sample a next push would bring)."""

    def __init__(self, ts, dt, sdt):
        self._re = np.zeros(_MIN_CAPACITY, sdt)
        self._im = np.zeros(_MIN_CAPACITY, sdt)
        self._t = np.zeros(_MIN_CAPACITY + 1, dt)
        self._t[0] = ts
        self.start = 0
        self.end = 0
        self.base = 0          # absolute index of re[0]
        self.next_block = 0    # next core index to emit
        self.ended = False
        self.count = 0         # absolute samples received

    @property
    def re(self) -> np.ndarray:
        return self._re[self.start:self.end]

    @property
    def im(self) -> np.ndarray:
        return self._im[self.start:self.end]

    @property
    def t_ext(self) -> np.ndarray:
        return self._t[self.start:self.end + 1]

    def append(self, re, im, ext):
        n = len(re)
        if self.end + n > len(self._re):
            # a new buffer, never a move in place: staged views stay valid
            keep = self.end - self.start
            cap = max(2 * (keep + n), _MIN_CAPACITY)
            new = [np.empty(cap, self._re.dtype),
                   np.empty(cap, self._im.dtype),
                   np.empty(cap + 1, self._t.dtype)]
            new[0][:keep], new[1][:keep] = self.re, self.im
            new[2][:keep + 1] = self.t_ext
            self._re, self._im, self._t = new
            self.start, self.end = 0, keep
        self._re[self.end:self.end + n] = re
        self._im[self.end:self.end + n] = im
        self._t[self.end + 1:self.end + 1 + n] = ext
        self.end += n
        self.count += n

    def drop(self, n: int):
        self.start += n
        self.base += n

    def times(self):
        """(time buffer, offset): the time of absolute sample p is
        buffer[p - offset] for as long as the buffer is referenced."""
        return self._t, self.base - self.start


class ChannelBank:
    """Multi-channel streaming demodulator with batched launches on
    `device` (a CUDA device runs the kernels, the CPU their plain
    versions).

    push() is thread-safe per channel; pump() runs the device work and
    distributes frames (call it from one consumer thread / event loop).
    """

    def __init__(self, mode_cfg, fs: float, n_channels: int,
                 plan: Optional[BL.BlockPlan] = None,
                 batch_blocks: int = 128,
                 window: int = 4096, use_pallas=False,
                 norm_factor: Optional[float] = None,
                 on_frame: Optional[Callable[[int, Frame], None]] = None,
                 pad_batches: bool = True, stage_dtype=None, *,
                 device="cuda"):
        self.cfg = mode_cfg
        self.fs = float(fs)
        self.device = resolve_device(device)
        self.dt = np.dtype(np.float32)      # the port's fast path runs f32
        # stage_dtype=np.int16: bank and stage raw PCM planes, converted on
        # the device with the exact /32768 of wave.c:117 (half the staged
        # bytes); frame-identical to float staging for PCM-sourced streams
        self.sdt = np.dtype(stage_dtype or self.dt)
        if self.sdt not in (np.dtype(np.int16), self.dt):
            raise ValueError(f"stage_dtype must be int16 or {self.dt}")
        self.params = chain_lib.make_params(mode_cfg, fs)
        self.plan = plan or BL.default_plan(mode_cfg, fs)
        self.batch_blocks = batch_blocks
        # pad partial batches to batch_blocks silent rows (empty core
        # bounds: nothing survives stitching), so every launch has one shape
        self.pad_batches = pad_batches
        self.window = window
        self.use_pallas = BL.branch(use_pallas)
        self.on_frame = on_frame
        self.norm = norm_factor
        self._ts = self.dt.type(1.0) / self.dt.type(fs)
        self._lock = threading.Lock()
        self.channels = [_Channel(self._ts, self.dt, self.sdt)
                         for _ in range(n_channels)]
        self.frames: List[List[Frame]] = [[] for _ in range(n_channels)]
        self._pending = None   # in-flight stitched batch (double buffering)
        # counters: blocks and batches dispatched, and each batch's host
        # milliseconds from its dispatch to the end of its collection
        self.blocks = 0
        self.batches = 0
        self.batch_ms: List[float] = []

    # ---------------- producers ----------------

    def _to_stage(self, x):
        x = np.asarray(x)
        if x.dtype == self.sdt:
            return x
        if self.sdt == np.int16:
            # exact for PCM-derived floats (x = int16/32768); quantizes
            # anything else -- push int16 directly for non-PCM sources
            return np.clip(np.round(np.asarray(x, np.float64) * 32768.0),
                           -32768, 32767).astype(np.int16)
        return x.astype(self.sdt) if x.dtype != np.int16 else \
            x.astype(self.sdt) / self.sdt.type(32768)

    def _chunk_iq(self, c: _Channel, n: int):
        """Float iq view of a channel's first n banked samples (norm probe)."""
        re, im = c.re[:n], c.im[:n]
        if self.sdt == np.int16:
            s = self.dt.type(1.0) / self.dt.type(32768)
            return re.astype(self.dt) * s + 1j * (im.astype(self.dt) * s)
        return re + 1j * im

    def _probe(self, c: _Channel, n: int):
        self.norm = agc_ops.static_gain(self._chunk_iq(c, n),
                                        self.cfg.static_gain_level, self.dt)

    def push(self, ch: int, re, im):
        """Append samples to a channel (producer side).  int16 input is
        banked raw when stage_dtype=int16 (the zero-copy PCM path)."""
        c = self.channels[ch]
        re = self._to_stage(re)
        im = self._to_stage(im)
        n = len(re)
        if n == 0:
            return
        with self._lock:
            # continue the accumulated f32 timebase: t_ext already holds
            # the time of the first new sample; extend by n more steps
            steps = np.full(n, self._ts, self.dt)
            steps[0] = c.t_ext[-1] + self._ts
            c.append(re, im, np.add.accumulate(steps, dtype=self.dt))
            if self.norm is None and ch == 0 and \
                    c.count >= self.cfg.chunk_size:
                # the probe demodulate_many uses: channel 0's first chunk
                # (pump() holds dispatch until it has run)
                self._probe(c, self.cfg.chunk_size)

    def end_of_stream(self, ch: int):
        self.channels[ch].ended = True

    # ---------------- consumer ----------------

    def _ready_blocks(self, c: _Channel):
        """Core indices whose [lo-head, lo+core+tail) window is complete
        (or the stream ended)."""
        out = []
        b = c.next_block
        while True:
            need = (b + 1) * self.plan.core + self.plan.tail
            if c.count >= need or (c.ended and c.count > b * self.plan.core):
                out.append(b)
                b += 1
            else:
                break
        return out

    def _rows(self, items):
        """Under the lock: each (channel, block)'s views of its samples,
        where they go in its row, its first sample's index and its stream
        length; and each channel's time axis as it stands."""
        P = self.plan
        rows, times = [], {}
        for ci, b in items:
            c = self.channels[ci]
            lo = b * P.core - P.head            # absolute
            src_lo = max(lo, c.base)
            src_hi = min(lo + P.total, c.count)
            s0 = src_lo - c.base + c.start      # buffer slots
            s1 = src_hi - c.base + c.start
            rows.append((ci, lo, c.count, src_lo - lo,
                         c._re[s0:s1], c._im[s0:s1]))
            times.setdefault(ci, c.times())
        return rows, times

    def _stage(self, rows):
        """Host planes of a batch, padded to batch_blocks silent rows, and
        its (3, rows) lo, stream length and channel (pad rows: lo 0,
        length 0, an empty core); pinned for a CUDA device, so that their
        copies do not wait for the device."""
        bn = (self.batch_blocks if self.pad_batches
              and len(rows) < self.batch_blocks else len(rows))
        tdt = torch.int16 if self.sdt == np.int16 else torch.float32
        pin = self.device.type == "cuda"
        planes = [torch.zeros((bn, self.plan.total), dtype=tdt,
                              pin_memory=pin) for _ in range(2)]
        meta = torch.zeros((3, bn), dtype=torch.int64, pin_memory=pin)
        brs, bis = (p.numpy() for p in planes)
        lo, n, chan = meta.numpy()
        for k, (ci, lo_k, n_k, d0, re, im) in enumerate(rows):
            brs[k, d0:d0 + len(re)] = re
            bis[k, d0:d0 + len(im)] = im
            lo[k], n[k], chan[k] = lo_k, n_k, ci
        return planes, meta

    def pump(self) -> int:
        """Stage + demodulate every ready block (in batch_blocks batches).

        Returns the number of blocks processed.  Call repeatedly from the
        serving loop; cheap when nothing is ready.  Double-buffered: the
        newest dispatched batch stays in flight (device tensors, not
        fetched) until the next dispatch or pump, so host staging of the
        following batch overlaps device compute of this one; a no-work
        pump (and drain()'s final iteration) flushes it."""
        with self._lock:
            if self.norm is None:
                # hold blocks queued until the norm probe has run (push()
                # probes channel 0's first chunk, the demodulate_many
                # parity contract; drain() probes at EOS).  Backstop: if
                # channel 0 stays silent (dead antenna) while another
                # channel has banked several blocks of samples, probe from
                # the first full channel instead of growing history
                # without bound.
                backlog = max((len(c.re) for c in self.channels),
                              default=0)
                if backlog > self.plan.total + 8 * self.plan.core:
                    for c in self.channels:
                        if c.count >= self.cfg.chunk_size:
                            self._probe(c, self.cfg.chunk_size)
                            break
            if self.norm is None:
                work = []
            else:
                work = [(ci, b) for ci, c in enumerate(self.channels)
                        for b in self._ready_blocks(c)]
            for ci, b in work:
                self.channels[ci].next_block = \
                    max(self.channels[ci].next_block, b + 1)
            batches = [self._rows(work[w0:w0 + self.batch_blocks])
                       for w0 in range(0, len(work), self.batch_blocks)]
            self._trim()
        for rows, times in batches:
            st = self._dispatch(self._stage(rows), times)
            self.blocks += len(rows)
            if self._pending is not None:
                self._collect(self._pending)
            self._pending = st
        if not batches and self._pending is not None:
            self._collect(self._pending)
            self._pending = None
        return len(work)

    def _dispatch(self, staged, times):
        """Copy a staged batch to the device and launch the demod; returns
        the un-fetched outputs with what labels them."""
        t0 = time.perf_counter()
        planes, meta = staged
        dev = self.device
        zre, zim = (p.to(dev, non_blocking=True) for p in planes)
        lo_d, n_d, chan_d = meta.to(dev, non_blocking=True)
        fest = BL.coarse_carrier_est(zre, zim, self.fs,
                                     self.cfg.gardner.baud / 2.0)
        stitched = BL.demod_frames(
            self.params, self.plan, self.cfg.framer, self.fs, zre, zim,
            lo_d, n_d, fest, float(self.norm), self.window, self.use_pallas,
            chan_d)
        self.batches += 1
        return stitched, times, t0

    def _collect(self, pending):
        stitched, times, t0 = pending

        def label(ci, p):
            buf, off = times[ci]
            return buf[p - off]
        for ci, _, fr in BL.fetch_channel_frames(stitched, label):
            self.frames[ci].append(fr)
            if self.on_frame:
                self.on_frame(ci, fr)
        self.batch_ms.append((time.perf_counter() - t0) * 1e3)

    def _trim(self):
        """Drop history no future block can touch (bounded memory)."""
        for c in self.channels:
            keep_from = c.next_block * self.plan.core - self.plan.head
            drop = keep_from - c.base
            if drop >= self.plan.core:        # JAX's step (it copies)
                c.drop(drop)

    def drain(self) -> int:
        """End-of-stream: process every remaining partial block."""
        for c in self.channels:
            c.ended = True
        if self.norm is None:
            # EOS with no channel ever filling a chunk: probe the first
            # channel that has any samples (pump() holds work until a norm
            # exists, so this must not stay None when there is data)
            for c in self.channels:
                n = min(len(c.re), self.cfg.chunk_size)
                if n:
                    self._probe(c, n)
                    break
        total = 0
        while True:
            n = self.pump()
            total += n
            if n == 0:
                return total

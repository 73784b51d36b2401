"""Streaming (realtime-analogue) demodulation sessions.

Twin of ``project_desert_tortoise_tpu/models/streaming.py`` and of the
reference PortAudio apps (``POESTIPdemodPortAudio/main.c``,
``ARGOSdemodPortAudio/main.c``): a producer thread feeds IQ into the
port's native lock-free ring (the PortAudio-callback analogue,
``native/wavio.cpp``); the consumer loop pulls chunks, advances the chain
on its device, and emits frames and console telemetry until stopped (the
``kbhit()`` analogue is a `stop()` event).  Overruns are tolerated and
counted (``POESTIPdemodPortAudio/main.c:327-331``).

Sources provided: live ring push (external producer), file-follow (tail a
growing RAW file, SDR# "RAW output" workflow, ``main.c:164-165``), and
replay (throttled playback of a recording for soak tests).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from project_desert_tortoise_tpu_torch.models.demodulator import DemodSession
from project_desert_tortoise_tpu_torch.ops.framer import Frame
from project_desert_tortoise_tpu_torch.utils import metrics

# JAX's defaults: the rings' capacities in samples, and the fast
# streamer's bank (16-block batches, the scan branch, 4,096-sample Gardner
# windows) and its pops of at most 8,192 samples
EXACT_RING_CAPACITY = 1 << 18
FAST_RING_CAPACITY = 1 << 20
FAST_BATCH_BLOCKS = 16
FAST_WINDOW = 4096
FAST_GRANULE = 8192


def _default_ring(ring, capacity: int):
    if ring is not None:
        return ring
    from project_desert_tortoise_tpu_torch.native.wavio import IQRing
    return IQRing(capacity)


class StreamingDemodulator:
    """Pull chunks from an IQ ring and demodulate them continuously with
    the exact chain (``DemodSession``, quirks off) on `device`."""

    def __init__(self, mode_cfg, fs: float, ring=None,
                 chunk_size: Optional[int] = None,
                 norm_factor: Optional[float] = None,
                 on_frame: Optional[Callable[[Frame], None]] = None, *,
                 device="cuda"):
        self.session = DemodSession(mode_cfg, fs, chunk_size=chunk_size,
                                    norm_factor=norm_factor, quirks=False,
                                    device=device)
        self.ring = _default_ring(ring, EXACT_RING_CAPACITY)
        self.fs = float(fs)
        self.chunk = self.session.chunk_size
        self.on_frame = on_frame
        self.frames: List[Frame] = []
        self._stop = threading.Event()
        self._sample_pos = 0
        self._dt = mode_cfg.np_dtype()
        self._ts = self._dt.type(1.0) / self._dt.type(fs)
        self._t_last = self._dt.type(0.0)

    def stop(self):
        self._stop.set()

    @property
    def overruns(self) -> int:
        return getattr(self.ring, "overruns", 0)

    def _times_for(self, n: int):
        # continue the reference's accumulated f32 timebase across chunks
        steps = np.full(n + 1, self._ts, self._dt)
        steps[0] = self._t_last + self._ts
        acc = np.add.accumulate(steps, dtype=self._dt)
        t = acc[:n]
        t_next = acc[1:n + 1]
        self._t_last = t[-1] if n else self._t_last
        return t, t_next

    def _emit(self, f: Frame):
        self.frames.append(f)
        if self.on_frame:
            self.on_frame(f)

    def run(self, poll_s: float = 0.02, max_chunks: Optional[int] = None):
        """Consume until stop() (or max_chunks); returns completed frames."""
        done = 0
        while True:
            if max_chunks is not None and done >= max_chunks:
                break
            if self.ring.available < self.chunk:
                # drain-then-stop: honor stop() once less than a chunk is
                # left (as in JAX, a last partial chunk is not processed)
                if self._stop.is_set():
                    break
                time.sleep(poll_s)
                continue
            re, im = self.ring.pop(self.chunk)
            iq = re.astype(self._dt) + 1j * im.astype(self._dt)
            t, t_next = self._times_for(len(re))
            for f in self.session.process(iq, t, t_next):
                self._emit(f)
            self._sample_pos += len(re)
            done += 1
        tail = self.session.framer.flush()
        if tail is not None:
            self._emit(tail)
        return self.frames

    def status_line(self, color=False) -> str:
        q = metrics.quality_db(self.session.avg_phase)
        return metrics.progress_line(
            0.0, self._sample_pos / 1000.0,
            float(self._t_last), self.session.total_symbols,
            self.session.total_bits, len(self.frames), q, color)


class FastStreamingDemodulator:
    """Ring-fed streaming demodulation through the block-parallel path.

    Same surface as :class:`StreamingDemodulator` (``ring`` / ``run`` /
    ``stop`` / ``frames`` / ``status_line``), backed by a one-channel
    :class:`~project_desert_tortoise_tpu_torch.parallel.serving.ChannelBank`
    with JAX's defaults (16-block batches, the scan branch, 4,096-sample
    Gardner windows, 8,192-sample pops).  Frames for core interval k come
    once (k+1)*core + tail samples have arrived, so output trails the
    stream by up to core + tail samples; the frames are those of
    ``demodulate_many`` over the same samples.
    """

    def __init__(self, mode_cfg, fs: float, ring=None,
                 norm_factor: Optional[float] = None,
                 on_frame: Optional[Callable[[Frame], None]] = None,
                 plan=None, *, device="cuda"):
        from project_desert_tortoise_tpu_torch.parallel.serving import (
            ChannelBank)
        self.bank = ChannelBank(
            mode_cfg, fs, 1, plan=plan, batch_blocks=FAST_BATCH_BLOCKS,
            window=FAST_WINDOW, use_pallas=False, norm_factor=norm_factor,
            on_frame=self._collect, device=device)
        self.ring = _default_ring(ring, FAST_RING_CAPACITY)
        self.fs = float(fs)
        self.frames: List[Frame] = []
        self._user_on_frame = on_frame
        self._stop = threading.Event()
        self._sample_pos = 0

    def _collect(self, ci: int, f: Frame):
        self.frames.append(f)
        if self._user_on_frame:
            self._user_on_frame(f)

    def stop(self):
        self._stop.set()

    @property
    def overruns(self) -> int:
        return getattr(self.ring, "overruns", 0)

    def run(self, poll_s: float = 0.02):
        """Consume until stop(); drains the ring, then the bank."""
        while True:
            n = min(self.ring.available, FAST_GRANULE)
            if n == 0:
                if self._stop.is_set():
                    break
                time.sleep(poll_s)
                continue
            re, im = self.ring.pop(n)
            self.bank.push(0, re, im)
            self._sample_pos += n
            self.bank.pump()
        self.bank.end_of_stream(0)
        self.bank.drain()
        return self.frames

    def status_line(self, color=False) -> str:
        # symbol and bit counters stay on the device in the fast path;
        # report the stream position and frame count
        return metrics.progress_line(
            0.0, self._sample_pos / 1000.0, self._sample_pos / self.fs,
            0, 0, len(self.frames), float("nan"), color)


def feed_array(ring, iq: np.ndarray, chunk: int = 4096,
               realtime_fs: Optional[float] = None, stop=None):
    """Producer helper: push a recording into the ring, optionally throttled
    to real time (soak/replay source)."""
    re = np.ascontiguousarray(np.real(iq), np.float32)
    im = np.ascontiguousarray(np.imag(iq), np.float32)
    for lo in range(0, len(re), chunk):
        if stop is not None and stop.is_set():
            return
        hi = min(lo + chunk, len(re))
        ring.push(re[lo:hi], im[lo:hi])
        if realtime_fs:
            time.sleep((hi - lo) / realtime_fs)


def follow_raw_file(ring, path: str, stop, poll_s: float = 0.05,
                    chunk_frames: int = 8192):
    """Producer: tail a growing SDR# RAW file (interleaved f32 IQ) into the
    ring, the zero-audio-loopback version of the reference's soundcard
    workflow.  Returns once `stop` is set."""
    pos = 0
    frame_bytes = 8
    while not stop.is_set():
        try:
            size = max(0, (os.path.getsize(path) - pos) // frame_bytes)
        except OSError:
            time.sleep(poll_s)
            continue
        if size == 0:
            time.sleep(poll_s)
            continue
        n = min(size, chunk_frames)
        data = np.fromfile(path, "<f4", count=2 * n, offset=pos)
        if len(data) < 2:
            time.sleep(poll_s)
            continue
        n = len(data) // 2
        ring.push(data[0::2][:n], data[1::2][:n])
        pos += n * frame_bytes

"""Exact chunked demodulator sessions: the reference app drivers, on the card.

Twin of ``project_desert_tortoise_tpu/models/demodulator.py``.
`DemodSession` is the behavioural twin of one reference application's
``while(!feof)`` loop (``POESTIPdemod/main.c:373``, ``ARGOSdemod/main.c:250``):
feed it chunks of IQ samples and it advances the chain one chunk at a time
on its device (``chain.chunk_step``: the PLL, AGC and Gardner/Manchester
kernels at one lane), copies the chunk's bits, bit times and the few
scalars it reads to the host in one transfer, runs the exact host-side
framer on the emitted bits, and tracks the reference's console telemetry
(quality, lock events, sym/bit/frame counters).

Each mode runs in its dtype: the float32 modes (``poes_tip``,
``poes_tip_realtime``, ``argos_realtime``) on the float32 kernels, the
float64 ``argos`` mode on their double instances, as JAX runs it under
x64.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from project_desert_tortoise_tpu_torch import chain as chain_lib
from project_desert_tortoise_tpu_torch.ops import agc as agc_ops
from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.ops.framer import Frame, StreamFramer
from project_desert_tortoise_tpu_torch.ops.kernels.common import (
    resolve_device)
from project_desert_tortoise_tpu_torch.utils import metrics
from project_desert_tortoise_tpu_torch.utils import wav as wav_lib


@dataclasses.dataclass
class DemodResult:
    frames: List[Frame]
    total_samples: int
    total_symbols: int
    total_bits: int
    quality_db: float
    lock_freq_hz: Optional[float]
    avg_phase: float

    @property
    def total_frames(self) -> int:
        return len(self.frames)


def quality_db_from_avg_phase(avg_phase: float) -> float:
    """10*log10((pi/2 - avgPhase)^2) — POESTIPdemod/main.c:468."""
    d = abs(np.pi / 2.0 - avg_phase)
    return float(10.0 * np.log10(d * d)) if d > 0 else -np.inf


class DemodSession:
    """One demod stream on `device` (a CUDA device runs the kernels, the
    CPU their plain versions).  Optional failure recovery:
    `reacquire_after_s` arms a watchdog that, when the quality figure stays
    below `reacquire_quality_db` for that long while nominally locked,
    resets the PLL to acquisition (sweep restart) — the reference's
    "unlock/reset PLL on prolonged low quality" idea (changelog.txt:23)."""

    def __init__(self, mode_cfg, fs: float, chunk_size: Optional[int] = None,
                 norm_factor: Optional[float] = None, quirks: bool = True,
                 reacquire_after_s: Optional[float] = None,
                 reacquire_quality_db: float = -20.0,
                 annotate_quality: bool = False,
                 timebase: str = "accumulated", *, device="cuda"):
        self.cfg = mode_cfg
        self.fs = float(fs)
        self.device = resolve_device(device)
        self.chunk_size = int(chunk_size or mode_cfg.chunk_size)
        self.dtype = mode_cfg.np_dtype()
        self.torch_dtype = (torch.float64 if self.dtype == np.float64
                            else torch.float32)
        self.params = chain_lib.make_params(mode_cfg, self.fs, quirks=quirks)
        self.norm_factor = norm_factor
        # timebase="integer" (quirks=False only): an int64 global sample
        # counter replaces the reference's accumulated stream-dtype fold
        # (wave.c:167), whose f32 ulp exceeds Ts/2 past t ~ 4096 s at
        # 50 ksps.  The chain sees a small per-chunk f32 offset axis; the
        # f64 base n*Ts is added at emission.
        if timebase not in ("accumulated", "integer"):
            raise ValueError(f"unknown timebase {timebase!r}")
        if timebase == "integer" and quirks:
            raise ValueError("timebase='integer' requires quirks=False "
                             "(the accumulated fold IS a reference quirk)")
        self.timebase = timebase
        self._n0 = 0                  # int64 global sample counter
        self._ts64 = 1.0 / np.float64(fs)
        self.state = None           # created on first chunk (needs norm)
        self.framer = StreamFramer(mode_cfg.framer)
        self.total_samples = 0
        self.total_symbols = 0
        self.total_bits = 0
        self.avg_phase = float(np.pi / 2.0)
        self.lock_freq_hz: Optional[float] = None
        self._was_locked = False
        self.reacquire_after_s = reacquire_after_s
        self.reacquire_quality_db = reacquire_quality_db
        self.reacquisitions = 0
        self._low_quality_samples = 0
        self.raw_tap = None          # optional file object for -r dumps
        self.annotate_quality = annotate_quality
        self.snr_db = float("nan")
        self._snr_window = np.zeros(0)

    def _ensure_state(self, first_chunk_iq):
        if self.state is not None:
            return
        if self.norm_factor is None:
            # StaticGain over the first chunk (POESTIPdemod/main.c:386)
            self.norm_factor = agc_ops.static_gain(
                first_chunk_iq, self.cfg.static_gain_level, self.dtype)
        self.state = chain_lib.init_state(
            self.params, self.norm_factor, self.chunk_size,
            device=self.device, dtype=self.torch_dtype)

    def _fetch(self, out):
        """The chunk's host values in one device-to-host copy, in the
        mode's dtype (a float64 bit time keeps its sample resolution hours
        into a pass): (bits uint8, bit mask, bit times, symbol count,
        avg_phase, locked, freq as a 0-d array, soft symbols and their mask
        or None, post-AGC stream or None)."""
        msyms = out.bits.shape[-1]
        pll = self.state.pll
        parts = [out.bits, out.bit_mask, out.bit_times, out.sym_count,
                 out.avg_phase, pll.locked, pll.freq]
        if self.annotate_quality:
            parts += [out.syms, out.sym_valid]
        if self.raw_tap is not None:
            parts.append(out.agc_stream)
        host = torch.cat([p.reshape(-1).to(self.torch_dtype)
                          for p in parts]).cpu().numpy()
        bits, mask, btimes = host[:3 * msyms].reshape(3, msyms)
        k = 3 * msyms
        sym_count, avg_phase, locked = host[k:k + 3]
        freq = host[k + 3:k + 4].reshape(())
        k += 4
        syms = sym_valid = agc_stream = None
        if self.annotate_quality:
            syms, sym_valid = host[k:k + 2 * msyms].reshape(2, msyms)
            sym_valid = sym_valid > 0
            k += 2 * msyms
        if self.raw_tap is not None:
            agc_stream = host[k:]
        return (bits.astype(np.uint8), mask > 0, btimes, int(sym_count),
                avg_phase, bool(locked), freq, syms, sym_valid, agc_stream)

    def process(self, iq: np.ndarray, t: np.ndarray,
                t_next: np.ndarray) -> List[Frame]:
        """Feed one chunk (<= chunk_size samples). Returns frames completed.

        With timebase="integer" the passed t/t_next are ignored — the
        session synthesizes its own exact offset axis."""
        self._ensure_state(iq)
        re = np.ascontiguousarray(np.real(iq), self.dtype)
        im = np.ascontiguousarray(np.imag(iq), self.dtype)
        n = len(re)
        base_s = 0.0
        if self.timebase == "integer":
            # offset axis: time of local sample i is (i+1)*Ts relative to
            # the chunk base n0*Ts (the reference convention t[0] = Ts)
            off = (np.arange(1, n + 2, dtype=np.float64)
                   * self._ts64).astype(self.dtype)
            t, t_next = off[:n], off[1:]
            base_s = float(self._n0 * self._ts64)
        planes = np.stack([re, im, np.asarray(t, self.dtype),
                           np.asarray(t_next, self.dtype)])
        re_d, im_d, t_d, tn_d = torch.from_numpy(planes).to(
            self.device).unbind(0)
        self.state, out = chain_lib.chunk_step(self.params, self.state,
                                               re_d, im_d, t_d, tn_d)
        if self.timebase == "integer":
            # rebase the carried time image for the next chunk's origin;
            # the shift is within 2x of the carried offsets, so the f32
            # subtraction is exact (Sterbenz)
            shift = self.dtype.type(np.float64(n) * self._ts64)
            self.state = self.state._replace(
                t_img=self.state.t_img - float(shift))
            self._n0 += n

        (bits, mask, btimes, sym_count, avg_phase, locked, freq, syms,
         sym_valid, agc_stream) = self._fetch(out)
        bits_c = bits[mask]
        times_c = btimes[mask]
        if base_s:
            times_c = base_s + times_c.astype(np.float64)
        self.total_samples += len(re)
        self.total_symbols += sym_count
        self.total_bits += len(bits_c)
        self.avg_phase = float(avg_phase)
        if self.raw_tap is not None:
            # post-AGC soft stream, like the reference's -r debug dump
            # (ARGOSdemod/main.c:273)
            agc_stream.astype(self.dtype).tofile(self.raw_tap)
        if locked and not self._was_locked:
            self._was_locked = True
            self.lock_freq_hz = float(freq * self.fs / (2 * np.pi))
        self._maybe_reacquire(locked, len(re))
        new_frames = self.framer.process(bits_c, times_c)
        if self.annotate_quality:
            # per-packet quality/SNR annotation ("Append Quality/SNR for
            # triangulation", reference README.md:42 TODO), estimated at
            # the Gardner decision points over a rolling window, skipping
            # squelched symbols
            syms = syms.astype(np.float64)[sym_valid]
            syms = syms[syms != 0.0]
            self._snr_window = np.concatenate([self._snr_window, syms])[-512:]
            if len(self._snr_window) >= 128:
                self.snr_db = metrics.m2m4_snr_db(self._snr_window,
                                                  self.dtype)
            q = quality_db_from_avg_phase(self.avg_phase)
            carrier = float(freq * self.fs / (2 * np.pi))
            for f in new_frames:
                f.quality_db = q
                f.snr_db = self.snr_db
                f.carrier_hz = carrier   # Doppler measurement for geolocation
        return new_frames

    def _maybe_reacquire(self, locked: bool, n_samples: int):
        """Failure recovery: restart acquisition after prolonged low quality."""
        if self.reacquire_after_s is None or not locked:
            self._low_quality_samples = 0
            return
        if quality_db_from_avg_phase(self.avg_phase) < self.reacquire_quality_db:
            self._low_quality_samples += n_samples
        else:
            self._low_quality_samples = 0
        if self._low_quality_samples >= self.reacquire_after_s * self.fs:
            fresh = pll_ops.init_state(self.params.pll, device=self.device,
                                       dtype=self.torch_dtype)
            self.state = self.state._replace(pll=fresh)
            self._was_locked = False
            self._low_quality_samples = 0
            self.reacquisitions += 1

    def run(self, iq: np.ndarray, t: np.ndarray) -> DemodResult:
        """Process a whole recording (replicates the reference chunk loop)."""
        n = len(iq)
        ts = self.dtype.type(1.0) / self.dtype.type(self.fs)
        t_ext = np.concatenate([t, [t[-1] + ts] if n else [ts]]).astype(self.dtype)
        for start in range(0, n, self.chunk_size):
            end = min(start + self.chunk_size, n)
            self.process(iq[start:end], t[start:end], t_ext[start + 1:end + 1])
        self.framer.flush()
        return self.result()

    def result(self) -> DemodResult:
        return DemodResult(
            frames=list(self.framer.frames),
            total_samples=self.total_samples,
            total_symbols=self.total_symbols,
            total_bits=self.total_bits,
            quality_db=quality_db_from_avg_phase(self.avg_phase),
            lock_freq_hz=self.lock_freq_hz,
            avg_phase=self.avg_phase,
        )


def demodulate_wav(path: str, mode_cfg, chunk_size: Optional[int] = None,
                   norm_factor: Optional[float] = None,
                   sample_rate_override: float = 0.0,
                   quirks: bool = True, *, device="cuda") -> DemodResult:
    iq, t, fs, _ = wav_lib.load_iq_wav(path, mode_cfg.np_dtype(),
                                       sample_rate_override)
    sess = DemodSession(mode_cfg, fs, chunk_size, norm_factor, quirks,
                        device=device)
    return sess.run(iq, t)


def demodulate_raw(path: str, mode_cfg, sample_rate_hz: float,
                   chunk_size: Optional[int] = None,
                   norm_factor: Optional[float] = None,
                   quirks: bool = True, *, device="cuda") -> DemodResult:
    iq, t, fs = wav_lib.load_iq_raw(path, sample_rate_hz, mode_cfg.np_dtype())
    sess = DemodSession(mode_cfg, fs, chunk_size, norm_factor, quirks,
                        device=device)
    return sess.run(iq, t)

"""TIP minor-frame processing: parity check, day/time decode, spacecraft ID.

The port's own copy of
``project_desert_tortoise_tpu/telemetry/minorframes.py``: numpy only, as
the port imports nothing of the JAX package.

Vectorized twins of the MATLAB prototype layer (the capabilities the C
reference never got):

- `check_parity`: word-103 even-parity over the 5 groups words 2-18 / 19-35 /
  36-52 / 53-69 / 70-86 vs bits 3-7 of byte 104 (``checkParity.m:3-91``);
  the "N out of M Error Free Frames" figure is the framework's end-to-end
  accuracy metric.
- `daytime_decode`: 9-bit minor-frame counter (bytes 5-6), Julian day +
  millisecond-of-day at frame 0 (bytes 9-13), T0 consensus via mode within
  +/-100 ms, spacecraft ID byte 3 (``daytimeDecode.m``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

SPACECRAFT = {8: "NOAA-15", 13: "NOAA-18", 15: "NOAA-19"}


def frames_to_matrix(frames) -> np.ndarray:
    """(n_frames, 104) uint8 from complete 104-byte frames."""
    rows = [np.asarray(f.data, np.uint8) for f in frames
            if getattr(f, "complete", True) and len(f.data) == 104]
    return np.stack(rows) if rows else np.zeros((0, 104), np.uint8)


def frame_times(frames) -> np.ndarray:
    return np.array([f.time for f in frames
                     if getattr(f, "complete", True) and len(f.data) == 104])


_POPCNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                        axis=1).sum(1)

# (start_word, end_word) inclusive, 1-based words; word k = byte index k-1.
_PARITY_GROUPS = [(3, 19), (20, 36), (37, 53), (54, 70), (71, 87)]


def check_parity(minor_frames: np.ndarray):
    """Returns (good_frame_mask, parity_error_matrix (n,5))."""
    mf = np.asarray(minor_frames, np.uint8)
    n = len(mf)
    errs = np.zeros((n, 5), bool)
    last = mf[:, 103].astype(np.int32)
    for g, (lo, hi) in enumerate(_PARITY_GROUPS):
        ones = _POPCNT[mf[:, lo - 1:hi]].sum(axis=1)
        parity_bit = (last >> (5 - g)) & 1
        errs[:, g] = (ones % 2) != parity_bit
    good = ~errs.any(axis=1)
    return good, errs


@dataclasses.dataclass
class DaytimeInfo:
    spacecraft_id: int
    spacecraft_name: str
    julian_day: Optional[int]
    t0_ms_best: Optional[float]        # consensus stream-local T0 (ms of day)
    day_ms: List[float]                # ms-of-day at each frame-0
    minor_frame_ids: np.ndarray
    # per-frame-0 T0 deviating >100 ms from the consensus — the reference's
    # "...But this is probably an error" flag (daytimeDecode.m:65-67)
    t0_outliers: Optional[np.ndarray] = None


T0_THRESHOLD_MS = 100.0  # daytimeDecode.m:39 "100mS of jitter is MORE than enough"


def _t0_consensus(t0s: List[float]):
    """Consensus T0 via the mode of rounded candidates, made robust to
    rounding fragmentation by scoring each candidate with its +/-100 ms
    neighborhood support (daytimeDecode.m:38-44 declares T0Threshold=100 and
    flags T0s outside it; a plain exact-ms mode can fragment a jittered
    cluster across adjacent milliseconds where MATLAB's threshold would not).

    Winner: candidate with the most supporters within +/-100 ms; ties break
    toward the larger exact count, then the smaller value (MATLAB ``mode``).
    Returns (t0_best, outlier_mask)."""
    arr = np.asarray(t0s, np.float64)
    rounded = np.round(arr)
    vals, counts = np.unique(rounded, return_counts=True)
    support = np.array([(np.abs(arr - v) <= T0_THRESHOLD_MS).sum()
                        for v in vals])
    # lexsort is stable ascending: last key dominates -> max support, then
    # max exact count, then smallest value (vals already ascending)
    order = np.lexsort((-counts, -support))
    best = float(vals[order[0]])
    return best, np.abs(arr - best) > T0_THRESHOLD_MS


def daytime_decode(minor_frames: np.ndarray,
                   times: Optional[np.ndarray] = None) -> DaytimeInfo:
    mf = np.asarray(minor_frames, np.uint64)
    ids = ((mf[:, 4] & 1) << 8) | mf[:, 5]
    sc_vals = mf[:, 2].astype(int)
    sc = int(np.bincount(sc_vals, minlength=256).argmax()) if len(mf) else -1

    day = None
    day_ms: List[float] = []
    t0s: List[float] = []
    zero = np.nonzero(ids == 0)[0]
    for i in zero:
        d = int((mf[i, 8] << 1) | (mf[i, 9] >> 7))
        ms = int(((mf[i, 9] & 0b111) << 24) | (mf[i, 10] << 16)
                 | (mf[i, 11] << 8) | mf[i, 12])
        if ms < 86_400_000:
            day_ms.append(float(ms))
            if times is not None:
                t0s.append(ms - times[i] * 1000.0)
            if day is None:
                day = d
    t0_best, outliers = (None, None) if not t0s else _t0_consensus(t0s)
    return DaytimeInfo(
        spacecraft_id=sc,
        spacecraft_name=SPACECRAFT.get(sc, "A UFO!"),
        julian_day=day,
        t0_ms_best=t0_best,
        day_ms=day_ms,
        minor_frame_ids=ids.astype(np.int32),
        t0_outliers=outliers,
    )


def sync_spacing_report(sync_bit_positions: np.ndarray,
                        frame_bits: int = 832):
    """syncWordDetect.m:12 — how many sync spacings are whole minor frames."""
    d = np.diff(np.sort(np.asarray(sync_bit_positions)))
    return int(np.sum(d % frame_bits == 0)), len(d)

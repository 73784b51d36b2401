"""The comparison that decides ``correct``: a pass's frames as the program
returned them against the plain reference's frames of the same pass.

A frame of the program pairs with a frame of the reference that carries
the same payload bytes and inversion flag and whose sync time (on the
recording's float32 time axis) lies within `window` seconds of it, half a
bit in the cells: the same frame, found at the same bit.  Frames pair in
stream order.  The number compared:

- ``frames_unpaired``: frames on either side with no partner; a frame
  whose payload differs by one bit, or that is found a bit early or late,
  counts twice.

``sync_gap_s``, the widest gap between the sync times of a pair, is
reported beside it for information.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Tuple

# the compared numbers, in the order they are printed
NUMBERS = ("frames_unpaired",)


def pair(ref: Iterable[Tuple[float, bool, bytes]],
         got: Iterable[Tuple[float, bool, bytes]],
         window: float) -> Dict[str, float]:
    """Compare two frame lists of (time, inverted, payload), each in
    stream order."""
    a: Dict[tuple, List[float]] = collections.defaultdict(list)
    b: Dict[tuple, List[float]] = collections.defaultdict(list)
    for t, inv, data in ref:
        a[bool(inv), bytes(data)].append(float(t))
    for t, inv, data in got:
        b[bool(inv), bytes(data)].append(float(t))
    unpaired, gap = 0, 0.0
    for key in a.keys() | b.keys():
        ta, tb = a.get(key, []), b.get(key, [])
        i = j = 0
        while i < len(ta) and j < len(tb):
            if abs(ta[i] - tb[j]) <= window:
                gap = max(gap, abs(ta[i] - tb[j]))
                i, j = i + 1, j + 1
            elif ta[i] < tb[j]:
                i, unpaired = i + 1, unpaired + 1
            else:
                j, unpaired = j + 1, unpaired + 1
        unpaired += len(ta) - i + len(tb) - j
    return {"frames_unpaired": unpaired, "sync_gap_s": gap}


def window_s(cfg) -> float:
    """Half a bit of the configuration's pass."""
    return 0.5 / cfg["pass"]["bit_rate"]


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over several passes."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0), v)
    return out


def judge(reading: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True where every number is within its limit."""
    return all(reading[k] <= limits[k] for k in NUMBERS)

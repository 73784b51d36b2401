"""ARGOS packet post-processing (twin of the MATLAB argos prototype layer).

The port's own copy of
``project_desert_tortoise_tpu/telemetry/argos.py``: numpy only, as
the port imports nothing of the JAX package.

- `filter_platform`: keep packets from a known platform ID
  (``argos/ARGOSdemodulator.m:184`` filters on ID bytes 251/58/208/0);
- `group_by_repetition`: cluster packets into transmission bursts using the
  platform repetition period (~60 s, ``POES.m:988-989`` / DCS-2 table);
- `packet_report`: text summary with quality/SNR annotations, the
  "triangulation" output the reference left as a TODO (``README.md:42``).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from project_desert_tortoise_tpu_torch.ops.framer import Frame


def platform_id(frame: Frame) -> Optional[tuple]:
    """First four payload bytes (the prototype's platform ID)."""
    if len(frame.data) < 4:
        return None
    return tuple(int(b) for b in frame.data[:4])


def filter_platform(frames: Iterable[Frame],
                    pid: Sequence[int] = (251, 58, 208, 0)) -> List[Frame]:
    pid = tuple(pid)
    return [f for f in frames if platform_id(f) == pid]


def group_by_repetition(frames: Iterable[Frame],
                        period_s: float = 60.0,
                        tolerance_s: float = 15.0) -> List[List[Frame]]:
    """Group a platform's packets into repetition chains: consecutive
    packets ~one repetition period apart belong to the same pass."""
    out: List[List[Frame]] = []
    for f in sorted(frames, key=lambda f: f.time):
        if out and abs((f.time - out[-1][-1].time) - period_s) < tolerance_s:
            out[-1].append(f)
        elif out and (f.time - out[-1][-1].time) < tolerance_s:
            out[-1].append(f)
        else:
            out.append([f])
    return out


def packet_report(frames: Iterable[Frame]) -> str:
    """Per-platform summary with quality/SNR columns."""
    by_pid = {}
    for f in frames:
        by_pid.setdefault(platform_id(f), []).append(f)
    lines = []
    for pid, pkts in sorted(by_pid.items(), key=lambda kv: -len(kv[1])):
        pid_s = ("-".join(str(b) for b in pid)) if pid else "?"
        times = np.array([p.time for p in pkts])
        d = np.diff(times)
        rep = float(np.median(d)) if len(d) else float("nan")
        snrs = [p.snr_db for p in pkts if p.snr_db is not None]
        snr_s = f" snr_med={np.median(snrs):.1f}dB" if snrs else ""
        lines.append(f"platform {pid_s}: {len(pkts)} packets, "
                     f"median repetition {rep:.1f}s{snr_s}")
        for p in pkts:
            lines.append("  " + p.hex_line(with_quality=True))
    return "\n".join(lines)

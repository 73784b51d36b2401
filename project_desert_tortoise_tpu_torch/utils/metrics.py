"""Signal-quality metrics and console telemetry.

The port's own copy of ``project_desert_tortoise_tpu/utils/metrics.py``,
with the M2M4 moments in numpy, in the stream's dtype (float32, as the JAX
package computes them without x64; float64 for the ``argos`` mode, which
JAX runs under x64); the sums run in numpy's order, not XLA's.

- quality figure ``10*log10((pi/2 - avgPhase)^2)`` with the reference's ANSI
  thresholds (``POESTIPdemod/main.c:115-118,461-481``);
- M2M4 moment-based SNR estimator (the MATLAB ``M2M4.m`` capability, closing
  the reference's "Append Quality/SNR" TODO, ``README.md:42,51``).
"""

from __future__ import annotations

import numpy as np

QUALITY_GOOD = -4.3
QUALITY_MEDIUM = -5.0
QUALITY_LOW = -6.0
QUALITY_SHIT = -20.0

_ANSI = {"green": "\x1b[32m", "yellow": "\x1b[33m", "red": "\x1b[31m",
         "reset": "\x1b[0m"}


def quality_db(avg_phase: float) -> float:
    d = abs(np.pi / 2.0 - avg_phase)
    return float(10.0 * np.log10(d * d)) if d > 0 else float("-inf")


def quality_string(q_db: float, color: bool = True) -> str:
    if q_db > QUALITY_GOOD:
        c = "green"
    elif q_db > QUALITY_LOW:
        c = "yellow"
    else:
        c = "red"
    s = f"{q_db:02.1f}Q"
    return f"{_ANSI[c]}{s}{_ANSI['reset']}" if color else s


def progress_line(percent: float, total_ksamples: float, stream_time_s: float,
                  symbols: int, bits: int, frames: int, q_db: float,
                  color: bool = True) -> str:
    """The reference console status line (POESTIPdemod/main.c:480)."""
    return (f"{percent:0.1f}% {total_ksamples:0.3f} Ks : "
            f"{stream_time_s:0.1f} Sec: {symbols} Sym : {bits} Bits : "
            f"{frames} Frames : {quality_string(q_db, color)}")


def m2m4_snr_db(x, dtype=np.float32) -> float:
    """M2M4 SNR estimate for a real BPSK soft stream (MATLAB ``M2M4.m:27-43``).

    Real-signal constants: with x = s + n, s = +/-A, n ~ N(0, sigma^2):
    M4 = S^2 + 6SN + 3N^2, so S = sqrt((3*M2^2 - M4)/2), N = M2 - S;
    returns 10*log10(S/N), computed in `dtype`.
    """
    c = np.dtype(dtype).type
    x = np.asarray(x, c)
    m2 = np.mean(x * x)
    m4 = np.mean(x * x * x * x)
    s = np.sqrt(np.maximum((3 * m2 * m2 - m4) / c(2.0), c(1e-30)))
    n = np.maximum(m2 - s, c(1e-30))
    return float(c(10.0) * np.log10(s / n))

"""The least time an H100 could take on a pass's hand-kernel work, counted
from the cell's shapes alone.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W: 3.35 TB/s of
HBM bandwidth and 67 TFLOP/s in float32 outside the tensor cores.

Bytes: each input byte read once and each output byte written once.
Operations: the table below, one for every add, multiply, divide,
compare, select, absolute value, sine or cosine of the kernel's step in the
reference program's equations (``reference.py``, and for the PLL the
acquisition logic that the kernel evaluates on every step too), counted
once.  Index arithmetic and loads are not counted.

On branch False of the flat path a pass runs, on all its blocks together:
- the PLL over each block's samples (reads re and im, writes the data arm
  and the lock signal, 4 bytes each);
- the AGC over the interpolated samples (reads and writes 4 bytes each);
- Gardner timing with the Manchester decision in windows (reads the
  interpolated samples and their time plane, 4 bytes each; writes a bit, a
  time and an emit flag, 1 + 4 + 1 bytes, per symbol slot).
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12

# operations a step, counted from the equations
OPS = {
    # input terms: atan2 approximation 17, |z|^2 and Q_rsqrt with two
    # Newton rounds 14, the normalised sample 2; the step: sin, cos 2, mix 6,
    # the output's atan2 17, the phase EWMA 4, wrapped error 7, gain
    # selects 2, loop filter 5, phase wraps 6, clamp 2, lock detector 6,
    # sweep gate 5, sweep 12, lock flag 2
    "pll_scan": 109,
    # y = x*g, |y| - ref, |e| > g select, g - e*rate, two clamps as
    # compare-selects
    "agc_scan": 12,
    # timing: two roundings, window bounds 9, error 5, pointer updates 3,
    # keeps 3, mid-bit select 2, active 1, clamps 1; Manchester: resync 15,
    # decision 7, keeps 5, parity 2, emit 3
    "gardner_manchester": 57,
}


def slots(window: int, interp: int, step_size: float, samples: int) -> int:
    """Symbol slots of the windowed Gardner scan over `samples` input
    samples: int(window*interp / step * 1.08) + 4 a window."""
    w = window * interp
    if (samples * interp) % w:
        raise ValueError(f"{samples} samples do not fill whole windows")
    return (samples * interp // w) * (int(w / step_size * 1.08) + 4)


def pass_work(lanes: int, samples: int, interp: int, window: int,
              step_size: float) -> Dict[str, Dict[str, float]]:
    """Bytes and operations of each hand kernel over one pass of `lanes`
    blocks of `samples` input samples."""
    n_i = samples * interp
    s = slots(window, interp, step_size, samples)
    return {
        "pll_scan": {"bytes": lanes * samples * 16.0,
                     "ops": lanes * samples * float(OPS["pll_scan"])},
        "agc_scan": {"bytes": lanes * n_i * 8.0,
                     "ops": lanes * n_i * float(OPS["agc_scan"])},
        "gardner_manchester": {
            "bytes": lanes * (n_i * 8.0 + s * 6.0),
            "ops": lanes * s * float(OPS["gardner_manchester"])},
    }


def least_ms(work: Dict[str, Dict[str, float]]):
    """(least milliseconds, "bytes" or "operations") over all kernels."""
    b = sum(k["bytes"] for k in work.values()) / HBM_BYTES_S
    o = sum(k["ops"] for k in work.values()) / FP32_OPS_S
    return (max(b, o) * 1e3, "bytes" if b >= o else "operations")

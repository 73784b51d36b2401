"""Fast-math primitives of the PLL, bit for bit as in the JAX package.

Twins of ``project_desert_tortoise_tpu/ops/fastmath.py``: the reference's
quarter-circle ``arctan2`` approximation and the bit-trick ``Q_rsqrt`` with
two Newton rounds (``common/CarrierTrackingPLL.c:15-52``), reproduced
operation for operation so the loop trajectory matches.
"""

from __future__ import annotations

import torch

COEFF_1 = 0.78539816339744825   # pi/4
COEFF_2 = 2.35619449019234475   # 3*pi/4


def arctan2_approx(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rational atan2 approximation (CarrierTrackingPLL.c:15), its
    constants in the inputs' dtype (python floats take the tensor's)."""
    abs_y = torch.abs(y) + 1e-10                  # avoids 0/0
    r_pos = (x - abs_y) / (x + abs_y)
    r_neg = (x + abs_y) / (abs_y - x)
    angle = torch.where(x >= 0, COEFF_1 - COEFF_1 * r_pos,
                        COEFF_2 - COEFF_1 * r_neg)
    return torch.where(y < 0, -angle, angle)


def q_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """Quake fast inverse sqrt, float32 bit-exact (CarrierTrackingPLL.c:43).
    A float64 input is squeezed through float32 and the result cast back,
    as the reference applies the float version in double builds
    (CarrierTrackingPLL.c:202)."""
    xf = x.to(torch.float32)
    xhalf = 0.5 * xf
    i = xf.view(torch.int32)
    i = 0x5F3759DF - (i >> 1)          # int32 arithmetic, wraps like C
    g = i.view(torch.float32)
    g = g * (1.5 - xhalf * g * g)
    g = g * (1.5 - xhalf * g * g)
    return g.to(x.dtype)


def sign(x: torch.Tensor) -> torch.Tensor:
    """C-style sign: (x > 0) - (x < 0), in the input dtype."""
    return (x > 0).to(x.dtype) - (x < 0).to(x.dtype)

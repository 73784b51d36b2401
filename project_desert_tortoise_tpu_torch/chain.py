"""Chain parameters of the block-parallel fast path.

``ChainParams`` has the fields of the JAX package's record
(``project_desert_tortoise_tpu/chain.py:36-99``) so the two compare field by
field; ``make_params`` builds the fast path's parameters (``quirks=False``),
and ``from_jax`` converts the JAX package's parameters and stream states,
the "weights" of this system, into the port's.  The exact chunked chain
(``chunk_step``) is not part of this package yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from project_desert_tortoise_tpu_torch.ops import agc as agc_ops
from project_desert_tortoise_tpu_torch.ops import clock as clock_ops
from project_desert_tortoise_tpu_torch.ops import fir as fir_ops
from project_desert_tortoise_tpu_torch.ops import manchester as man_ops
from project_desert_tortoise_tpu_torch.ops import pll as pll_ops


class ChainParams(NamedTuple):
    """Static per-stream parameters (derived from ModeConfig + Fs)."""
    pll: pll_ops.PLLParams
    taps: tuple                 # FIR taps (float32 values as python floats)
    interp: int
    agc_attack: float
    agc_decay: float
    squelch_threshold: Optional[float]
    squelch_position: Optional[str]   # "after_pll" | "after_agc"
    step_size: float
    fs_interp: float
    baud: float
    gardner_err_limit: float
    gardner_gain: float
    clock_algorithm: str
    upsample_level: int
    upsample_kind: str
    resync_threshold: float
    quirks: bool


def make_params(mode_cfg, fs: float) -> ChainParams:
    """Fast-path parameters of `mode_cfg` at sample rate `fs` (the JAX
    ``make_params(mode_cfg, fs, quirks=False)``)."""
    dtype = mode_cfg.np_dtype()
    interp = mode_cfg.fir.interp_factor(fs)
    order = mode_cfg.fir.order(fs)
    taps = fir_ops.make_lpfir(order, mode_cfg.fir.cutoff_hz, fs * interp,
                              interp, dtype)
    fs_i = fs * interp
    return ChainParams(
        pll=pll_ops.make_params(mode_cfg.pll, fs),
        taps=tuple(taps.tolist()),
        interp=interp,
        agc_attack=mode_cfg.scaled(mode_cfg.agc.attack_rate_rad_s, fs_i),
        agc_decay=mode_cfg.scaled(mode_cfg.agc.decay_rate_rad_s, fs_i),
        squelch_threshold=(mode_cfg.squelch.threshold
                           if mode_cfg.squelch else None),
        squelch_position=(mode_cfg.squelch.position
                          if mode_cfg.squelch else None),
        step_size=clock_ops.gardner_step_size(fs_i, mode_cfg.gardner.baud,
                                              dtype),
        fs_interp=fs_i,
        baud=mode_cfg.gardner.baud,
        gardner_err_limit=mode_cfg.gardner.error_limit,
        gardner_gain=mode_cfg.gardner.gain,
        clock_algorithm=mode_cfg.gardner.algorithm,
        upsample_level=mode_cfg.gardner.upsample_level,
        upsample_kind=mode_cfg.gardner.upsample_kind,
        resync_threshold=mode_cfg.manchester.resync_threshold,
        quirks=False,
    )


def from_jax(obj, device="cpu"):
    """Convert a JAX ``ChainParams`` or a JAX stream state (``PLLState``,
    ``AGCState``, ``GardnerState``, ``ManchesterState``) into the port's.

    Parameters are python floats and a taps tuple on both sides and carry
    over field by field; a state's arrays become tensors on `device`:
    float32, ``locked`` bool, the Manchester ``clockmod``/``evenodd``
    int32.  Works by field names, so jax need not be importable here.
    """
    if hasattr(obj, "taps"):
        fields = obj._asdict()
        fields["pll"] = pll_ops.PLLParams(**obj.pll._asdict())
        fields["taps"] = tuple(float(v) for v in obj.taps)
        return ChainParams(**fields)
    kinds = {pll_ops.PLLState: {"locked": torch.bool},
             agc_ops.AGCState: {},
             clock_ops.GardnerState: {},
             man_ops.ManchesterState: {"clockmod": torch.int32,
                                       "evenodd": torch.int32}}
    for cls, dtypes in kinds.items():
        if getattr(obj, "_fields", None) == cls._fields:
            return cls(**{k: torch.tensor(np.asarray(v), device=device).to(
                dtypes.get(k, torch.float32))
                for k, v in obj._asdict().items()})
    raise TypeError(f"cannot convert {type(obj).__name__}")

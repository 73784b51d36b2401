"""The Costas PLL over whole blocks.

Counterpart of ``project_desert_tortoise_tpu/ops/pallas/pll_kernel.py``
(``pll_scan_pallas``, the drop-in for the XLA scan ``pll_scan``).

:func:`pll_scan_kernel` is the entry point.  A CUDA tensor launches the
hand-written kernel ``csrc/pll_kernel.cu`` or raises; a CPU tensor runs the
plain version ``ops/pll.py::pll_scan_ref``, the per-sample loop in the
kernel's float32 operations, so on the card the two agree bit for bit.
``pll_scan_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.ops.kernels.common import (
    check, launch, state_rows)

# order of the float parameter block; must match PllParams in
# csrc/pdt_common.cuh
PLL_FIELDS = ("alpha_acq", "beta_acq", "alpha_track", "beta_track",
              "max_freq", "lock_alpha", "lock_threshold", "sweep_threshold",
              "avg_phase_alpha")


def pll_param_block(params: pll_ops.PLLParams) -> np.ndarray:
    return np.array([getattr(params, k) for k in PLL_FIELDS], np.float32)


def check_pll_state(state, B: int, dev) -> None:
    for name, s in zip(pll_ops.PLLState._fields, state):
        check(name, s, (B,), (torch.bool if name == "locked"
                              else torch.float32,), dev)


def pll_state_from_rows(rows) -> pll_ops.PLLState:
    """A PLLState from the kernels' (>= 6, B) state rows."""
    return pll_ops.PLLState(*rows[:5], locked=rows[5] > 0.5)


def pll_scan_kernel(params: pll_ops.PLLParams, state: pll_ops.PLLState, z):
    """The PLL over (B, L) float32 planes z = (zre, zim); state: (B,)
    lanes.  Returns (state, out (B, L), locksig (B, L)), as the JAX
    ``pll_scan_pallas``.  CPU tensors run ``ops/pll.py::pll_scan_ref``."""
    zre, zim = z
    dev = zre.device
    if dev.type == "cpu":
        return pll_ops.pll_scan_ref(params, state, zre, zim)
    if dev.type != "cuda":
        raise ValueError(f"pll_scan runs on cpu or cuda, not {dev}")
    B, L = zre.shape
    check("zre", zre, (B, L), (torch.float32,), dev)
    check("zim", zim, (B, L), (torch.float32,), dev)
    check_pll_state(state, B, dev)

    # time-major (L, B) planes: a warp reads 32 neighbouring lanes per step
    xre = zre.t().contiguous()
    xim = zim.t().contiguous()
    st_in = state_rows(state)
    out = torch.empty((L, B), dtype=torch.float32, device=dev)
    lock = torch.empty((L, B), dtype=torch.float32, device=dev)
    st_out = torch.empty_like(st_in)
    p = pll_param_block(params)
    launch(dev, "pdt_pll_scan", xre.data_ptr(), xim.data_ptr(),
           st_in.data_ptr(), out.data_ptr(), lock.data_ptr(),
           st_out.data_ptr(), B, L, p.ctypes.data_as(ctypes.c_void_p),
           p.size)
    pll_scan_kernel.launches += 1
    return pll_state_from_rows(st_out), out.t(), lock.t()


pll_scan_kernel.launches = 0

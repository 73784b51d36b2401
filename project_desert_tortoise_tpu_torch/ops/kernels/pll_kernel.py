"""The Costas PLL over whole blocks.

Counterpart of ``project_desert_tortoise_tpu/ops/pallas/pll_kernel.py``
(``pll_scan_pallas``, the drop-in for the XLA scan ``pll_scan``).

- :func:`pll_scan_kernel` is the entry point.  A CUDA tensor launches the
  hand-written decoupled kernel of ``csrc/pll_kernel.cu`` (stages A, B and
  M of ``csrc/front_stages.cuh``) or raises; a CPU tensor runs the plain
  version ``ops/pll.py::pll_scan_ref``, the per-sample loop in the
  kernel's float32 operations, so on the card the two agree bit for bit.
  ``pll_scan_kernel.launches`` counts kernel launches.
- :func:`pll_scan_serial` launches the serial kernel of the same file, the
  whole step of a sample in turn: the card-side oracle and timing baseline
  of the decoupled kernel, on no path.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.ops.kernels.common import (
    check, kernel_config, launch, on_card, state_rows)

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


def _state_in(state, z):
    """Check a launch's arguments; returns the kernels' state rows."""
    zre, zim = z
    dev = zre.device
    B, L = zre.shape
    check("zre", zre, (B, L), (torch.float32,), dev)
    check("zim", zim, (B, L), (torch.float32,), dev)
    check_pll_state(state, B, dev)
    return state_rows(state)


def pll_scan_kernel(params: pll_ops.PLLParams, state: pll_ops.PLLState, z,
                    *, unlocked=None):
    """The PLL over (B, L) float32 planes z = (zre, zim); state: (B,)
    lanes.  Returns (state, out (B, L), locksig (B, L)), as the JAX
    ``pll_scan_pallas``.  CPU tensors run ``ops/pll.py::pll_scan_ref``.
    ``unlocked``, a (B,) int32 tensor on the card, receives the steps each
    lane ran before its PLL locked."""
    zre, zim = z
    if not on_card("pll_scan", zre.device):
        return pll_ops.pll_scan_ref(params, state, zre, zim)
    st_in = _state_in(state, z)
    dev = zre.device
    B, L = zre.shape
    if unlocked is not None:
        check("unlocked", unlocked, (B,), (torch.int32,), dev)
    # lane-major (B, L) planes: a CTA's chunk of a lane is contiguous
    zre, zim = zre.contiguous(), zim.contiguous()
    out = torch.empty((B, L), dtype=torch.float32, device=dev)
    lock = torch.empty((B, L), dtype=torch.float32, device=dev)
    st_out = torch.empty_like(st_in)
    p = pll_param_block(params)
    launch(dev, "pdt_pll_scan", zre.data_ptr(), zim.data_ptr(),
           st_in.data_ptr(), out.data_ptr(), lock.data_ptr(),
           st_out.data_ptr(),
           None if unlocked is None else unlocked.data_ptr(), B, L,
           p.ctypes.data_as(ctypes.c_void_p), p.size)
    pll_scan_kernel.launches += 1
    return pll_state_from_rows(st_out), out, lock


pll_scan_kernel.launches = 0


def pll_scan_serial(params: pll_ops.PLLParams, state: pll_ops.PLLState, z):
    """:func:`pll_scan_kernel` on the serial kernel, which runs the whole
    PLL step of a sample in turn, one thread a lane, on time-major planes.
    No path calls it: the card checks and ``chip_smoke.py`` hold the
    decoupled kernel to it over whole passes and time the two in one run.
    CUDA tensors only."""
    if not on_card("pll_scan_serial", z[0].device):
        raise ValueError("pll_scan_serial runs on a CUDA device only")
    st_in = _state_in(state, z)
    zre, zim = z
    dev = zre.device
    B, L = zre.shape
    # time-major planes: a warp reads and writes 32 neighbouring lanes
    xre = zre.t().contiguous()
    xim = zim.t().contiguous()
    out = torch.empty((L, B), dtype=torch.float32, device=dev)
    lock = torch.empty((L, B), dtype=torch.float32, device=dev)
    st_out = torch.empty_like(st_in)
    p = pll_param_block(params)
    launch(dev, "pdt_pll_scan_serial", xre.data_ptr(), xim.data_ptr(),
           st_in.data_ptr(), out.data_ptr(), lock.data_ptr(),
           st_out.data_ptr(), B, L, p.ctypes.data_as(ctypes.c_void_p),
           p.size)
    pll_scan_serial.launches += 1
    return pll_state_from_rows(st_out), out.t(), lock.t()


pll_scan_serial.launches = 0


def launch_config(device="cuda") -> dict:
    """The decoupled kernel's launch configuration: lanes per CTA, chunk
    samples, threads and (static) shared memory bytes a CTA, registers and
    local (spill) bytes a thread, as the card reports them."""
    return kernel_config(device, "pdt_pll_scan_config")

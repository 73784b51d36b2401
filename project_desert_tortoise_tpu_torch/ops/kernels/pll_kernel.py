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
- :func:`pll_scan_f64` launches the decoupled kernel instantiated in
  double: the PLL of the float64 ``argos`` mode's exact chain, which
  :func:`pll_scan_kernel` launches for float64 tensors on the card.
  :func:`pll_scan_f64_serial` launches the serial kernel in double, its
  card-side oracle and timing baseline, on no path.
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


def pll_param_block(params: pll_ops.PLLParams,
                    dtype=np.float32) -> np.ndarray:
    return np.array([getattr(params, k) for k in PLL_FIELDS], dtype)


def check_pll_state(state, B: int, dev, dtype=torch.float32) -> None:
    for name, s in zip(pll_ops.PLLState._fields, state):
        check(name, s, (B,), (torch.bool if name == "locked"
                              else dtype,), dev)


def pll_state_from_rows(rows) -> pll_ops.PLLState:
    """A PLLState from the kernels' (>= 6, B) state rows."""
    return pll_ops.PLLState(*rows[:5], locked=rows[5] > 0.5)


def _state_in(state, z, dtype=torch.float32):
    """Check a launch's arguments; returns the kernels' state rows."""
    zre, zim = z
    dev = zre.device
    B, L = zre.shape
    check("zre", zre, (B, L), (dtype,), dev)
    check("zim", zim, (B, L), (dtype,), dev)
    check_pll_state(state, B, dev, dtype)
    return state_rows(state)


def pll_scan_kernel(params: pll_ops.PLLParams, state: pll_ops.PLLState, z,
                    *, unlocked=None):
    """The PLL over (B, L) float32 planes z = (zre, zim); state: (B,)
    lanes.  Returns (state, out (B, L), locksig (B, L)), as the JAX
    ``pll_scan_pallas``.  CPU tensors run ``ops/pll.py::pll_scan_ref``;
    float64 planes on the card launch :func:`pll_scan_f64`.
    ``unlocked``, a (B,) int32 tensor on the card, receives the steps each
    lane ran before its PLL locked."""
    zre, zim = z
    if not on_card("pll_scan", zre.device):
        return pll_ops.pll_scan_ref(params, state, zre, zim)
    if zre.dtype == torch.float64:
        if unlocked is not None:
            raise ValueError("unlocked: counted by the float32 kernel only")
        return pll_scan_f64(params, state, z)
    if unlocked is not None:
        check("unlocked", unlocked, (zre.shape[0],), (torch.int32,),
              zre.device)
    out = _launch_decoupled("pdt_pll_scan", params, state, z, torch.float32,
                            unlocked)
    pll_scan_kernel.launches += 1
    return out


pll_scan_kernel.launches = 0


def _launch_decoupled(entry: str, params: pll_ops.PLLParams,
                      state: pll_ops.PLLState, z, dtype, *unlocked):
    """Launch the decoupled kernel `entry` in `dtype` (float32 or float64)
    on the lane-major (B, L) planes z (a CTA's chunk of a lane is
    contiguous); `unlocked`: the float32 kernel's counts tensor or None.
    Returns as :func:`pll_scan_kernel`."""
    st_in = _state_in(state, z, dtype)
    zre, zim = (a.contiguous() for a in z)
    dev = zre.device
    B, L = zre.shape
    out = torch.empty((B, L), dtype=dtype, device=dev)
    lock = torch.empty_like(out)
    st_out = torch.empty_like(st_in)
    p = pll_param_block(params, np.float64 if dtype == torch.float64
                        else np.float32)
    launch(dev, entry, zre.data_ptr(), zim.data_ptr(), st_in.data_ptr(),
           out.data_ptr(), lock.data_ptr(), st_out.data_ptr(),
           *(None if u is None else u.data_ptr() for u in unlocked), B, L,
           p.ctypes.data_as(ctypes.c_void_p), p.size)
    return pll_state_from_rows(st_out), out, lock


def _launch_serial(entry: str, params: pll_ops.PLLParams,
                   state: pll_ops.PLLState, z, dtype):
    """Launch the serial kernel `entry` in `dtype` (float32 or float64)
    on time-major copies of the (B, L) planes z; returns as
    :func:`pll_scan_kernel`."""
    st_in = _state_in(state, z, dtype)
    zre, zim = z
    dev = zre.device
    B, L = zre.shape
    # time-major planes: a warp reads and writes 32 neighbouring lanes
    xre = zre.t().contiguous()
    xim = zim.t().contiguous()
    out = torch.empty((L, B), dtype=dtype, device=dev)
    lock = torch.empty_like(out)
    st_out = torch.empty_like(st_in)
    p = pll_param_block(params, np.float64 if dtype == torch.float64
                        else np.float32)
    launch(dev, entry, xre.data_ptr(), xim.data_ptr(), st_in.data_ptr(),
           out.data_ptr(), lock.data_ptr(), st_out.data_ptr(), B, L,
           p.ctypes.data_as(ctypes.c_void_p), p.size)
    return pll_state_from_rows(st_out), out.t(), lock.t()


def pll_scan_serial(params: pll_ops.PLLParams, state: pll_ops.PLLState, z):
    """:func:`pll_scan_kernel` on the serial kernel, which runs the whole
    PLL step of a sample in turn, one thread a lane, on time-major planes.
    No path calls it: the card checks and ``chip_smoke.py`` hold the
    decoupled kernel to it over whole passes and time the two in one run.
    CUDA tensors only."""
    if not on_card("pll_scan_serial", z[0].device):
        raise ValueError("pll_scan_serial runs on a CUDA device only")
    out = _launch_serial("pdt_pll_scan_serial", params, state, z,
                         torch.float32)
    pll_scan_serial.launches += 1
    return out


pll_scan_serial.launches = 0


def pll_scan_f64(params: pll_ops.PLLParams, state: pll_ops.PLLState, z):
    """The PLL of the float64 ``argos`` mode's exact chain: the decoupled
    kernel instantiated in double, one CTA a lane, over (B, L) float64
    planes; returns as :func:`pll_scan_kernel` (no unlocked counts).
    CUDA tensors only."""
    if not on_card("pll_scan_f64", z[0].device):
        raise ValueError("pll_scan_f64 runs on a CUDA device only")
    out = _launch_decoupled("pdt_pll_scan_f64", params, state, z,
                            torch.float64)
    pll_scan_f64.launches += 1
    return out


pll_scan_f64.launches = 0


def pll_scan_f64_serial(params: pll_ops.PLLParams, state: pll_ops.PLLState,
                        z):
    """:func:`pll_scan_f64` on the serial kernel in double, one thread a
    lane over time-major copies.  No path calls it: the card checks and
    ``chip_smoke.py`` hold :func:`pll_scan_f64` to it and time the two in
    one run.  CUDA tensors only."""
    if not on_card("pll_scan_f64_serial", z[0].device):
        raise ValueError("pll_scan_f64_serial runs on a CUDA device only")
    out = _launch_serial("pdt_pll_scan_f64_serial", params, state, z,
                         torch.float64)
    pll_scan_f64_serial.launches += 1
    return out


pll_scan_f64_serial.launches = 0


def launch_config(device="cuda", dtype=torch.float32) -> dict:
    """The decoupled kernel's launch configuration in `dtype` (float32 or
    float64): lanes per CTA, chunk samples, threads and (static) shared
    memory bytes a CTA, registers and local (spill) bytes a thread, as the
    card reports them."""
    return kernel_config(device, "pdt_pll_scan_f64_config"
                         if dtype == torch.float64 else "pdt_pll_scan_config")

"""Front half of the chain: PLL -> polyphase FIR -> AGC in one pass per
block lane.

Counterpart of ``project_desert_tortoise_tpu/ops/pallas/chain_kernel.py``
(``pll_fir_agc_pallas``).  Per lane and per input sample it runs the Costas
PLL, the squelch after the PLL when the mode has one there, the 1:interp
polyphase FIR (history N/interp samples) and the AGC on each of the
`interp` outputs in order.  The AGC does not squelch: an after-AGC squelch
is the caller's (``parallel/blocked.py::demod_blocks``), as in JAX.

- :func:`pll_fir_agc` is the entry point.  A CUDA tensor launches the
  hand-written decoupled kernel of ``csrc/chain_kernel.cu`` or raises; a
  CPU tensor runs :func:`pll_fir_agc_ref`.  ``pll_fir_agc.launches``
  counts kernel launches.
- :func:`pll_fir_agc_serial` launches the serial kernel of the same file,
  PLL, FIR and AGC of a sample in turn: the card-side oracle and timing
  baseline of the decoupled kernel, on no path.
- :func:`pll_fir_agc_ref` is the plain PyTorch version, on any device: a
  loop over the samples, all lanes at once, in the JAX kernel body's order
  of float32 operations (``chain_kernel.py:52-87``), so on the card it
  agrees with the kernel bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.ops.kernels.common import (
    check, kernel_config, launch, on_card, state_rows)
from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
    check_pll_state, pll_param_block, pll_state_from_rows)

# AGC constants of the chain (JAX chain_kernel.py:118-119)
AGC_REFERENCE = 1.0
AGC_MAX_GAIN = 5000.0
AGC_MIN_GAIN = 10e-5

# (interp, hist) geometries csrc/chain_kernel.cu instantiates
KERNEL_GEOMETRIES = {(3, 26),            # POES at 50 kHz
                     (1, 50)}            # ARGOS at 32 kHz
# size of the tap table in the kernels' parameter blocks (kMaxInterp,
# kMaxHist in csrc/chain_kernel.cu and csrc/fused_demod.cu)
MAX_INTERP, MAX_HIST = 3, 50


def polyphase(taps, interp: int):
    """g[p][m] = h[(N-1-p) - m*interp] as python floats
    (twin of JAX chain_kernel.py:33-38)."""
    n = len(taps)
    hist = n // interp
    return [[float(taps[(n - 1 - p) - m * interp]) for m in range(hist)]
            for p in range(interp)]


def lane_const(v, like: torch.Tensor) -> torch.Tensor:
    """v rounded to the stream dtype of `like` (float64 for a float64
    tensor, else float32) as a (B,) lane tensor like it (tensor-tensor ops
    dispatch fastest in the per-sample loops)."""
    return torch.full(like.shape, v, dtype=pll_ops.stream_dtype(like),
                      device=like.device)


def poly_columns(poly, like: torch.Tensor) -> list:
    """poly as (interp, 1) tap columns, one per history plane m."""
    t = torch.tensor(poly, dtype=torch.float32, device=like.device)
    return [t[:, m:m + 1] for m in range(t.shape[1])]


def agc_step(x, gain, attack, decay, reference, min_gain, max_gain, zero):
    """One AGC step (AGC.c:98-130, JAX ops/agc.py:76-83) on (B,) lanes:
    returns (x * gain, the new gain)."""
    y = x * gain
    error = torch.abs(y) - reference
    rate = torch.where(torch.abs(error) > gain, attack, decay)
    gain = gain - error * rate
    gain = torch.where(gain < zero, min_gain, gain)
    gain = torch.where(gain > max_gain, max_gain, gain)
    return y, gain


def fir_agc(poly_cols, hist, gain, *agc):
    """One input sample's polyphase FIR outputs, each through one
    :func:`agc_step` (`agc`: its constants after the gain):
    y[p] = sum_m poly[p][m] * hist[m], accumulated from m = 0, the interp
    phases side by side.  Returns ([y_p], gain)."""
    y_all = torch.zeros((len(poly_cols[0]),) + hist[0].shape,
                        dtype=torch.float32, device=hist[0].device)
    for m, col in enumerate(poly_cols):
        y_all = y_all + col * hist[m]
    produced = []
    for y in y_all.unbind(0):
        y, gain = agc_step(y, gain, *agc)
        produced.append(y)
    return produced, gain


def pll_fir_agc_ref(chain_params, pll_state, agc_gain, z):
    """Plain PyTorch version of :func:`pll_fir_agc`, on any device."""
    cp = chain_params
    poly = polyphase(cp.taps, cp.interp)
    f32 = torch.float32
    zre, zim = (x.to(f32) for x in z)
    zero = torch.zeros(zre.shape[:1], dtype=f32, device=zre.device)
    k = pll_ops.loop_consts(cp.pll, zero)
    cols = poly_columns(poly, zero)
    c = lambda v: lane_const(v, zero)
    attack, decay = c(cp.agc_attack), c(cp.agc_decay)
    reference, min_gain, max_gain = (c(AGC_REFERENCE), c(AGC_MIN_GAIN),
                                     c(AGC_MAX_GAIN))
    squelch = c(cp.squelch_threshold or 0.0)
    after_pll = cp.squelch_position == "after_pll"

    pll = pll_ops.PLLState(*(x.to(f32) for x in pll_state[:5]),
                           locked=pll_state.locked.to(torch.bool))
    gain = agc_gain.to(f32)
    hist = [zero] * len(poly[0])
    # time-major (L, B): each sample's lanes are one contiguous row; the
    # input-only terms of the PLL step are computed for the whole block
    xre, xim = zre.t().contiguous(), zim.t().contiguous()
    samples = zip(*(x.unbind(0) for x in
                    (xre, xim, *pll_ops.input_terms(xre, xim))))
    ys, locks = [], []
    for x in samples:
        pll, (soft, lock) = pll_ops.step_with_terms(k, pll, *x)
        locks.append(lock)
        if after_pll:
            # |lock|: block relock may settle at the inverted BPSK point
            soft = torch.where(torch.abs(lock) < squelch, zero, soft)
        hist = [soft] + hist[:-1]
        produced, gain = fir_agc(cols, hist, gain, attack, decay, reference,
                                 min_gain, max_gain, zero)
        ys.extend(produced)
    return pll, gain, torch.stack(ys, 1), torch.stack(locks, 1)


def _param_block(cp, poly) -> np.ndarray:
    block = np.zeros((MAX_INTERP, MAX_HIST), np.float32)
    block[:len(poly), :len(poly[0])] = poly
    return np.concatenate([
        pll_param_block(cp.pll),
        np.array([cp.agc_attack, cp.agc_decay, cp.squelch_threshold or 0.0],
                 np.float32),
        block.ravel()])


def _kernel_args(cp, pll_state, agc_gain, z, name: str):
    """Check a kernel launch's arguments; returns (geometry key, the
    (B, L) planes, state rows, param block)."""
    poly = polyphase(cp.taps, cp.interp)
    key = (cp.interp, len(poly[0]))
    if key not in KERNEL_GEOMETRIES:
        raise NotImplementedError(
            f"CUDA {name} has no instantiation for geometry "
            f"(interp, hist) = {key}; available: {sorted(KERNEL_GEOMETRIES)}")
    zre, zim = z
    dev = zre.device
    B, L = zre.shape
    check("zre", zre, (B, L), (torch.float32,), dev)
    check("zim", zim, (B, L), (torch.float32,), dev)
    check_pll_state(pll_state, B, dev)
    check("agc_gain", agc_gain, (B,), (torch.float32,), dev)
    return key, (zre, zim), state_rows(pll_state, agc_gain), \
        _param_block(cp, poly)


def pll_fir_agc(chain_params, pll_state, agc_gain, z, *, unlocked=None):
    """PLL + polyphase FIR + AGC on (B, L) float32 planes z = (zre, zim).

    pll_state: (B,) lanes; agc_gain: (B,).  Returns (pll_state, agc_gain,
    y (B, L*interp), locksig (B, L)), as the JAX ``pll_fir_agc_pallas``.
    CPU tensors run :func:`pll_fir_agc_ref`.  CUDA tensors launch the
    decoupled kernel of ``csrc/chain_kernel.cu``; a geometry it does not
    instantiate raises ``NotImplementedError``.
    ``unlocked``, a (B,) int32 tensor on the card, receives the steps each
    lane ran before its PLL locked.
    """
    cp = chain_params
    if not on_card("pll_fir_agc", z[0].device):
        return pll_fir_agc_ref(cp, pll_state, agc_gain, z)
    key, (zre, zim), st_in, params = _kernel_args(cp, pll_state, agc_gain, z,
                                                  "pll_fir_agc")
    dev = zre.device
    B, L = zre.shape
    if unlocked is not None:
        check("unlocked", unlocked, (B,), (torch.int32,), dev)
    # lane-major (B, L) planes: a CTA's chunk of a lane is contiguous
    zre, zim = zre.contiguous(), zim.contiguous()
    y = torch.empty((B, L * cp.interp), dtype=torch.float32, device=dev)
    lock = torch.empty((B, L), dtype=torch.float32, device=dev)
    st_out = torch.empty_like(st_in)
    launch(dev, "pdt_pll_fir_agc", zre.data_ptr(), zim.data_ptr(),
           st_in.data_ptr(), y.data_ptr(), lock.data_ptr(), st_out.data_ptr(),
           None if unlocked is None else unlocked.data_ptr(), B, L, *key,
           int(cp.squelch_position == "after_pll"),
           params.ctypes.data_as(ctypes.c_void_p), params.size)
    pll_fir_agc.launches += 1
    return pll_state_from_rows(st_out), st_out[6], y, lock


pll_fir_agc.launches = 0


def pll_fir_agc_serial(chain_params, pll_state, agc_gain, z):
    """:func:`pll_fir_agc` on the serial kernel, which runs the PLL, FIR and
    AGC of a sample in turn, one thread a lane, on time-major planes.  No
    path calls it: the card checks and ``chip_smoke.py`` hold the
    decoupled kernel to it over whole passes and time the two in one run.
    CUDA tensors only."""
    cp = chain_params
    if not on_card("pll_fir_agc_serial", z[0].device):
        raise ValueError("pll_fir_agc_serial runs on a CUDA device only")
    key, (zre, zim), st_in, params = _kernel_args(cp, pll_state, agc_gain, z,
                                                  "pll_fir_agc_serial")
    dev = zre.device
    B, L = zre.shape
    # time-major planes: a warp reads and writes 32 neighbouring lanes
    xre = zre.t().contiguous()
    xim = zim.t().contiguous()
    y = torch.empty((L * cp.interp, B), dtype=torch.float32, device=dev)
    lock = torch.empty((L, B), dtype=torch.float32, device=dev)
    st_out = torch.empty_like(st_in)
    launch(dev, "pdt_pll_fir_agc_serial", xre.data_ptr(), xim.data_ptr(),
           st_in.data_ptr(), y.data_ptr(), lock.data_ptr(), st_out.data_ptr(),
           B, L, *key, int(cp.squelch_position == "after_pll"),
           params.ctypes.data_as(ctypes.c_void_p), params.size)
    pll_fir_agc_serial.launches += 1
    return pll_state_from_rows(st_out), st_out[6], y.t(), lock.t()


pll_fir_agc_serial.launches = 0


def launch_config(chain_params, device="cuda") -> dict:
    """The decoupled kernel's launch configuration for this chain: lanes
    per CTA, chunk samples, threads and dynamic shared memory bytes a CTA,
    registers and local (spill) bytes a thread, as the card reports
    them."""
    cp = chain_params
    return kernel_config(device, "pdt_pll_fir_agc_config", cp.interp,
                         len(polyphase(cp.taps, cp.interp)[0]),
                         int(cp.squelch_position == "after_pll"))

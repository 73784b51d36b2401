#!/usr/bin/env python3
"""Stage-level ablation of the fused demodulation body on the card.

Counterpart of ``tools/ablate_fused.py`` (``make_fused``) of the JAX
package: the pre-round-5b fused body (PLL -> polyphase FIR -> AGC ->
16-deep value and time rings -> Gardner with a ring-served mid-bit read ->
Manchester; separate Gardner ``prev_bit`` and Manchester ``mcur``; three
output planes) with stages stubbed by flags, to attribute the per-step
cost: PLL, FIR+AGC, ring bookkeeping, Gardner+Manchester, output stores.
The flags become the template mask of ``csrc/ablate_fused.cu``; a stubbed
stage keeps the JAX stand-ins, and without ``store`` only the first step of
each window stores.  POES TIP at 50 kHz, as in the JAX tool.

- :func:`ablate_fused` is the entry point.  A CUDA tensor launches the
  hand-written kernel or raises; a CPU tensor runs :func:`ablate_fused_ref`,
  the plain PyTorch version.  ``ablate_fused.launches`` counts launches.
  The kernel stages its 32 lanes a CTA in chunks of 48 steps, each serial
  stage (PLL; AGC; rings, Gardner and Manchester) on its own warp a chunk
  apart, the FIR and the PLL's input terms on four more
  (:func:`ablate_fused_launch_config`).
- :func:`ablate_fused_serial` launches the serial kernel, one thread a
  lane running every stage of a step in turn: the staged kernel's
  card-side oracle and timing baseline, on no path.
- :func:`main` times every variant on one draw of the inputs: a warm
  call, then the median of 3 (CUDA events on the card), each into output
  buffers allocated and zeroed before the timing.

    python -m project_desert_tortoise_tpu_torch.tools.ablate_fused \\
        [--steps 118784] [--s 1] [--window 1024] [--only NAME] [--device cuda]
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import numpy as np
import torch

from project_desert_tortoise_tpu_torch import chain
from project_desert_tortoise_tpu_torch.ops import fastmath
from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    AGC_MAX_GAIN, AGC_MIN_GAIN, AGC_REFERENCE, agc_step, lane_const,
    polyphase)
from project_desert_tortoise_tpu_torch.ops.kernels.common import (
    check, kernel_config, launch, on_card, one_device)
from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
    ring_read)
from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
    pll_param_block)
from project_desert_tortoise_tpu_torch.tools.ablate_kernel import (
    LANES, check_window, median_ns_per_step)
from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

RING = 16
# stage bits of the template mask in csrc/ablate_fused.cu
FLAG_BITS = {"pll": 1, "fir": 2, "ring": 4, "gm": 8, "store": 16}
_FULL = frozenset(FLAG_BITS)
# the JAX tool's variants, in its order (tools/ablate_fused.py:252-262)
VARIANTS = {
    "full": _FULL,
    "no_pll": _FULL - {"pll"},
    "no_fir": _FULL - {"fir"},
    "no_ring": _FULL - {"ring", "gm"},
    "no_gm": _FULL - {"gm"},
    "no_store": _FULL - {"store"},
    "pll_only": frozenset({"pll", "store"}),
    "none": frozenset(),
}


@functools.lru_cache(maxsize=1)
def chain_params():
    """POES TIP at 50 kHz, built once (not in the timed calls)."""
    return chain.make_params(POES_TIP, 50000.0)


def n_state(cp) -> int:
    """The JAX tool's state planes: PLL 6, FIR history, gain, two rings,
    Gardner 3, Manchester 5 (73 for POES)."""
    return 6 + len(polyphase(cp.taps, cp.interp)[0]) + 1 + 2 * RING + 3 + 5


def inputs(steps: int, S: int, device):
    """The JAX tool's inputs (ablate_fused.py:221-224): re, im and tn as
    time-major (steps, S*128) float32 planes of ``default_rng(0)`` normal
    draws in that order, and the state (73, S*128) at 0.1."""
    rng = np.random.default_rng(0)
    B = S * LANES
    xs = [torch.from_numpy(rng.standard_normal((steps, B)).astype(
        np.float32)).to(device) for _ in range(3)]
    state = torch.full((n_state(chain_params()), B), float(np.float32(0.1)),
                       dtype=torch.float32, device=device)
    return xs, state


def ablate_fused_ref(name: str, re, im, tn, state, window: int):
    """Plain PyTorch version of :func:`ablate_fused`, on any device: the
    JAX tool's body (ablate_fused.py:86-197) step by step on all lanes.
    Rows that the variant does not store are 0."""
    flags = VARIANTS[name]
    cp = chain_params()
    poly = polyphase(cp.taps, cp.interp)
    interp, hist_len = cp.interp, len(poly[0])
    L = re.shape[0]
    check_window(L, window)
    f32 = torch.float32
    like = state[0]
    c = lambda v: lane_const(v, like)
    zero, eps, half = c(0.0), c(1e-7), c(0.5)
    k_pll = pll_ops.loop_consts(cp.pll, like)
    taps = [[c(v) for v in row] for row in poly]
    agc = (c(cp.agc_attack), c(cp.agc_decay), c(AGC_REFERENCE),
           c(AGC_MIN_GAIN), c(AGC_MAX_GAIN), zero)
    gg, lim, neg_lim = (c(cp.gardner_gain), c(cp.gardner_err_limit),
                        c(-np.float32(cp.gardner_err_limit)))
    step = c(cp.step_size)
    half_step = c(np.float32(cp.step_size) / np.float32(2.0))
    thr = c(cp.resync_threshold)

    rows = list(state.unbind(0))
    pll_s, rows = rows[:6], rows[6:]
    hist, rows = rows[:hist_len], rows[hist_len:]
    gain, rows = rows[0], rows[1:]
    ring_v, ring_t, rows = rows[:RING], rows[RING:2 * RING], rows[2 * RING:]
    ns, half_raw, prev_bit, clockmod, evenodd, mcur, mprev, mprevprev = rows

    out = torch.zeros((3, L, like.shape[0]), dtype=f32, device=like.device)
    for i in range(L):
        if "pll" in flags:
            st = pll_ops.PLLState(*pll_s[:5], locked=pll_s[5] > half)
            new, (soft, _) = pll_ops.step_with_terms(
                k_pll, st, re[i], im[i], *pll_ops.input_terms(re[i], im[i]))
            pll_s = [*new[:5], new.locked.to(f32)]
        else:
            soft = re[i]
            pll_s = [p + eps for p in pll_s]
        hist = [soft] + hist[:-1]
        if "fir" in flags:
            produced = []
            for p in range(interp):
                y = zero
                for m in range(hist_len):
                    y = y + taps[p][m] * hist[m]
                y, gain = agc_step(y, gain, *agc)
                produced.append(y)
        else:
            produced = [soft * half] * interp
            gain = gain + eps
        if "ring" in flags:
            ring_v = produced[::-1] + ring_v[:RING - interp]
            ring_t = [tn[i]] * interp + ring_t[:RING - interp]
        else:
            ring_v = [r + eps for r in ring_v]
            ring_t = [r + eps for r in ring_t]
        if "gm" in flags:
            j_hi = i * interp + interp - 1
            target = torch.round(ns)
            emit_sym = target <= j_hi
            tgt_i = torch.clamp(target.to(torch.int32), min=0)
            age = torch.clamp(j_hi - tgt_i, 0, RING - 1)
            cur = ring_read(ring_v, age, zero)
            sym_t = ring_read(ring_t, age, zero)
            hidx = torch.round(half_raw).to(torch.int32)
            hage = j_hi - hidx
            h_in = (hidx >= 0) & (hage >= 0) & (hage < RING)
            hval = torch.where(
                h_in, ring_read(ring_v, torch.clamp(hage, 0, RING - 1), zero),
                zero)
            err = torch.clamp(gg * (cur - prev_bit) * hval, neg_lim, lim)
            ns_adj = ns - err
            ns = torch.where(emit_sym, ns_adj + step, ns)
            half_raw = torch.where(emit_sym, ns_adj + half_step, half_raw)
            prev_bit = torch.where(emit_sym, cur, prev_bit)
            prevprev, prev = mprev, mcur
            strong = (torch.abs(prevprev) > thr) & (torch.abs(prev) > thr)
            resync = ((evenodd != clockmod)
                      & (fastmath.sign(prevprev) == fastmath.sign(prev))
                      & strong)
            clockmod_n = torch.where(resync, evenodd, clockmod)
            boundary = evenodd == clockmod_n
            bit = torch.where(torch.abs(prev) > torch.abs(cur),
                              (prev > 0).to(f32), 1.0 - (cur > 0).to(f32))
            emit_bit = emit_sym & boundary
            clockmod = torch.where(emit_sym, clockmod_n, clockmod)
            evenodd = torch.where(emit_sym,
                                  torch.remainder(evenodd + 1.0, 2.0), evenodd)
            mcur = torch.where(emit_sym, cur, mcur)
            mprev = torch.where(emit_sym, prev, mprev)
            mprevprev = torch.where(emit_sym, prevprev, mprevprev)
        else:
            bit, sym_t, emit_bit = produced[0], tn[i], soft > 0
            ns = ns + eps
        if "store" in flags or i % window == 0:
            out[0, i], out[1, i], out[2, i] = bit, sym_t, emit_bit.to(f32)
    st_out = torch.stack(pll_s + hist + [gain] + ring_v + ring_t
                         + [ns, half_raw, prev_bit, clockmod, evenodd, mcur,
                            mprev, mprevprev])
    return (*out.unbind(0), st_out)


@functools.lru_cache(maxsize=1)
def _param_block() -> np.ndarray:
    """The float block of AblateParams in csrc/ablate_fused.cu."""
    cp = chain_params()
    return np.concatenate([
        pll_param_block(cp.pll),
        np.array([cp.agc_attack, cp.agc_decay, cp.step_size,
                  cp.gardner_gain, cp.gardner_err_limit,
                  cp.resync_threshold], np.float32),
        np.asarray(polyphase(cp.taps, cp.interp), np.float32).ravel()])


def output_buffers(L: int, B: int, device):
    """Zeroed output planes (3, L, B) and a final-state buffer (73, B) for
    :func:`ablate_fused`'s `out`."""
    return (torch.zeros((3, L, B), dtype=torch.float32, device=device),
            torch.empty((n_state(chain_params()), B), dtype=torch.float32,
                        device=device))


# lanes a CTA of the staged kernel
CTA_LANES = 32


def _launch(entry: str, name: str, re, im, tn, state, window: int, out):
    """Launch `entry` (pdt_ablate_fused or its serial twin) for variant
    `name` on CUDA tensors; returns what :func:`ablate_fused` returns."""
    dev = state.device
    flags = VARIANTS[name]
    cp = chain_params()
    L, B = re.shape
    check_window(L, window)
    for nm, t in (("re", re), ("im", im), ("tn", tn)):
        check(nm, t, (L, B), (torch.float32,), dev)
    check("state", state, (n_state(cp), B), (torch.float32,), dev)
    planes = [t.contiguous() for t in (re, im, tn)]
    st_in = state.contiguous()
    if out is None:
        out = output_buffers(L, B, dev)
    out, st_out = out
    check("out", out, (3, L, B), (torch.float32,), dev)
    check("out state", st_out, tuple(st_in.shape), (torch.float32,), dev)
    if not (out.is_contiguous() and st_out.is_contiguous()):
        raise ValueError("ablate_fused's out buffers must be contiguous")
    p = _param_block()
    launch(dev, entry, sum(FLAG_BITS[f] for f in flags),
           *(t.data_ptr() for t in planes), st_in.data_ptr(),
           *(o.data_ptr() for o in out), st_out.data_ptr(), B, L, window,
           p.ctypes.data_as(ctypes.c_void_p), p.size)
    return (*out.unbind(0), st_out)


def ablate_fused(name: str, re, im, tn, state, window: int, out=None):
    """Variant `name` over time-major (L, B) float32 planes re, im, tn from
    `state` (73, B); returns (bit, bit_time, emit) (L, B) planes and the
    final state.  Rows a variant does not store are 0 (``no_store`` stores
    the first step of each window).  `out`: on the card, buffers from
    :func:`output_buffers` to write into (so that a timed call allocates
    and zeroes nothing), else fresh ones.  CPU tensors run
    :func:`ablate_fused_ref`, which allocates its own.  The planes and the
    state must lie on one device."""
    if not on_card("ablate_fused", one_device("ablate_fused", re, im, tn,
                                              state)):
        return ablate_fused_ref(name, re, im, tn, state, window)
    got = _launch("pdt_ablate_fused", name, re, im, tn, state, window, out)
    ablate_fused.launches += 1
    return got


ablate_fused.launches = 0


def ablate_fused_serial(name: str, re, im, tn, state, window: int,
                        out=None):
    """:func:`ablate_fused` on the serial kernel, one thread a lane: the
    staged kernel's oracle and timing baseline, on no path.  CUDA tensors
    only."""
    if not on_card("ablate_fused_serial",
                   one_device("ablate_fused_serial", re, im, tn, state)):
        raise ValueError("ablate_fused_serial runs on a CUDA device only")
    got = _launch("pdt_ablate_fused_serial", name, re, im, tn, state, window,
                  out)
    ablate_fused_serial.launches += 1
    return got


ablate_fused_serial.launches = 0

# ablate_fused_launch_config's fields, in the order of
# pdt_ablate_fused_config's out[]
LAUNCH_CONFIG_FIELDS = ("lanes_per_cta", "chunk_steps", "threads",
                        "fir_warps", "smem_bytes", "ctas_per_sm",
                        "registers", "local_bytes", "serial_registers",
                        "serial_local_bytes", "pll_warp", "agc_warp",
                        "gardner_warp", "loader_warp", "fir_warp_mask")


def ablate_fused_launch_config(name: str, device="cuda") -> dict:
    """The staged kernel's launch configuration for variant `name`, as the
    card reports it: lanes a CTA, steps a chunk, threads and FIR warps a
    CTA, dynamic shared memory bytes, resident CTAs an SM, registers and
    local (spill) bytes a thread; the serial kernel's registers and local
    bytes; and each stage's warp (the FIR warps as a bit mask)."""
    flags = sum(FLAG_BITS[f] for f in VARIANTS[name])
    return kernel_config(device, "pdt_ablate_fused_config", flags,
                         fields=LAUNCH_CONFIG_FIELDS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ablate_fused")
    ap.add_argument("--s", type=int, default=1, help="lanes = S x 128")
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=118784)
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but CUDA is not available")
    clock = "" if dev.type == "cuda" else " (cpu, plain version)"
    # every variant reads the same planes: draw them once
    xs, state = inputs(args.steps, args.s, dev)
    for name in VARIANTS:
        if args.only and args.only not in name:
            continue
        if dev.type == "cuda":
            out = output_buffers(args.steps, args.s * LANES, dev)
        else:
            out = None
        ns = median_ns_per_step(
            lambda: ablate_fused(name, *xs, state, args.window, out),
            args.steps, dev)
        print(f"{name:10s} S={args.s} {ns:8.1f} ns/step{clock}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Ablation microbenchmark: the per-step cost of carried-state loop bodies
of increasing complexity on the card.

Counterpart of ``tools/ablate_kernel.py`` (``build_variant``) of the JAX
package: a generic loop that carries ``n_carry`` float32 values a lane,
reads one time-major input plane per step, runs one of the bodies below
and stores ``n_out`` planes, to locate where a serial chain's time goes:
loop overhead, carry width, PLL transcendentals, multiply-add chains, ring
reads, stores.

- :func:`ablate_kernel` is the entry point.  A CUDA tensor launches the
  hand-written kernel ``csrc/ablate_kernel.cu`` or raises; a CPU tensor
  runs :func:`ablate_kernel_ref`, the plain PyTorch version (a loop over
  the steps, all lanes at once, in the kernel's float32 operations).
  ``ablate_kernel.launches`` counts kernel launches.  The kernel gives a
  CTA 32 lanes, one a thread of each warp: the empty variants spread
  their carried values over warps and read nothing; the others read the
  input from rows a loader warp stages in shared memory a 256-step chunk
  ahead, the PLL's input terms and the ring's ages computed on two more
  warps a chunk ahead (:func:`ablate_kernel_launch_config`).
- :func:`ablate_kernel_serial` launches the serial kernel, one thread a
  lane reading its input from device memory each step: the card-side
  oracle and timing baseline, on no path.
- :func:`ns_per_step` times one variant as the JAX tool's ``run`` does: a
  warm call, then the median of 3 (CUDA events on the card).

    python -m project_desert_tortoise_tpu_torch.tools.ablate_kernel \\
        [--steps 131072] [--s 1] [--window 1024] [--only NAME] [--device cuda]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from project_desert_tortoise_tpu_torch import chain
from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.ops.kernels.common import (
    check, kernel_config, launch, on_card, one_device)
from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
    ring_read)
from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
    pll_param_block)
from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

LANES = 128


class Variant(NamedTuple):
    n_carry: int
    n_in: int
    n_out: int


# the JAX tool's variants, in its order (tools/ablate_kernel.py:151-160);
# the index is the variant code of csrc/ablate_kernel.cu
VARIANTS = {
    "empty_c1": Variant(1, 1, 0),
    "empty_c8": Variant(8, 1, 0),
    "empty_c73": Variant(73, 1, 0),
    "mac26": Variant(1, 1, 0),
    "mac78": Variant(1, 1, 0),
    "pll": Variant(6, 1, 1),
    "ring16": Variant(17, 1, 0),
    "store3": Variant(1, 1, 3),
}
RING = 16


def pll_params() -> pll_ops.PLLParams:
    """The PLL of the `pll` variant: POES TIP at 50 kHz, as the JAX tool."""
    return chain.make_params(POES_TIP, 50000.0).pll


@functools.lru_cache(maxsize=1)
def _param_block() -> np.ndarray:
    """The kernel's float parameter block, built once (not in the timed
    calls)."""
    return pll_param_block(pll_params())


def inputs(name: str, steps: int, S: int, device):
    """The JAX tool's inputs (ablate_kernel.py:74-75): `n_in` time-major
    (steps, S*128) planes of ones and the carry (n_carry, S*128) at 0.1."""
    v = VARIANTS[name]
    B = S * LANES
    ins = [torch.ones((steps, B), dtype=torch.float32, device=device)
           for _ in range(v.n_in)]
    state = torch.full((v.n_carry, B), float(np.float32(0.1)),
                       dtype=torch.float32, device=device)
    return ins, state


def varied_inputs(name: str, steps: int, B: int, seed: int = 0,
                  device="cpu"):
    """Seeded inputs beside the tool's constant ones, for the checks: the
    plane uniform in [-3, 20] (ring16's ages clamped at 0 and at 15 and
    everything between), the carry uniform in [-1, 1].  For `pll` the second
    half of the plane is constant (1.0) and the carry a PLL state: phases and
    avg_phase spread (some lanes sweep), freq within the band, the sweep
    step of either sign, the lock signal spread from 0 to just under the
    threshold (the constant stretch locks some lanes: `locked` goes from 0
    to 1 within the run), every eighth lane locked from the start."""
    v = VARIANTS[name]
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 20.0, (steps, B))
    state = rng.uniform(-1.0, 1.0, (v.n_carry, B))
    if name == "pll":
        pp = pll_params()
        x[steps // 2:] = 1.0
        state[0] = rng.uniform(-np.pi, np.pi, B)
        state[1] = rng.uniform(-0.5, 0.5, B) * pp.max_freq
        state[2] = np.linspace(0.0, pp.lock_threshold * 0.999, B)
        state[3] = rng.uniform(0.0, np.pi / 2 + 0.1, B)
        state[4] = np.where(rng.random(B) < 0.5, -1.0, 1.0) * pp.sweep_step
        state[5] = (np.arange(B) % 8 == 7).astype(np.float64)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return [as_t(x)], as_t(state)


def _body(name: str, carry: list, x, k: dict):
    """One step of variant `name` on (B,) lanes: returns (carry, outs)."""
    if name.startswith("empty"):
        return [c + k["eps"] for c in carry], []
    if name.startswith("mac"):
        acc = carry[0]
        for _ in range(int(name[3:])):
            acc = acc * k["mac"] + x
        return [acc] + carry[1:], []
    if name == "pll":
        st = pll_ops.PLLState(*carry[:5], locked=carry[5] > k["half"])
        new, (soft, _) = pll_ops.step_with_terms(
            k["pll"], st, x, x, *pll_ops.input_terms(x, x))
        return [*new[:5], new.locked.to(torch.float32)], [soft]
    if name == "ring16":
        age = torch.clamp(x.to(torch.int32), 0, RING - 1)
        acc = ring_read(carry[:RING], age, k["zero"])
        return [x + acc] + carry[:RING - 1] + carry[RING:], []
    y = x + carry[0]                               # store3
    return carry, [y, y * k["two"], y * k["three"]]


def ablate_kernel_ref(name: str, ins, state, window: int):
    """Plain PyTorch version of :func:`ablate_kernel`, on any device."""
    v = VARIANTS[name]
    L = ins[0].shape[0]
    check_window(L, window)
    like = state[0]
    full = lambda val: torch.full_like(like, float(np.float32(val)))
    k = dict(eps=full(1e-6), mac=full(1.0001), half=full(0.5),
             zero=full(0.0), two=full(2.0), three=full(3.0),
             pll=pll_ops.loop_consts(pll_params(), like))
    carry = list(state.unbind(0))
    outs = [[] for _ in range(v.n_out)]
    for i in range(L):
        carry, o = _body(name, carry, ins[0][i], k)
        for lst, val in zip(outs, o):
            lst.append(val)
    return [torch.stack(o) for o in outs], torch.stack(carry)


def check_window(L: int, window: int):
    if window <= 0 or L % window:
        raise ValueError(f"steps {L} is not a multiple of the window "
                         f"{window}")


def _launch(entry: str, name: str, ins, state, window: int):
    """Launch `entry` (pdt_ablate_kernel or its serial twin) for variant
    `name` on CUDA tensors; returns what :func:`ablate_kernel` returns."""
    v = VARIANTS[name]
    dev = state.device
    L, B = ins[0].shape
    check_window(L, window)
    if len(ins) != v.n_in:
        raise ValueError(f"{name} reads {v.n_in} input planes")
    check("ins[0]", ins[0], (L, B), (torch.float32,), dev)
    check("state", state, (v.n_carry, B), (torch.float32,), dev)
    x = ins[0].contiguous()
    st_in = state.contiguous()
    out = torch.empty((v.n_out, L, B), dtype=torch.float32, device=dev)
    st_out = torch.empty_like(st_in)
    p = _param_block()
    launch(dev, entry, list(VARIANTS).index(name), x.data_ptr(),
           st_in.data_ptr(), out.data_ptr() if v.n_out else None,
           st_out.data_ptr(), B, L, p.ctypes.data_as(ctypes.c_void_p),
           p.size)
    return list(out.unbind(0)), st_out


def ablate_kernel(name: str, ins, state, window: int):
    """Variant `name` over the time-major (L, B) input planes `ins` from
    the carry `state` (n_carry, B); returns (outs: n_out (L, B) planes,
    final carry (n_carry, B)).  The body stores every step, so `window`
    (which must divide L) changes nothing but the check, as in the JAX
    tool.  CPU tensors run :func:`ablate_kernel_ref`; the planes and the
    carry must lie on one device."""
    dev = one_device("ablate_kernel", *ins, state)
    if not on_card("ablate_kernel", dev):
        return ablate_kernel_ref(name, ins, state, window)
    got = _launch("pdt_ablate_kernel", name, ins, state, window)
    ablate_kernel.launches += 1
    return got


ablate_kernel.launches = 0


def ablate_kernel_serial(name: str, ins, state, window: int):
    """:func:`ablate_kernel` on the serial kernel, one thread a lane: the
    staged kernel's oracle and timing baseline, on no path.  CUDA tensors
    only."""
    if not on_card("ablate_kernel_serial",
                   one_device("ablate_kernel_serial", *ins, state)):
        raise ValueError("ablate_kernel_serial runs on a CUDA device only")
    got = _launch("pdt_ablate_kernel_serial", name, ins, state, window)
    ablate_kernel_serial.launches += 1
    return got


ablate_kernel_serial.launches = 0

# lanes a CTA and steps a chunk of the staged kernel
CTA_LANES = 32
CHUNK_STEPS = 256
# ablate_kernel_launch_config's fields, in the order of
# pdt_ablate_kernel_config's out[]
LAUNCH_CONFIG_FIELDS = ("lanes_per_cta", "chunk_steps", "threads",
                        "smem_bytes", "ctas_per_sm", "registers",
                        "local_bytes", "serial_registers",
                        "serial_local_bytes", "chain_warp_mask",
                        "b_warp_mask", "loader_warp")


def ablate_kernel_launch_config(name: str, device="cuda") -> dict:
    """The staged kernel's launch configuration for variant `name`, as the
    card reports it: lanes a CTA, steps a chunk (0 where nothing is
    staged), threads a CTA, dynamic shared memory bytes, resident CTAs an
    SM, registers and local (spill) bytes a thread; the serial kernel's
    registers and local bytes; the warps that run the chain and the B
    warps as bit masks, the loader's warp (-1: none)."""
    return kernel_config(device, "pdt_ablate_kernel_config",
                         list(VARIANTS).index(name),
                         fields=LAUNCH_CONFIG_FIELDS)


def median_ns_per_step(fn, steps: int, device) -> float:
    """A warm call of fn, then the median of 3 timed calls, in ns per step:
    CUDA events on a CUDA device, the host clock on the CPU.  On the card
    the calls are queued back to back with one synchronise at the end, so
    the host's work before each launch overlaps the previous call's kernel
    and each event window holds the device's work alone."""
    if device.type != "cuda":
        fn()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) / steps * 1e9
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(3)]
    fn()
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize(device)
    times = [start.elapsed_time(stop) * 1e-3 for start, stop in events]
    return float(np.median(times)) / steps * 1e9


def ns_per_step(name: str, steps: int, S: int, window: int,
                device="cuda") -> float:
    dev = torch.device(device)
    ins, state = inputs(name, steps, S, dev)
    return median_ns_per_step(lambda: ablate_kernel(name, ins, state, window),
                              steps, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ablate_kernel")
    ap.add_argument("--steps", type=int, default=131072)
    ap.add_argument("--s", type=int, default=1, help="lanes = S x 128")
    ap.add_argument("--window", type=int, default=1024,
                    help="must divide --steps; kept for the JAX tool's flags, "
                    "no effect on the card (the body stores every step)")
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but CUDA is not available")
    clock = "" if dev.type == "cuda" else " (cpu, plain version)"
    for name, v in VARIANTS.items():
        if args.only and args.only not in name:
            continue
        ns = ns_per_step(name, args.steps, args.s, args.window, dev)
        print(f"{name:12s} S={args.s} carry={v.n_carry:3d} "
              f"{ns:8.1f} ns/step{clock}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""What each of the staged ``ablate_fused`` kernel's four departures from
the plain composition gains on the card.

The staged kernel (csrc/ablate_fused.cu) computes the PLL input terms a
tick ahead on the FIR warps (stage B), takes the sine and cosine from one
``sincosf``, divides once an arctangent and updates the Manchester parity
off ``fmodf``'s long path.  ``-DPDT_ABLATE_PLAIN=mask`` undoes them: 1
stage B, 2 ``sincosf``, 4 the one-division arctangent, 8 the parity path;
7 makes the PLL warp's step ``pdt_common.cuh``'s ``pll_step`` operation for
operation.  This script builds the source once a mask (0, the library's
build, then 1, 2, 4, 8, 7 and 15), all ``nvcc`` at once, each into a
library of its own under ``_build/``; runs every variant of the tool on
each build over the tool's inputs, holding each build's outputs and final
state to build 0's bit for bit; and times the builds in turns (0 first,
then the others, then back), ``--reps`` rounds, with CUDA events.  Prints
one JSON line a build: the median ms a variant, their sum, and this
build's ms over build 0's for each variant (above 1 where what it undoes
gains); then the card's name and power limit.  Needs a card and ``nvcc``:

    python -m project_desert_tortoise_tpu_torch.tools.ablate_fused_design
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess

import torch

from project_desert_tortoise_tpu_torch.ops.kernels import build
from project_desert_tortoise_tpu_torch.tools import ablate_fused as AF

SOURCE = build.CSRC / "ablate_fused.cu"
# the masks built, and what each undoes
MASKS = {0: [], 1: ["stage_b"], 2: ["sincosf"], 4: ["one_division_atan2"],
         8: ["parity_path"], 7: ["stage_b", "sincosf", "one_division_atan2"],
         15: ["stage_b", "sincosf", "one_division_atan2", "parity_path"]}


def build_all() -> dict:
    """{mask: the loaded library built with -DPDT_ABLATE_PLAIN=mask}."""
    h = hashlib.sha256()
    for src in (SOURCE, *build.HEADERS):
        h.update(src.read_bytes())
    h.update(" ".join(build.NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    paths = {m: build.BUILD_DIR / f"ablate_fused_plain{m}_{key}.so"
             for m in MASKS}
    procs = {m: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, f"-DPDT_ABLATE_PLAIN={m}", "-shared",
         "-o", str(so), str(SOURCE)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for m, so in paths.items() if not so.exists()}
    for m, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -DPDT_ABLATE_PLAIN={m} failed:\n{out}")
    libs = {}
    for m, so in paths.items():
        lib = ctypes.CDLL(str(so))
        lib.pdt_ablate_fused.argtypes = build._SIGNATURES["pdt_ablate_fused"]
        lib.pdt_ablate_fused.restype = ctypes.c_int
        libs[m] = lib
    return libs


def run(lib, name: str, xs, state, window: int, out) -> None:
    """Variant `name` on `lib`'s staged kernel into `out`
    (:func:`AF.output_buffers`), on the current stream."""
    L, B = xs[0].shape
    p = AF._param_block()
    planes, st_out = out
    rc = lib.pdt_ablate_fused(
        sum(AF.FLAG_BITS[f] for f in AF.VARIANTS[name]),
        *(t.data_ptr() for t in xs), state.data_ptr(),
        *(o.data_ptr() for o in planes), st_out.data_ptr(), B, L, window,
        p.ctypes.data_as(ctypes.c_void_p), p.size,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pdt_ablate_fused {name}: CUDA error {rc}")


def timed(fn) -> float:
    """ms of one call of `fn` on the card."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ablate_fused_design")
    ap.add_argument("--s", type=int, default=33, help="lanes = S x 128")
    ap.add_argument("--steps", type=int, default=118784)
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_fused_design needs a CUDA card")
    dev = torch.device("cuda")
    libs = build_all()
    xs, state = AF.inputs(args.steps, args.s, dev)
    xs = [t.contiguous() for t in xs]
    state = state.contiguous()
    B = args.s * AF.LANES
    want, got = (AF.output_buffers(args.steps, B, dev) for _ in range(2))
    ms = {m: {} for m in MASKS}
    for name in AF.VARIANTS:
        want[0].zero_()
        run(libs[0], name, xs, state, args.window, want)
        for m in MASKS:
            got[0].zero_()
            run(libs[m], name, xs, state, args.window, got)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"PDT_ABLATE_PLAIN={m} {name}: not "
                                     "bit-exact against the library's build")
        times = {m: [] for m in MASKS}
        order = list(MASKS)
        for r in range(args.reps):
            for m in order + order[::-1]:
                times[m].append(timed(lambda: run(
                    libs[m], name, xs, state, args.window, got)))
        for m in MASKS:
            ms[m][name] = statistics.median(times[m])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    for m, undoes in MASKS.items():
        print(json.dumps(dict(
            plain_mask=m, undoes=undoes, shape=[B, args.steps],
            window=args.window, reps=2 * args.reps, bit_exact=True,
            ms=ms[m], ms_sum=sum(ms[m].values()),
            over_build_0={v: ms[m][v] / ms[0][v] for v in AF.VARIANTS},
            card=card)), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

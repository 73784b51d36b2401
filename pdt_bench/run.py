"""The port's benchmark: one run of one cell.

    python3 -m pdt_bench.run --workload poes_pass --seed 7 --seconds 51 \\
        --trace 0

from the root of a checkout holding ``BENCHMARK.json``, this folder and
the program (``project_desert_tortoise_tpu_torch``), on a machine with as
many CUDA cards as the cell asks for.  It makes the cell's pass from the
seed, warms up with one full pass, decodes passes back to back for
``--seconds``, checks sampled passes against the plain reference of the
traffic's entry (``entries/<entry>.py``), and prints one JSON line last on standard output: the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics
read over a few more passes under the profiler.  Without the cards, or if
a forbidden module was loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# a fixed cache directory inside the checkout, so that only a checkout's
# first run compiles
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from pdt_bench import harness
    cell = harness.load_cell(ROOT, args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); found "
            f"{found}")
        return 2
    out = harness.run_cell(ROOT, cell, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START, log)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    print(json.dumps({"work": out["work"]}), flush=True)
    for k, v in out["check"].items():
        log(f"{k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result_line(out)), flush=True)
    return 0


def result_line(out: dict) -> dict:
    """The last line's object: the result's keys, then the check's
    numbers beside their limits, last."""
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["check"] = out["check"]
    return line


if __name__ == "__main__":
    sys.exit(main())

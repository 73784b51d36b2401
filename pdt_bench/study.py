"""The readings that the limits of a cell's check were set from.

    python3 -m pdt_bench.study --workload poes_pass --seeds 1 2 3 \\
        --control-seeds 1 2 3

For each seed: the cell's pass made from the seed, one pass of the program
through the cell's entry on the card, and the entry's plain reference in
float32 over the same planes; the comparison's numbers are the
sound readings.  For each control seed: the reference computed in bfloat16,
put in the program's place and compared the same way; its numbers are the
control's readings.  The references run in worker processes on the host's
cores while the card decodes the next seed.  One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def reference_reading(cfg, tr, p, gain: float, got, control: bool):
    """Compare `got` (the program's frames, or None for the control) with
    the entry's float32 reference; for the control, the bfloat16
    reference's frames take the program's place."""
    import numpy as np
    import torch
    from pdt_bench import compare, harness, reference
    torch.set_num_threads(1)
    entry = harness.load_entry(ROOT, tr["entry"])
    t_ext = reference.time_axis(len(p.re16), cfg["fs"])
    ref = entry.reference(cfg, tr["entry_args"], p, t_ext, gain)
    if control:
        got = entry.reference(cfg, tr["entry_args"], p, t_ext, gain,
                              reference.Arith(torch.bfloat16))
    out = compare.pair(ref, got, compare.window_s(cfg))
    out["frames_reference"] = len(ref)
    out["frames_compared"] = len(got)
    return {k: (float(v) if isinstance(v, np.floating) else v)
            for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args(argv)

    import torch
    from pdt_bench import harness, reference, synth
    cell = harness.load_cell(ROOT, args.workload)
    cfg, tr = cell.cfg, cell.traffic
    dev = torch.device("cuda")
    entry = harness.load_entry(ROOT, tr["entry"])
    ctx = multiprocessing.get_context("spawn")
    jobs = []
    with ctx.Pool(args.workers) as pool:
        for seed, control in ([(s, False) for s in args.seeds]
                              + [(s, True) for s in args.control_seeds]):
            p = synth.make_pass(cfg, seed & (2 ** 64 - 1), dev)
            gain = reference.static_gain(p.re16, p.im16,
                                         cfg["gain_probe_samples"],
                                         cfg["static_gain_level"])
            got = None
            if not control:
                t_ext = reference.time_axis(len(p.re16), cfg["fs"])
                program = entry.build(cfg, tr["entry_args"], p, t_ext,
                                      gain, dev)
                got = entry.frames(program())
                del program
            jobs.append((seed, control, pool.apply_async(
                reference_reading, (cfg, tr, p, gain, got, control))))
        for seed, control, job in jobs:
            r = job.get()
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": "control" if control else "sound",
                              **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

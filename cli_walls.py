#!/usr/bin/env python3
"""Wall seconds of the port's two fast CLIs, ``demod_poes --fast`` and
``demod_argos --fast``, on the 12-minute passes of ``chip_smoke.py``, for
two or more checkouts of the repository timed in turns on one card.

    python3 cli_walls.py ROOT [ROOT ...] [--pairs N] [--scan-branch]
                         [--exact] [--gardner-scan] [--modes poes argos]

Each ROOT is a checkout.  One worker process a root imports that root's
``project_desert_tortoise_tpu_torch`` and runs the CLI on request; each
worker runs each CLI once first (kernel build and warm-up).  Then, for
each mode and each of ``--pairs`` rounds, the roots go in order and then
in reverse (two roots: A, B, B, A), so a drift of the host's load falls on
both alike.  A run is timed from WAV load to written file, as
``chip_smoke.py``'s ``main_path`` lines are.  ``--scan-branch`` times
``demodulate_blocked(use_pallas=False)`` instead (the scan branch of
``demod_blocks``, what the JAX package's ``--fast`` runs), from WAV load
to the frame list, as that branch's ``main_path`` lines are.  ``--exact``
times the CLIs without ``--fast`` (the exact chain; for ARGOS the float64
``argos`` mode), as ``chip_smoke.py``'s ``exact_cli`` and
``argos_exact_cli`` lines are; ``--gardner-scan`` times the exact chain's
Gardner kernel alone (``gardner_manchester_scan`` at one lane of a
chunk's quirks image with its mid-bit pointer stale inside it, as
``chip_smoke.py``'s ``exact_kernels`` has it: float32 for ``poes``, the
float64 instance for ``argos``), its mean device seconds a launch over
200 launches by CUDA events, in place of a wall; ``--modes`` picks the
passes.  Beside each
wall the worker reports what its process did in that time: CPU seconds
(user and system), major page faults (reads that waited on the disk) and
involuntary context switches (time the process was ready but another had
the core).

Prints one JSON line a run, then for each mode and root the median, the
quartiles and the spread (max - min) of its walls; with two roots, for
each mode the pairs (the i-th run of each) the second root won and
whether its slowest run beat the first root's fastest; then the card's
name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

from chip_smoke import card_line, synth_pass

# a worker: argv[1] is its root; each stdin line "mode wav out kind" runs
# that CLI with --fast (kind "fast"), without it (kind "exact") or
# demodulate_blocked on the scan branch (kind "scan") once and answers one
# JSON line on stdout (the CLI's own prints go to a buffer)
_WORKER = r"""
import contextlib, io, json, resource, sys, time
sys.path.insert(0, sys.argv[1])
from project_desert_tortoise_tpu_torch.apps import demod_argos, demod_poes
from project_desert_tortoise_tpu_torch.parallel.blocked import (
    demodulate_blocked)
from project_desert_tortoise_tpu_torch.utils import wav as W
from project_desert_tortoise_tpu_torch.utils.config import ARGOS, POES_TIP

def cli(mode, wav, out, fast=True):
    argv = [wav, *(["--fast"] if fast else []), "--out", out]
    if mode == "poes":
        return demod_poes.run(argv)
    try:
        demod_argos.main(argv)
    except SystemExit as done:
        return done.code
    raise AssertionError("demod_argos.main returned without an exit code")

def gardner_scan(mode):
    import numpy as np, torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    cfg, fs = (POES_TIP, 50000.0) if mode == "poes" else (ARGOS, 32000.0)
    dt, dev = getattr(torch, cfg.dtype), torch.device("cuda")
    p = chain.make_params(cfg, fs, quirks=True)
    cap = cfg.chunk_size * p.interp
    rng = np.random.default_rng(1)
    sym = rng.choice([-1.0, 1.0], int(cap / p.step_size) + 2)
    pos = (np.arange(cap) + rng.uniform(0, p.step_size)) / p.step_size
    x = torch.tensor(sym[pos.astype(int)] + 0.1 * rng.standard_normal(cap),
                     dtype=dt, device=dev)[None]
    t = (torch.arange(1, cap + 1, dtype=dt, device=dev) / fs)[None]
    f = lambda v: torch.full((1,), v, dtype=dt, device=dev)
    i = lambda v: torch.full((1,), v, dtype=torch.int32, device=dev)
    args = ((f(7.3), f(cap - 9.6), f(0.4), f(0.9), f(-0.8), f(0.7)),
            (i(0), i(1)), x, t, i(cap),
            sk.GardnerParams(p.step_size, p.gardner_err_limit,
                             p.gardner_gain, p.resync_threshold),
            chain.max_symbols(cap, p.step_size))
    sk.gardner_manchester_scan(*args)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)      # the launches queue behind it
    start.record()
    for _ in range(200):
        sk.gardner_manchester_scan(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 200 * 1e-3

def scan_branch(mode, wav):
    cfg = POES_TIP if mode == "poes" else ARGOS
    iq, t, fs, _ = W.load_iq_wav(wav, cfg.np_dtype())
    frames = demodulate_blocked(iq, t, fs, cfg, use_pallas=False,
                                device="cuda")
    return 0 if frames else 1

reply = sys.stdout
for line in sys.stdin:
    mode, wav, out, kind = line.split()
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        if kind == "gardner":
            rc, device_s = 0, gardner_scan(mode)
        else:
            rc = (scan_branch(mode, wav) if kind == "scan"
                  else cli(mode, wav, out, fast=kind == "fast"))
    wall = device_s if kind == "gardner" else time.time() - t0
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    print(json.dumps({
        "rc": rc, "wall_s": wall,
        "cpu_user_s": r1.ru_utime - r0.ru_utime,
        "cpu_sys_s": r1.ru_stime - r0.ru_stime,
        "major_faults": r1.ru_majflt - r0.ru_majflt,
        "invol_switches": r1.ru_nivcsw - r0.ru_nivcsw}), file=reply,
        flush=True)
"""


class Worker:
    """A process that runs the CLIs of one checkout on request."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _WORKER, self.root], text=True,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)

    def run(self, mode: str, wav: str, out: str, kind: str) -> dict:
        self.proc.stdin.write(f"{mode} {wav} {out} {kind}\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the worker of {self.root} ended")
        result = json.loads(line)
        if result["rc"] != 0:
            raise RuntimeError(f"{mode} run of {self.root} exited "
                               f"{result['rc']}")
        return result

    def close(self):
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()


def summary(walls) -> dict:
    q1, _, q3 = statistics.quantiles(walls, n=4)
    return dict(runs=len(walls), median_s=statistics.median(walls),
                q1_s=q1, q3_s=q3, spread_s=max(walls) - min(walls),
                walls_s=walls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkouts of the repository")
    ap.add_argument("--pairs", type=int, default=10,
                    help="rounds, each the roots in order then reversed")
    ap.add_argument("--scan-branch", action="store_true",
                    help="demodulate_blocked(use_pallas=False) in place of "
                    "the CLIs")
    ap.add_argument("--exact", action="store_true",
                    help="the CLIs without --fast (the exact chain)")
    ap.add_argument("--gardner-scan", action="store_true",
                    help="the exact chain's Gardner kernel's device "
                    "seconds a launch in place of a wall")
    ap.add_argument("--modes", nargs="+", choices=("poes", "argos"),
                    default=["poes", "argos"], help="the passes to time")
    args = ap.parse_args(argv)
    kind = ("scan" if args.scan_branch else "exact" if args.exact
            else "gardner" if args.gardner_scan else "fast")
    order = (args.roots + args.roots[::-1]) * args.pairs
    walls = {}
    workers = {root: Worker(root) for root in args.roots}
    try:
        with tempfile.TemporaryDirectory() as workdir:
            for mode in args.modes:
                wav = (synth_pass(mode, workdir)[0] if kind != "gardner"
                       else os.devnull)
                out = os.path.join(workdir, "out.txt")
                for w in workers.values():
                    w.run(mode, wav, out, kind)   # warm-up
                for turn, root in enumerate(order):
                    r = workers[root].run(mode, wav, out, kind)
                    walls.setdefault((mode, root), []).append(r["wall_s"])
                    print(json.dumps({"mode": mode, "root": root,
                                      "kind": kind, "turn": turn, **r}),
                          flush=True)
                if kind != "gardner":
                    os.remove(wav)
    finally:
        for w in workers.values():
            w.close()
    for (mode, root), w in walls.items():
        print(json.dumps({"mode": mode, "root": root, **summary(w)}))
    if len(args.roots) == 2:
        for mode in args.modes:
            a, b = (walls[mode, root] for root in args.roots)
            print(json.dumps({"mode": mode, "pairs": len(a),
                              "second_won": sum(y < x for x, y in zip(a, b)),
                              "second_all_faster": max(b) < min(a)}))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

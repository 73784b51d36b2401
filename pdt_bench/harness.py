"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything that belongs to a cell is found by name from ``BENCHMARK.json``:
its configuration file, ``traffic/<traffic>.json``, the program's entry
that the traffic names, ``entries/<entry>.py`` (the system under test and
its plain reference), the limits of its check ``limits/<workload>.json``
and a reader ``metrics/<name>.py`` for each per-layer metric.  The
program (the PyTorch/CUDA port) is imported only by the entries, for the
system under test, and by the traced run, for its launch hook.  Every cell reports every end-to-end metric; a
per-layer metric is read in the cells that its ``workloads`` lists, or in
every cell without that key.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

from pdt_bench import compare, reference, synth
from pdt_bench import trace as trace_mod

HERE = Path(__file__).resolve().parent
# modules that no run may load, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "project_desert_tortoise_tpu")


def forbidden_modules(names) -> List[str]:
    """The forbidden top-level names among module names."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


class Cell(NamedTuple):
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of root/BENCHMARK.json and its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    files = root / HERE.name
    load = lambda p: json.loads(Path(p).read_text())
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])]
    return Cell(workload, int(w["chips"]), load(root / conf["file"]),
                load(files / "traffic" / f"{w['traffic']}.json"),
                load(files / "limits" / f"{workload}.json"),
                bench["end_to_end"], layer)


def load_module(root: Path, kind: str, name: str):
    """The module root/pdt_bench/<kind>/<name>.py."""
    path = root / HERE.name / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"pdt_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(root: Path, name: str):
    """The entry entries/<name>.py (see its docstring for what it offers)."""
    return load_module(root, "entries", name)


def read_metric(root: Path, name: str, ctx) -> Optional[dict]:
    """Run the reader metrics/<name>.py on the traced sub-window."""
    return load_module(root, "metrics", name).read(ctx)


def window_stats(t0: float, starts, ends, samples: int) -> Dict[str, float]:
    """decode_msps: the samples of every pass over the time from the
    window's start to the end of its last pass; pass_p90_ms: the 90th
    percentile (linear between order statistics) of every pass's wall."""
    walls = np.asarray(ends) - np.asarray(starts)
    return {"decode_msps": len(walls) * samples / (ends[-1] - t0) / 1e6,
            "pass_p90_ms": float(np.percentile(walls, 90)) * 1e3}


def run_window(call: Callable, seconds: float, keep: Callable):
    """Passes back to back, one client, until `seconds` have passed since
    the window opened; the last pass starts before then and is waited
    for.  keep(k, frames) sees each pass's frames.  Returns (t0, starts,
    ends)."""
    starts, ends = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        s = time.perf_counter()
        frames = call()
        e = time.perf_counter()
        starts.append(s)
        ends.append(e)
        keep(len(ends) - 1, frames)
        if e >= deadline:
            return t0, starts, ends


class Reservoir:
    """A uniform sample of `size` passes' frames, drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.kept: Dict[int, list] = {}

    def __call__(self, k: int, frames):
        if k < self.size:
            self.kept[k] = frames
            return
        j = int(self.rng.integers(0, k + 1))
        if j < self.size:
            del self.kept[sorted(self.kept)[j]]
            self.kept[k] = frames


class TraceContext(NamedTuple):
    """What a per-layer reader reads."""
    trace: object               # trace.Trace of the traced passes
    passes: int
    launch_ms: Dict[str, float]  # each hand kernel's ms over those passes
    work: Optional[dict]        # the entry's pass_work: one pass's count
    power_limit_w: Optional[float]


def power_limit_w() -> Optional[float]:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run_cell(root: Path, cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, log) -> dict:
    """One run of `cell`; returns the result line's fields (without
    ``correct``'s verdict on forbidden modules, which the caller adds)."""
    import torch
    log(f"set-up: {time.perf_counter() - t_start:.3f} s to torch's import")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.cfg, cell.traffic
    t = time.perf_counter()
    p = synth.make_pass(cfg, seed & (2 ** 64 - 1), dev)
    log(f"set-up: pass made in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    n = len(p.re16)
    t_ext = reference.time_axis(n, cfg["fs"])
    gain = reference.static_gain(p.re16, p.im16, cfg["gain_probe_samples"],
                                 cfg["static_gain_level"])
    entry = load_entry(root, tr["entry"])
    program = entry.build(cfg, tr["entry_args"], p, t_ext, gain, dev)
    log(f"set-up: time axis, gain, program {time.perf_counter() - t:.3f} s")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    program()                        # one full pass of the cell's shapes
    log(f"set-up: warm-up pass {time.perf_counter() - t:.3f} s")
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    keep = Reservoir(tr["check_passes"], seed)
    t0, starts, ends = run_window(program, seconds, keep)
    passes = len(ends)
    out = {"work": {"samples_per_pass": n,
                    "payloads_expected": len(p.payloads),
                    **program.work, "passes": passes}}
    if cuda:
        torch.cuda.synchronize()
        out["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": cell.chips,
                         "memory_peak_bytes":
                             int(torch.cuda.max_memory_allocated())}
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    metrics = {}
    if trace:
        if not cuda:
            raise ValueError("a traced run needs a CUDA card")
        ctx = traced(program, tr["trace_passes"],
                     entry.pass_work(cfg, tr["entry_args"]))
        lo, hi = ctx.trace.window
        out["device"].update(busy_s=trace_mod.busy_s(ctx.trace),
                             window_s=hi - lo)
        out["breakdown"] = trace_mod.breakdown(ctx.trace)
        for m in cell.per_layer:
            v = read_metric(root, m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = v
    else:
        stats = window_stats(t0, starts, ends, n)
        stats["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": stats[m["name"]], "unit": m["unit"]}
    out["metrics"] = metrics
    gc.unfreeze()
    del program
    if cuda:
        torch.cuda.empty_cache()

    # the check, once the window has closed and the program's state is
    # freed: the entry's plain reference over the same request
    t = time.perf_counter()
    ref = entry.reference(cfg, tr["entry_args"], p, t_ext, gain)
    log(f"check: reference {time.perf_counter() - t:.3f} s")
    w = compare.window_s(cfg)
    kept = {k: entry.frames(fr) for k, fr in keep.kept.items()}
    readings = {k: compare.pair(ref, fr, w) for k, fr in kept.items()}
    worst = compare.worst(readings.values())
    out["attempted"] = passes
    out["failed"] = sum(not compare.judge(r, cell.limits)
                        for r in readings.values())
    out["correct"] = out["failed"] == 0
    first = kept[min(kept)]
    got = {data for _, _, data in first}
    log(f"payloads recovered (information, pass {min(keep.kept)}): "
        f"{sum(q in got for q in p.payloads)} of {len(p.payloads)}; "
        f"reference frames {len(ref)}, program frames {len(first)}; "
        f"passes checked {sorted(keep.kept)}; widest sync gap of a pair "
        f"{worst['sync_gap_s']!r} s")
    out["check"] = {k: {"value": worst[k], "limit": cell.limits[k]}
                    for k in compare.NUMBERS}
    return out


def traced(program, n_passes: int, work) -> TraceContext:
    """`n_passes` more passes under the profiler, each hand kernel's
    launches timed by CUDA events; `work` is the entry's count of the
    kernels' bytes and operations a pass."""
    from project_desert_tortoise_tpu_torch.ops.kernels import common
    common.launch_events = {}
    try:
        _, t = trace_mod.capture(lambda: [program()
                                          for _ in range(n_passes)])
        events = common.launch_events
    finally:
        common.launch_events = None
    launch_ms = {name: sum(a.elapsed_time(b) for a, b in pairs)
                 for name, pairs in events.items()}
    return TraceContext(t, n_passes, launch_ms, work, power_limit_w())

"""The traced sub-window: a profiler trace of a few passes, reduced to
device intervals, host operations and a breakdown.

``torch.profiler`` records host operations and the card's kernels, copies
and fills (CUPTI); the trace is read back from its Chrome-trace export.
A kernel counts as the program's hand kernel where the runtime or driver
call that launched it lies outside every PyTorch operation on the host (the
extensions are launched through ``ctypes``), and as a PyTorch kernel where
it lies inside one (cuFFT's and the jiterator's kernels are launched
through the driver).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, NamedTuple, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


class Interval(NamedTuple):
    name: str
    start: float     # seconds on the trace's clock
    end: float


class Trace(NamedTuple):
    window: Tuple[float, float]      # the traced window
    kernels: List[Interval]          # PyTorch's kernels
    hand: List[Interval]             # the program's own kernels
    copies: List[Interval]           # memcpy and memset on the device
    host_ops: List[Interval]         # outermost PyTorch operations

    @property
    def device(self) -> List[Interval]:
        return self.kernels + self.hand + self.copies


def merged(ivs) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint (start, end) pairs."""
    out: List[List[float]] = []
    for s, e in sorted((i.start, i.end) for i in ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(tr: Trace) -> float:
    """Seconds in the window in which an operation ran on the device."""
    lo, hi = tr.window
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged(tr.device))


def outermost(ivs: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for iv in sorted(ivs, key=lambda i: (i.start, -i.end)):
        if out and iv.end <= out[-1].end:
            continue
        out.append(iv)
    return out


def parse(events: List[dict], window: Tuple[float, float]) -> Trace:
    """A Trace from Chrome-trace events (times in microseconds)."""
    sec = lambda ev: (ev["ts"] * 1e-6, (ev["ts"] + ev.get("dur", 0)) * 1e-6)
    ops = [Interval(ev["name"], *sec(ev)) for ev in events
           if ev.get("cat") == "cpu_op" and ev.get("ph") == "X"]
    top = outermost(ops)
    starts = [i.start for i in top]
    launches = {ev["args"]["correlation"]: ev["ts"] * 1e-6 for ev in events
                if ev.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in ev.get("args", {})}

    def in_op(t: float) -> bool:
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and top[k].start <= t <= top[k].end

    kernels, hand, copies = [], [], []
    for ev in events:
        cat = ev.get("cat")
        if cat not in DEVICE_CATS or ev.get("ph") != "X":
            continue
        iv = Interval(ev["name"], *sec(ev))
        if cat != "kernel":
            copies.append(iv)
            continue
        t = launches.get(ev.get("args", {}).get("correlation"))
        (kernels if t is not None and in_op(t) else hand).append(iv)
    return Trace(window, kernels, hand, copies, top)


def capture(fn):
    """Run fn() under the profiler; returns (fn's result, Trace).  The
    window runs from the profiler's start to its stop, each after a
    synchronise."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with torch.profiler.record_function("pdt_bench.window"):
            out = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    mark = [ev for ev in events if ev.get("name") == "pdt_bench.window"
            and ev.get("ph") == "X" and ev.get("cat") == "user_annotation"]
    if not mark:
        raise RuntimeError("the profiler's trace has no window mark")
    window = (mark[0]["ts"] * 1e-6, (mark[0]["ts"] + mark[0]["dur"]) * 1e-6)
    return out, parse(events, window)


def gaps(tr: Trace) -> List[Tuple[float, float]]:
    """The window's stretches with nothing on the device."""
    lo, hi = tr.window
    out, t = [], lo
    for s, e in merged(tr.device):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def breakdown(tr: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle gaps by
    what the host was doing meanwhile (the outermost PyTorch operation, or
    ``python`` where none ran), in seconds."""
    ops: Dict[str, float] = collections.defaultdict(float)
    for iv in tr.device:
        ops[iv.name] += iv.end - iv.start
    idle: Dict[str, float] = collections.defaultdict(float)
    host = tr.host_ops
    starts = [i.start for i in host]
    for s, e in gaps(tr):
        covered = 0.0
        k = max(0, bisect.bisect_right(starts, s) - 1)
        while k < len(host) and host[k].start < e:
            o = min(e, host[k].end) - max(s, host[k].start)
            if o > 0:
                idle[host[k].name] += o
                covered += o
            k += 1
        idle["python"] += (e - s) - covered
    rank = lambda d: [[k[:96], v] for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}

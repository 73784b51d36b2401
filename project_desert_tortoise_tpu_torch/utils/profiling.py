"""Tracing / profiling helpers.

Twin of ``project_desert_tortoise_tpu/utils/profiling.py``:

- `trace(log_dir)`: context manager around ``torch.profiler`` (CPU and,
  where a card is present, CUDA activity) that writes a Chrome trace
  (``trace.json``) into `log_dir`;
- `StageTimer`: dispatch-to-fetch wall timing per stage with samples/s
  accounting.  `fetch` (a zero-argument callable returning a small
  tensor) is copied to the host when the stage ends, and where CUDA is in
  use the device is synchronised before the clock stops, so queued
  launches are counted in their stage.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    def __init__(self):
        self.times: Dict[str, List[float]] = {}
        self.samples: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, n_samples: int = 0, fetch=None):
        """Time a stage; `fetch` is a zero-arg callable returning a (small)
        tensor to force completion."""
        t0 = time.perf_counter()
        yield
        if fetch is not None:
            out = fetch()
            if torch.is_tensor(out):
                out.cpu()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.times.setdefault(name, []).append(dt)
        self.samples[name] = self.samples.get(name, 0) + n_samples

    def report(self) -> str:
        rows = []
        for name, ts in self.times.items():
            med = float(np.median(ts))
            n = self.samples.get(name, 0)
            msps = n / sum(ts) / 1e6 if n else 0.0
            rows.append(f"{name:24s} n={len(ts):3d} med={med*1e3:8.2f} ms"
                        + (f"  {msps:9.2f} Msps" if n else ""))
        return "\n".join(rows)

"""The port's profiling helpers (``utils/profiling.py``) on the CPU:
``trace`` writes a Chrome trace of what ran inside it, ``StageTimer``
times stages and reports samples per second."""

import json
import time

import torch

from project_desert_tortoise_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "log")):
        (x @ x).sum()
    events = json.loads((tmp_path / "log" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any("mm" in n for n in names)


def test_stage_timer_fetches_and_reports():
    timer = profiling.StageTimer()
    fetched = []
    for _ in range(3):
        with timer.stage("demod", n_samples=1_000_000,
                         fetch=lambda: fetched.append(1) or torch.zeros(1)):
            time.sleep(0.01)
    with timer.stage("write"):
        pass
    assert len(fetched) == 3 and len(timer.times["demod"]) == 3
    assert min(timer.times["demod"]) >= 0.01
    rows = timer.report().splitlines()
    assert rows[0].startswith("demod") and "n=  3" in rows[0]
    assert "Msps" in rows[0] and "Msps" not in rows[1]

"""The window's arithmetic, the roofline's count, the trace's reading and
the form of the result line."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from pdt_bench import compare, harness, roofline, run, trace

REPO = Path(__file__).resolve().parents[2]


def test_rate_covers_the_whole_window():
    starts = [0.5, 1.5, 2.5]
    ends = [1.0, 2.0, 3.0]
    s = harness.window_stats(0.0, starts, ends, 1_000_000)
    # 3 passes of 1 M samples from the window's start to the last end
    assert s["decode_msps"] == pytest.approx(1.0)


def test_p90_covers_every_pass():
    walls = np.arange(1, 101) * 1e-3
    starts = np.cumsum(np.r_[0, walls[:-1]])
    s = harness.window_stats(0.0, starts, starts + walls, 10)
    assert s["pass_p90_ms"] == pytest.approx(np.percentile(walls, 90) * 1e3)
    assert s["pass_p90_ms"] == pytest.approx(90.1)


def test_a_stall_in_the_window_moves_rate_and_p90():
    def window(stall):
        k = [0]

        def call():
            time.sleep(0.03 if stall and 10 <= k[0] < 16 else 0.01)
            k[0] += 1
            return []
        t0, s, e = harness.run_window(call, 0.3, lambda *_: None)
        assert e[-1] - t0 >= 0.3 > s[-1] - t0
        return harness.window_stats(t0, s, e, 1000)
    calm, stalled = window(False), window(True)
    assert stalled["decode_msps"] < 0.9 * calm["decode_msps"]
    assert stalled["pass_p90_ms"] > 2 * calm["pass_p90_ms"]


def test_roofline_count_against_a_hand_count():
    w = roofline.pass_work(lanes=2, samples=8192, interp=3, window=4096,
                           step_size=9.0)
    slots = 2 * (int(12288 / 9.0 * 1.08) + 4)     # two windows of 1,478
    assert slots == 2956
    assert w["pll_scan"] == {"bytes": 2 * 8192 * 16.0,
                             "ops": 2 * 8192 * 109.0}
    assert w["agc_scan"] == {"bytes": 2 * 24576 * 8.0,
                             "ops": 2 * 24576 * 12.0}
    assert w["gardner_manchester"] == {
        "bytes": 2 * (24576 * 8.0 + slots * 6.0), "ops": 2 * slots * 57.0}
    ms, by = roofline.least_ms(w)
    total_bytes = 262144 + 393216 + 2 * (196608 + 17736)
    assert by == "bytes"
    assert ms == pytest.approx(total_bytes / 3.35e12 * 1e3)


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_pairing_within_half_a_bit():
    ref = [(1.0, False, b"a"), (2.0, True, b"b"), (3.0, False, b"c")]
    same = [(1.00002, False, b"a"), (2.0, True, b"b"), (3.0, False, b"c")]
    assert compare.pair(ref, same, 6e-5) == {"frames_unpaired": 0,
                                             "sync_gap_s": pytest.approx(2e-5)}
    late = [(1.0, False, b"a"), (2.0002, True, b"b"), (3.0, False, b"c")]
    assert compare.pair(ref, late, 6e-5)["frames_unpaired"] == 2
    flipped = [(1.0, False, b"a"), (2.0, False, b"b"), (3.0, False, b"d")]
    assert compare.pair(ref, flipped, 6e-5)["frames_unpaired"] == 4
    assert compare.pair(ref, ref[:1], 6e-5)["frames_unpaired"] == 2


def test_trace_reading():
    events = [
        ev("cpu_op", "aten::add", 0, 10), ev("cpu_op", "aten::empty", 2, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=2),
        ev("cuda_driver", "cuLaunchKernel", 8, 1, correlation=3),
        ev("kernel", "vector_fft", 20, 2, correlation=3),
        ev("kernel", "add_kernel", 12, 8, correlation=1),
        ev("kernel", "agc_scan_kernel", 32, 20, correlation=2),
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 60, 10),
        ev("cpu_op", "aten::pin_memory", 70, 20),
    ]
    tr = trace.parse(events, (0.0, 100e-6))
    assert sorted(k.name for k in tr.kernels) == ["add_kernel", "vector_fft"]
    assert [k.name for k in tr.hand] == ["agc_scan_kernel"]
    assert [o.name for o in tr.host_ops] == ["aten::add", "aten::pin_memory"]
    assert trace.busy_s(tr) == pytest.approx(40e-6)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["agc_scan_kernel", pytest.approx(20e-6)]
    idle = dict(b["idle_gaps"])
    # gaps: 0-12 (aten::add 0-10, python 10-12), 22-32, 52-60, 70-100
    assert idle["aten::add"] == pytest.approx(10e-6)
    assert idle["aten::pin_memory"] == pytest.approx(20e-6)
    assert idle["python"] == pytest.approx(30e-6)
    ctx = harness.TraceContext(tr, 2, {"pdt_agc_scan": 4.0},
                               roofline.pass_work(2, 8192, 3, 4096, 9.0),
                               700.0)
    read = lambda name: harness.read_metric(REPO, name, ctx)
    assert read("h2d_ms_per_pass")["value"] == pytest.approx(5e-3)
    assert read("host_pin_ms_per_pass")["value"] == pytest.approx(1e-2)
    assert read("torch_ops_ms_per_pass")["value"] == pytest.approx(5e-3)
    assert read("hand_kernels_ms_per_pass")["value"] == pytest.approx(2.0)
    assert read("device_idle_pct")["value"] == pytest.approx(60.0)
    roof = read("kernel_roofline")
    assert roof["unit"] == "%" and roof["bound_by"] == "bytes"
    assert roof["value"] == pytest.approx(100 * roof["least_ms"] / 2.0)


def test_readers_return_nothing_without_a_trace():
    ctx = harness.TraceContext(None, 1, {}, {}, None)
    for path in (REPO / "pdt_bench" / "metrics").glob("*.py"):
        assert harness.read_metric(REPO, path.stem, ctx) is None, path


def test_result_line_form():
    out = {"work": {}, "correct": True, "attempted": 120, "failed": 0,
           "metrics": {"decode_msps": {"value": 1.5, "unit": "Msamples/s"}},
           "device": {"platform": "gpu", "kind": "k", "count": 1,
                      "memory_peak_bytes": 1},
           "breakdown": {"device_ops": [], "idle_gaps": []},
           "check": {"frames_unpaired": {"value": 0, "limit": 0}}}
    line = run.result_line(out)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "check"]
    assert "\n" not in json.dumps(line)


def test_no_card_exits_nonzero_without_a_result(tmp_path):
    p = subprocess.run(
        [sys.executable, "-m", "pdt_bench.run", "--workload", "poes_pass",
         "--seed", "1", "--seconds", "1"], cwd=REPO, capture_output=True,
        text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                     "PATH": "/usr/bin:/bin",
                                     "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert p.stdout == ""

"""Small cells run end to end on the CPU, the program's plain versions in
the card's place: found from new files alone (a new entry too) and
correct; with the timed path broken underneath, not correct, also under
the cells' own limits where one frame goes missing or doubles at each
seam between slices; and the control (the reference in bfloat16) fails
the limits of both cells."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from pdt_bench import compare, harness, reference, synth
from project_desert_tortoise_tpu_torch.parallel import blocked

from conftest import add_cell, archive_traffic, tiny_config

REPO = Path(__file__).resolve().parents[2]


def run_tiny(root, workload="tiny_cell"):
    cell = harness.load_cell(root, workload)
    return harness.run_cell(root, cell, 2 ** 31 + 5, 0.001, False, "cpu",
                            time.perf_counter(), lambda _: None)


@pytest.mark.parametrize("workload,work", [
    ("tiny_cell", {"lanes": 10, "slices": 1}),
    ("tiny_one_shot", {"lanes": 10})])
def test_throwaway_cell_is_found_and_correct(tiny_root, workload, work):
    out = run_tiny(tiny_root, workload)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert out["work"] == {"samples_per_pass": 78240, "payloads_expected": 2,
                           **work, "passes": out["attempted"]}
    assert set(out["metrics"]) == {"decode_msps", "pass_p90_ms", "setup_s"}
    assert out["check"]["frames_unpaired"]["value"] == 0


def test_half_the_blocks_left_out_is_not_correct(tiny_root, monkeypatch):
    real = blocked.demod_frames

    def half(params, plan, framer_cfg, fs, blocks_re, blocks_im, *a, **k):
        keep = torch.arange(blocks_re.shape[0]) < blocks_re.shape[0] // 2
        z = lambda x: torch.where(keep[:, None], x, torch.zeros_like(x))
        return real(params, plan, framer_cfg, fs, z(blocks_re),
                    z(blocks_im), *a, **k)
    monkeypatch.setattr(blocked, "demod_frames", half)
    out = run_tiny(tiny_root)
    assert not out["correct"]
    assert out["check"]["frames_unpaired"]["value"] > 0


def test_an_answer_altered_where_it_is_made_is_not_correct(tiny_root,
                                                           monkeypatch):
    real = blocked._fetch_frames

    def altered(stitched, t_ext):
        frames = real(stitched, t_ext)
        if frames:
            frames[0].data = frames[0].data.copy()
            frames[0].data[-1] ^= 1
        return frames
    monkeypatch.setattr(blocked, "_fetch_frames", altered)
    out = run_tiny(tiny_root)
    assert not out["correct"]
    assert out["check"]["frames_unpaired"]["value"] == 2


def test_a_frame_lost_or_doubled_at_each_seam_fails_the_limit(
        tiny_root, monkeypatch):
    """Four slices of five blocks, a packet in each slice; where each
    slice's frames are fetched, the first frame of slice 1 is dropped and
    those of slices 2 and 3 doubled: three frames unpaired, over
    ``poes_pass``'s limit."""
    limits = json.loads((REPO / "pdt_bench/limits/poes_pass.json")
                        .read_text())
    add_cell(tiny_root, "tiny_seams", tiny_config("tiny_argos_seams", 4, 20),
             archive_traffic("tiny_seams_archive", n_slices=4), limits)
    real = blocked._fetch_frames
    calls = []

    def at_seams(stitched, t_ext):
        frames = real(stitched, t_ext)
        k = len(calls) % 4
        calls.append(len(frames))
        if k == 1:
            return frames[1:]
        return frames[:1] + frames if k > 1 else frames
    monkeypatch.setattr(blocked, "_fetch_frames", at_seams)
    out = run_tiny(tiny_root, "tiny_seams")
    assert calls[:4] == [1, 1, 1, 1]
    assert out["check"]["frames_unpaired"]["value"] == 3
    assert not out["correct"]


@pytest.mark.parametrize("workload", ["poes_pass", "argos_pass"])
def test_the_control_fails_each_cells_limits(workload):
    """The reference in bfloat16 in the program's place, on a pass cut to
    a few blocks but with more frames than each cell's limit allows to go
    unpaired, against the float32 reference."""
    cfg = tiny_config("tiny_argos")
    cfg["pass"]["packets"] = 10
    if workload == "poes_pass":
        cfg = json.loads((REPO / "pdt_bench/configs/poes_tip.json")
                         .read_text())
        cfg["pass"]["frames"] = 20
        cfg["plan"] = {"lanes": 15, "core": 8192, "head": 4096,
                       "tail": 8192, "max_frames": 27}
    p = synth.make_pass(cfg, 77, torch.device("cpu"))
    gain = reference.static_gain(p.re16, p.im16, cfg["gain_probe_samples"],
                                 cfg["static_gain_level"])
    t_ext = reference.time_axis(len(p.re16), cfg["fs"])
    entry = harness.load_entry(REPO, "demod_frames_flat_pipelined")
    frames = lambda A: entry.reference(cfg, {"window": 4096}, p, t_ext,
                                       gain, A)
    ref = frames(reference.Arith())
    assert len(ref) >= len(p.payloads) - 1
    low = compare.pair(ref, frames(reference.Arith(torch.bfloat16)),
                       compare.window_s(cfg))
    limits = json.loads((REPO / "pdt_bench" / "limits" / f"{workload}.json")
                        .read_text())
    assert not compare.judge(low, limits)


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "pdt_bench.run", "--workload",
                        "poes_pass", "--seed", "424242", "--seconds", "2"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True

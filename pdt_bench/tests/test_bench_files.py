"""The benchmark's data files, the seed's share of a pass, and the check
that no run loads JAX or the JAX package."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pdt_bench import compare, harness, synth

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(workload):
    cell = harness.load_cell(REPO, workload)
    conf = {c["name"]: c for c in BENCH["configs"]}
    w = {w["name"]: w for w in BENCH["workloads"]}[workload]
    assert cell.cfg["name"] == w["config"]
    assert Path(conf[w["config"]]["file"]).parts[0] in BENCH["paths"]
    entry = harness.load_entry(REPO, cell.traffic["entry"])
    for name in ("build", "frames", "reference", "pass_work"):
        assert callable(getattr(entry, name)), name
    assert set(cell.limits) == set(compare.NUMBERS)
    assert {m["name"] for m in cell.end_to_end} == {
        "decode_msps", "pass_p90_ms", "setup_s"}
    for m in cell.per_layer:
        assert (REPO / "pdt_bench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("config", ["poes_tip", "argos"])
def test_pass_fills_the_configured_blocks(config):
    cfg = json.loads((REPO / f"pdt_bench/configs/{config}.json").read_text())
    n = synth.pass_samples(cfg)
    assert -(-n // cfg["plan"]["core"]) == cfg["plan"]["lanes"] == 352
    assert n == {"poes_tip": 36_025_000, "argos": 23_041_680}[config]


@pytest.mark.parametrize("config,count", [("poes_tip", ("frames", 5)),
                                          ("argos", ("packets", 3))])
def test_every_seed_does_the_same_work(config, count):
    """The seed draws payloads, noise and phase; lengths, payload counts,
    blocks and slices are the configuration's."""
    cfg = json.loads((REPO / f"pdt_bench/configs/{config}.json").read_text())
    cfg["pass"][count[0]] = count[1]
    passes = [synth.make_pass(cfg, s, torch.device("cpu"))
              for s in (0, 12345, 2 ** 31 + 17)]
    n = synth.pass_samples(cfg)
    assert {len(p.re16) for p in passes} == {n}
    assert {len(p.payloads) for p in passes} == {len(passes[0].payloads)}
    assert len({p.payloads[0] for p in passes}) == 3
    assert not np.array_equal(passes[0].re16, passes[1].re16)
    again = synth.make_pass(cfg, 12345, torch.device("cpu"))
    assert np.array_equal(again.re16, passes[1].re16)
    assert again.payloads == passes[1].payloads


def test_forbidden_names_are_whole_top_level_names():
    assert harness.forbidden_modules(
        ["project_desert_tortoise_tpu_torch.parallel.blocked", "torch",
         "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["project_desert_tortoise_tpu.ops.pll", "jax.numpy", "jaxlib",
         "flax.linen"]) == ["flax", "jax", "jaxlib",
                            "project_desert_tortoise_tpu"]


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_and_reference_no_program():
    for path in (REPO / "pdt_bench").rglob("*.py"):
        assert harness.forbidden_modules(imported(path)) == [], path
    for name in ("reference.py", "synth.py", "compare.py", "roofline.py"):
        tops = {m.split(".")[0]
                for m in imported(REPO / "pdt_bench" / name)}
        assert "project_desert_tortoise_tpu_torch" not in tops, name

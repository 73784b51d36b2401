"""Fixtures of the benchmark's own tests: a throwaway checkout holding a
copy of the benchmark and small cells added from new files alone."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "pdt_bench"

# a new entry, written as a new file: the one-shot flat path
# (``blocked.demod_frames_flat`` on the whole pass, the planes uploaded in
# set-up), judged by the pipelined entry's reference
ONE_SHOT_ENTRY = '''
from pathlib import Path

from pdt_bench import harness

_flat = harness.load_entry(Path(__file__).resolve().parents[2],
                           "demod_frames_flat_pipelined")
frames, reference, pass_work = _flat.frames, _flat.reference, _flat.pass_work


def build(cfg, args, p, t_ext, gain, device):
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.parallel import blocked
    from project_desert_tortoise_tpu_torch.utils.config import MODES
    mode, pl, fs = MODES[cfg["mode"]], cfg["plan"], float(cfg["fs"])
    plan = blocked.BlockPlan(pl["core"], pl["head"], pl["tail"],
                             pl["max_frames"])
    params = chain.make_params(mode, fs)
    re, im = (torch.from_numpy(a).to(device) for a in (p.re16, p.im16))

    def call():
        return blocked._fetch_frames(blocked.demod_frames_flat(
            params, mode.framer, plan, pl["lanes"], fs, args["window"],
            args["use_pallas"], re, im, gain), t_ext)
    call.work = {"lanes": pl["lanes"]}
    return call
'''


def tiny_config(name: str, packets: int = 2, lanes: int = 10) -> dict:
    """The ARGOS deployment cut to a few packets in `lanes` blocks of
    20,480 samples: small enough for the program's plain CPU versions."""
    cfg = json.loads((BENCH / "configs" / "argos.json").read_text())
    cfg["name"] = name
    cfg["pass"]["packets"] = packets
    cfg["plan"] = {"lanes": lanes, "core": 8192, "head": 4096, "tail": 8192,
                   "max_frames": 21}
    return cfg


def add_cell(root: Path, name: str, cfg: dict, traffic: dict, limits: dict,
             entry_source: str = None) -> None:
    """Add the cell `name` to the checkout at `root` as new files: its
    configuration, traffic mix, limits and (optionally) entry, and its
    entries in BENCHMARK.json."""
    files = root / "pdt_bench"
    (files / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (files / "traffic" / f"{traffic['name']}.json").write_text(
        json.dumps(traffic))
    (files / "limits" / f"{name}.json").write_text(json.dumps(limits))
    if entry_source is not None:
        (files / "entries" / f"{traffic['entry']}.py").write_text(
            entry_source)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": "test",
                             "file": f"pdt_bench/configs/{cfg['name']}.json",
                             "reduced": ["pass", "plan"], "why": "test"})
    bench["workloads"].append({"name": name, "config": cfg["name"],
                               "traffic": traffic["name"], "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def archive_traffic(name: str, **entry_args) -> dict:
    tr = json.loads((BENCH / "traffic" / "archive_pass.json").read_text())
    tr.update(name=name, check_passes=2)
    tr["entry_args"].update(entry_args)
    return tr


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout with BENCHMARK.json and a copy of the benchmark, and two
    cells added as new files alone: ``tiny_cell`` (a new configuration
    and traffic mix on the pipelined entry) and ``tiny_one_shot`` (a new
    entry too)."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "pdt_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    exact = {"frames_unpaired": 0}
    add_cell(root, "tiny_cell", tiny_config("tiny_argos"),
             archive_traffic("tiny_archive", n_slices=1), exact)
    one_shot = archive_traffic("tiny_one_shot_archive")
    one_shot["entry"] = "tiny_one_shot"
    add_cell(root, "tiny_one_shot", tiny_config("tiny_argos_one_shot"),
             one_shot, exact, ONE_SHOT_ENTRY)
    return root

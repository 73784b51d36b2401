"""The PyTorch port imports without jax and without the JAX package, and
no port file (nor chip_smoke.py or multichip_dryrun_torch.py) imports
either."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "project_desert_tortoise_tpu_torch"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

JAX_PKG = "project_desert_tortoise_tpu"

def blocked(name):
    return (name == "jax" or name.startswith(("jax.", "jaxlib"))
            or name == JAX_PKG or name.startswith(JAX_PKG + "."))

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, BlockJax())
import project_desert_tortoise_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
assert not any(blocked(k) for k in sys.modules)
print(" ".join(mods))
"""


def test_port_imports_with_jax_blocked():
    env = {**os.environ,
           "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    mods = set(r.stdout.split())                # every module was imported
    assert len(mods) >= 30
    pkg = "project_desert_tortoise_tpu_torch."
    assert {pkg + m for m in ("apps.demod_poes", "apps.demod_argos",
                              "tools.ablate_kernel", "tools.ablate_fused",
                              "ops.kernels.fused_kernel",
                              "models.demodulator", "models.poes",
                              "utils.metrics", "native.wavio",
                              "parallel.serving", "models.streaming",
                              "utils.checkpoint", "utils.audio",
                              "utils.profiling", "apps.demod_realtime",
                              "apps.demod_serve", "models.argos",
                              "telemetry.minorframes", "telemetry.tip",
                              "telemetry.argos", "utils.png",
                              "apps.telemetry_explorer", "ops.resample",
                              "ops.bitpack", "tools.study_upsampling",
                              "parallel.sharding",
                              "parallel.multihost")} <= mods


def test_no_port_file_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                       REPO / "multichip_dryrun_torch.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert offenders == []


def test_no_port_file_imports_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+project_desert_tortoise_tpu[\s.]",
                     re.M)
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                       REPO / "multichip_dryrun_torch.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert offenders == []
    assert pat.search("from project_desert_tortoise_tpu.utils import wav")
    assert not pat.search("from project_desert_tortoise_tpu_torch import x")

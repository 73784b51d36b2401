"""The port's upsampling-level study (``tools/study_upsampling.py`` of
``project_desert_tortoise_tpu_torch``) against the JAX package's tool, on
the CPU (the kernels' plain versions).

- One session a case, JAX's and the port's, on the same 3-frame 22 dB
  recording with the tool's configuration: the Gardner clock at cubic 8 and
  linear 1 (the upsample a no-op), the M&M clock at linear 2 and cubic 8.
  Tolerance, the ``docs/DESIGN.md`` §4b contract: payloads, polarity and
  the count of recovered frames identical, sync times within one sample
  period.
- ``upsample`` and ``uniform_times`` at levels 6 and 8 (past the levels
  ``test_torch_resample.py`` holds), both kinds, bit for bit.
- The two tools' ``main`` at ``--frames 2 --levels 2`` into temporary
  directories: the same JSON rows, and a PNG written.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu.models.demodulator import (
    DemodSession as JaxSession)
from project_desert_tortoise_tpu.ops import resample as JR
from project_desert_tortoise_tpu.utils import config as JCFG
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu_torch.ops import resample as PR
from project_desert_tortoise_tpu_torch.tools import study_upsampling as S

torch.set_num_threads(1)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FS = S.FS


def jax_tool():
    """The JAX package's study tool, a script outside any package."""
    spec = importlib.util.spec_from_file_location(
        "jax_study_upsampling",
        os.path.join(REPO, "tools", "study_upsampling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_config(alg, kind, level):
    """The JAX tool's configuration (``tools/study_upsampling.py:52-59``)."""
    P = JCFG.POES_TIP
    return dataclasses.replace(
        P, fir=JCFG.FIRConfig(cutoff_hz=11000.0, base_order=26,
                              target_rate_hz=None, interp=1),
        gardner=dataclasses.replace(
            P.gardner, algorithm=alg, upsample_level=level,
            upsample_kind=kind, gain=1.0, error_limit=2.0))


@pytest.fixture(scope="module")
def recording():
    iq, sent = synth.make_poes_recording(n_frames=3, fs=FS, snr_db=22.0)
    return iq, W.time_axis(len(iq), FS, np.float32), sent


@pytest.mark.parametrize("alg,kind,level", [
    ("upsampling_gardner", "cubic", 8), ("upsampling_gardner", "linear", 1),
    ("upsampling_mm", "linear", 2), ("upsampling_mm", "cubic", 8)])
def test_study_case_matches_jax(recording, alg, kind, level):
    iq, t, sent = recording
    want = JaxSession(jax_config(alg, kind, level), FS, quirks=False,
                      norm_factor=S.NORM_FACTOR).run(iq, t)
    got = S.run_case(alg, kind, level, iq, t, device="cpu")
    assert S.frames_ok(got, sent) == S.frames_ok(want, sent)
    assert len(got.frames) == len(want.frames)
    for a, b in zip(want.frames, got.frames):
        assert a.inverted == b.inverted and a.complete == b.complete
        assert np.array_equal(a.data, b.data)
        assert abs(a.time - b.time) <= 1.0001 / FS
    assert got.total_samples == want.total_samples == len(iq)


@pytest.mark.parametrize("kind", ["linear", "cubic"])
@pytest.mark.parametrize("level", [6, 8])
def test_upsample_high_levels_match_jax(level, kind):
    x = np.random.default_rng(level).normal(size=(2, 10016)).astype(
        np.float32)
    want = np.asarray(JR.upsample(jnp.asarray(x), level, kind))
    got = PR.upsample(torch.from_numpy(x), level, kind).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    t = W.time_axis(10016, FS, np.float32)[None]
    ts_over_l = float(np.float64(1.0) / FS) / level
    want_t = np.asarray(JR.uniform_times(jnp.asarray(t), level, ts_over_l))
    got_t = PR.uniform_times(torch.from_numpy(t), level, ts_over_l).numpy()
    assert np.array_equal(got_t, want_t)


def test_main_rows_match_jax(tmp_path, monkeypatch, capsys):
    args = ["--frames", "2", "--levels", "2"]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["study_upsampling.py", *args,
                                      "--out-dir", str(jdir)])
    assert jax_tool().main() == 0
    assert S.main([*args, "--out-dir", str(pdir), "--device", "cpu"]) == 0
    want = json.loads((jdir / "upsampling_levels.json").read_text())
    got = json.loads((pdir / "upsampling_levels.json").read_text())
    assert got == want
    assert len(got["rows"]) == 4
    assert any(r["frames_ok"] for r in got["rows"])
    assert (pdir / "upsampling_levels.png").read_bytes()[:4] == b"\x89PNG"
    printed = [json.loads(line) for line in capsys.readouterr().out.split(
        "\n") if line.startswith("{")]
    assert printed == want["rows"] * 2          # both tools print each row


@pytest.mark.slow
def test_reference_rows_of_the_card_study(tmp_path, monkeypatch):
    """``chip_smoke.STUDY_REFERENCE``, the rows the card's ``study`` phase
    is held to: the JAX tool's at the committed study's settings (28
    sessions of 10 frames; about ten minutes on the CPU, so marked slow)."""
    import chip_smoke as C
    monkeypatch.setattr(sys, "argv", [
        "study_upsampling.py", "--frames", str(C.STUDY_FRAMES), "--snr",
        str(C.STUDY_SNR_DB), "--levels", ",".join(map(str, C.STUDY_LEVELS)),
        "--out-dir", str(tmp_path)])
    assert jax_tool().main() == 0
    rows = json.loads((tmp_path / "upsampling_levels.json").read_text())
    assert {(r["algorithm"], r["kind"], r["level"]): r["frames_ok"]
            for r in rows["rows"]} == C.STUDY_REFERENCE

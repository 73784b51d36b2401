"""The port's CLI, ``demod_poes --fast --device cpu``, against the JAX
CLI's ``--fast`` on a synthetic POES WAV: the same frame lines.

Both CLIs plan their blocks with the small plan of
tests/test_pallas_fused.py (the default plan's blocks are 126,976 samples,
too long for the kernel's plain per-sample version on the CPU here).
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu.apps import demod_poes as jax_cli
from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu_torch.apps import demod_poes as port_cli
from project_desert_tortoise_tpu_torch.parallel import blocked as TB

torch.set_num_threads(1)
FS = 50000.0
PLAN = (8192, 12288, 8192, 8)


def test_cli_fast_matches_jax_cli(tmp_path, monkeypatch):
    iq, _ = synth.make_poes_recording(n_frames=6, fs=FS, snr_db=28.0)
    wav = str(tmp_path / "in.wav")
    W.write_iq_wav(wav, iq / (np.abs(iq).max() * 1.2), int(FS))
    # both CLIs plan their blocks with the small plan
    monkeypatch.setattr(JB, "default_plan",
                        lambda *a, **k: JB.BlockPlan(*PLAN))
    monkeypatch.setattr(TB, "default_plan",
                        lambda *a, **k: TB.BlockPlan(*PLAN))
    j_out, t_out = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    assert jax_cli.run([wav, "--fast", "--out", j_out]) == 0
    assert port_cli.run([wav, "--fast", "--device", "cpu",
                         "--out", t_out]) == 0
    j_lines = open(j_out).read().splitlines()
    t_lines = open(t_out).read().splitlines()
    assert len(j_lines) >= 3
    assert t_lines == j_lines


def test_cli_refuses_what_is_not_ported(tmp_path, capsys):
    """Refused, with a message naming the cause: the exact chain's options
    together with ``--fast``.  The exact chain of the float64 ``argos``
    mode, ``demod_argos``'s default, runs (here on 100 silent samples)."""
    from project_desert_tortoise_tpu_torch.apps import demod_argos
    wav = str(tmp_path / "x.wav")
    W.write_iq_wav(wav, np.zeros(100, np.complex64), int(FS))
    out = str(tmp_path / "packets.txt")
    assert port_cli.run([wav, "--mode", "argos", "--device", "cpu",
                         "--out", out]) == 0
    with pytest.raises(SystemExit) as done:
        demod_argos.main([wav, "--device", "cpu", "--out", out])
    assert done.value.code == 0
    assert "not ported" not in capsys.readouterr().err
    # the exact chain's options are refused with --fast, not ignored
    for opts in (["-r"], ["-c", "4096"], ["--no-quirks"],
                 ["--timebase", "integer"]):
        assert port_cli.run([wav, "--fast", *opts]) == 2
        assert "exact chunked chain" in capsys.readouterr().err

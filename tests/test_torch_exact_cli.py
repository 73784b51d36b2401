"""The port's CLI without ``--fast`` (the exact chunked chain, ``--device
cpu``: the kernels' plain versions) against the JAX CLI on a synthetic
4-frame POES WAV: the reference's defaults (quirks on, with the ``-r``
raw tap) and another chunk size (``-c 3777``, whose chunk boundaries fall
mid-symbol).  ``tests/test_torch_exact_cli_options.py`` runs
``--no-quirks`` and ``--timebase integer``.

Tolerance: the ``docs/DESIGN.md`` §4b contract on the written lines (frame
counts and payloads identical, a timestamp one sample period off on at
most one frame), and the raw tap within 1e-3 of JAX's (the envelope of
``tests/test_torch_exact_session.py``).
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu.apps import demod_poes as jax_cli
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu_torch.apps import demod_poes as port_cli
from project_desert_tortoise_tpu_torch.utils.output import parse_frames_file

torch.set_num_threads(1)
FS = 50000.0


@pytest.fixture(scope="module")
def poes_wav(tmp_path_factory):
    iq, _ = synth.make_poes_recording(n_frames=4, fs=FS)
    wav = str(tmp_path_factory.mktemp("wav") / "in.wav")
    W.write_iq_wav(wav, iq / (np.abs(iq).max() * 1.2), int(FS))
    return wav


def run_both(wav, opts, tmp_path, monkeypatch, capsys):
    """Both CLIs with `opts`, each in a directory of its own (``-r``
    writes output.raw there); returns (jax lines, port lines, the port's
    stderr, the two directories)."""
    out = {}
    for name, cli, extra in (("jax", jax_cli, []),
                             ("port", port_cli, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        assert cli.run([wav, *opts, *extra, "--out", "frames.txt"]) == 0
        err = capsys.readouterr().err
        out[name] = (parse_frames_file(str(d / "frames.txt")), err, d)
    return out["jax"][0], out["port"][0], out["port"][1], \
        (out["jax"][2], out["port"][2])


def check_lines(j, t):
    """§4b on parsed (time, inverted, bytes) lines."""
    assert len(j) == len(t) >= 2
    shifted = 0
    for (jt, ji, jb), (tt, ti, tb) in zip(j, t):
        assert ji == ti and jb == tb
        if jt != tt:
            assert abs(jt - tt) <= 1.0001 / FS + 1e-5    # printed to 5 places
            shifted += 1
    assert shifted <= 1


@pytest.mark.parametrize("opts", [["-r"], ["-c", "3777"]])
def test_exact_cli_matches_jax_cli(poes_wav, opts, tmp_path, monkeypatch,
                                   capsys):
    j, t, err, (jd, td) = run_both(poes_wav, opts, tmp_path, monkeypatch,
                                   capsys)
    check_lines(j, t)
    assert "Frames : " in err and err.endswith("\n")
    if "-r" in opts:
        jr = np.fromfile(jd / "output.raw", np.float32)
        tr = np.fromfile(td / "output.raw", np.float32)
        assert jr.shape == tr.shape and len(tr) > 0
        assert np.abs(jr - tr).max() < 1e-3

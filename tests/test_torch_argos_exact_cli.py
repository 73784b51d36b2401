"""The port's ``demod_argos`` without ``--fast`` (the float64 ``argos``
mode's exact chain, ``--device cpu``: the kernels' plain versions in
float64) against the JAX CLI, which turns x64 on for this mode, on a
synthetic two-packet ARGOS WAV: the reference's defaults (quirks on) and
``--timebase integer`` (quirks off, exact n*Ts timestamps).  The JAX CLI
leaves x64 on; a fixture turns it off again after the module.

Tolerance (``docs/DESIGN.md`` §4b, ``tests/test_torch_argos_exact.py``
for the float64 envelope): packet counts and payloads identical,
timestamps within one sample period (as printed, to 5 places).
"""

import numpy as np
import jax
import pytest
import torch

from project_desert_tortoise_tpu.apps import demod_poes as jax_cli
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu_torch.apps import demod_argos as port_cli
from project_desert_tortoise_tpu_torch.utils.output import parse_frames_file

torch.set_num_threads(1)
FS = 32000.0


@pytest.fixture(scope="module", autouse=True)
def x64_off_after():
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def argos_wav(tmp_path_factory):
    iq, payloads = synth.make_argos_recording(n_packets=2, fs=FS)
    wav = str(tmp_path_factory.mktemp("wav") / "argos.wav")
    W.write_iq_wav(wav, iq / (np.abs(iq).max() * 1.2), int(FS))
    return wav, [list(p) for p in payloads]


def _port(argv):
    with pytest.raises(SystemExit) as done:
        port_cli.main(argv)
    return done.value.code


@pytest.mark.parametrize("opts", [[], ["--timebase", "integer"]])
def test_exact_cli_packets_match_jax_cli(argos_wav, opts, tmp_path, capsys):
    wav, payloads = argos_wav
    j_out, t_out = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    # the JAX demod_argos is this run with the argos defaults
    assert jax_cli.run([wav, *opts, "--out", j_out], default_mode="argos",
                       prefix="packets") == 0
    assert jax.config.jax_enable_x64            # it ran the float64 chain
    assert _port([wav, *opts, "--device", "cpu", "--out", t_out]) == 0
    assert "PLL locked at" in capsys.readouterr().out
    j, t = parse_frames_file(j_out), parse_frames_file(t_out)
    assert [b for _, _, b in t] == [b for _, _, b in j] == payloads[1:]
    for (jt, ji, _), (tt, ti, _) in zip(j, t):
        assert ji == ti
        assert abs(jt - tt) <= 1.0001 / FS + 1e-5     # printed to 5 places

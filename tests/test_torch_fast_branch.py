"""The port's ``--fast`` runs the JAX CLI's branch, on the CPU.

Both packages' ``demod_poes --fast`` and ``demod_argos --fast`` call
``demodulate_blocked`` with its default branch.  JAX's default is its XLA
scans (``use_pallas=False``), which compact bits with ``compress_sorted``;
the fused branch compacts its sample-dense plane with ``compress_spaced``,
which sums two bit emissions that land in one 4-sample chunk.

- The port's default branch is JAX's (``inspect.signature``).
- Each port CLI (``--device cpu``, the plain versions) writes the JAX
  CLI's lines, line for line, on a synthetic WAV with a noise lead-in,
  both planned with a small plan.  On the POES input the fused kernel's
  clock, hunting in the noise, emits twice within a 4-sample chunk: the
  test counts such chunks on the port's plain ``fused_demod`` over the
  CLI's blocks and requires one at least.  (An ARGOS symbol is 40 samples
  long, so two emissions never share a chunk there.)
- On the same POES blocks, repeated to 128 lanes (JAX takes its fused
  branch only at B % 128 == 0), the port's fused branch (``demod_blocks``
  on the plain ``fused_demod`` and ``compress_spaced``) equals JAX's fused
  branch (its Pallas kernel in interpret mode): the repair changed the
  default, not the fused branch.  Tolerance, docs/DESIGN.md section 4b
  (XLA's and libm's sinf/cosf round differently): the compacted bits and
  bit counts identical on every lane, each bit position equal or one
  sample apart, and at most 2% of them apart.

JAX's ``demod_argos --fast`` in its default ``argos`` mode does not run on
this tree: the CLI turns on x64 for the float64 mode, and its fast path's
framer then fails to trace (``ops/framer.py:176``, an int32 carry and an
int64 result).  Its fast path computes in float32 whatever the mode's
dtype, so the port's ``demod_argos --fast`` is held to the JAX CLI run
with that switch held off, and also, as both CLIs run, in the float32
``argos_realtime`` mode.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu import chain as JC
from project_desert_tortoise_tpu.apps import demod_argos as jax_argos
from project_desert_tortoise_tpu.apps import demod_poes as jax_poes
from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.utils.config import POES_TIP as J_POES
from project_desert_tortoise_tpu_torch import chain as TC
from project_desert_tortoise_tpu_torch.apps import demod_argos as port_argos
from project_desert_tortoise_tpu_torch.apps import demod_poes as port_poes
from project_desert_tortoise_tpu_torch.ops import agc
from project_desert_tortoise_tpu_torch.parallel import blocked as TB
from project_desert_tortoise_tpu_torch.utils import synth, wav as W
from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

torch.set_num_threads(1)
POES_FS, ARGOS_FS = 50000.0, 32000.0
# short blocks (CPU time); the window (4,096) divides the POES total
PLANS = {"poes": (4096, 4096, 8192, 8), "argos": (8192, 8192, 8192, 8)}


def _wav(path, mode_name):
    """A synthetic recording with a noise lead-in (0.3 s POES, 0.4 s
    ARGOS) written as the CLIs read it."""
    if mode_name == "poes":
        iq, _ = synth.make_poes_recording(n_frames=4, fs=POES_FS)
        fs = POES_FS
    else:
        iq, _ = synth.make_argos_recording(n_packets=2, fs=ARGOS_FS,
                                           carrier_hz=200.0, snr_db=30.0)
        fs = ARGOS_FS
    W.write_iq_wav(path, iq / (np.abs(iq).max() * 1.2), int(fs))
    return path


@pytest.fixture(scope="module")
def poes_wav(tmp_path_factory):
    return _wav(str(tmp_path_factory.mktemp("fast") / "poes.wav"), "poes")


def _jax_cli(mode_name, argv, monkeypatch):
    if mode_name == "poes":
        return jax_poes.run(argv)
    update = jax.config.update

    def no_x64(name, value):
        if name != "jax_enable_x64":
            update(name, value)
    monkeypatch.setattr(jax.config, "update", no_x64)
    monkeypatch.setattr("sys.argv", ["demod_argos", *argv])
    with pytest.raises(SystemExit) as done:
        jax_argos.main()
    return done.value.code


def _port_cli(mode_name, argv):
    if mode_name == "poes":
        return port_poes.run(argv)
    with pytest.raises(SystemExit) as done:
        port_argos.main(argv)
    return done.value.code


def _poes_blocks(wav):
    """The POES CLI's blocks (the small plan) as the port stages them:
    (plan, fs, samples, re and im blocks, first indices, norm gain)."""
    iq, _, fs, _ = W.load_iq_wav(wav, POES_TIP.np_dtype())
    plan = TB.BlockPlan(*PLANS["poes"])
    dt = np.dtype(np.float32)
    n = len(iq)
    brs, bis, lo = TB.stage_blocks(np.ascontiguousarray(iq.real, dt),
                                   np.ascontiguousarray(iq.imag, dt), plan,
                                   0, -(-n // plan.core), dt)
    norm = float(agc.static_gain(iq[:POES_TIP.chunk_size],
                                 POES_TIP.static_gain_level, dt))
    return plan, fs, n, brs, bis, lo, norm


def test_default_branch_is_jax():
    for port, ref in ((TB.demodulate_blocked, JB.demodulate_blocked),
                      (TB.demod_blocks, JB.demod_blocks)):
        want = inspect.signature(ref).parameters["use_pallas"].default
        assert want is False
        assert inspect.signature(port).parameters["use_pallas"].default \
            is want
    assert inspect.signature(TB.max_lanes).parameters["use_pallas"].default \
        is False


@pytest.mark.parametrize("mode_name, opts", [
    ("poes", []), ("argos", []), ("argos", ["--mode", "argos_realtime"])])
def test_fast_cli_matches_jax_cli(mode_name, opts, poes_wav, tmp_path,
                                  monkeypatch):
    wav = poes_wav if mode_name == "poes" else _wav(
        str(tmp_path / "argos.wav"), "argos")
    monkeypatch.setattr(JB, "default_plan",
                        lambda *a, **k: JB.BlockPlan(*PLANS[mode_name]))
    monkeypatch.setattr(TB, "default_plan",
                        lambda *a, **k: TB.BlockPlan(*PLANS[mode_name]))
    j_out, t_out = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    assert _jax_cli(mode_name, [wav, "--fast", *opts, "--out", j_out],
                    monkeypatch) == 0
    assert _port_cli(mode_name, [wav, "--fast", *opts, "--device", "cpu",
                                 "--out", t_out]) == 0
    j_lines = open(j_out).read().splitlines()
    t_lines = open(t_out).read().splitlines()
    assert len(j_lines) >= (3 if mode_name == "poes" else 1)
    assert t_lines == j_lines


@pytest.fixture(scope="module")
def fused_both(poes_wav):
    """The POES CLI's blocks, repeated to 128 lanes, through the port's
    and JAX's fused branch of demod_blocks on the same position plane;
    returns (port's result, JAX's, the port's dense emit plane)."""
    plan, fs, n, brs, bis, lo, norm = _poes_blocks(poes_wav)
    n_blocks = len(lo)
    lanes = np.arange(128) % n_blocks
    brs, bis, lo = brs[lanes], bis[lanes], lo[lanes]
    pos = TB.sample_positions(torch.from_numpy(lo), n, plan.total, 1)
    zre, zim = torch.from_numpy(brs), torch.from_numpy(bis)
    fest = TB.coarse_carrier_est(zre, zim, fs, POES_TIP.gardner.baud / 2.0)
    jparams = JC.make_params(J_POES, fs, quirks=False)
    emits = []
    real = TB.fused_demod

    def spy(*args, **kw):
        out = real(*args, **kw)
        emits.append(out[2])
        return out
    TB.fused_demod = spy
    try:
        port = TB.demod_blocks(TC.from_jax(jparams), plan.total, zre, zim, fs,
                               pos, fest, norm, 4096, "fused")
    finally:
        TB.fused_demod = real
    ref = JB.demod_blocks(jparams, plan.total, jnp.asarray(brs),
                          jnp.asarray(bis), fs, jnp.asarray(pos.numpy()),
                          jnp.asarray(fest.numpy()), norm, 4096, "fused",
                          interpret=True)
    return port, ref, emits[0][:n_blocks]


def test_poes_input_has_two_emissions_in_a_chunk(fused_both):
    _, _, emit = fused_both
    per_chunk = emit.reshape(emit.shape[0], -1, 4).sum(-1)
    assert int((per_chunk >= 2).sum()) >= 1


def test_fused_branch_still_matches_jax_fused(fused_both):
    port, want, _ = fused_both
    (bits, pos, n_bits), (j_bits, j_pos, j_n) = (
        [np.asarray(a) for a in r[:3]] for r in (port, want))
    assert np.array_equal(bits, j_bits) and np.array_equal(n_bits, j_n)
    assert int(j_n.min()) > 1000                     # every lane decodes
    live = np.arange(pos.shape[1]) < j_n[:, None]
    shift = np.abs(pos - j_pos)[live]
    assert shift.max() <= 1.0 and np.mean(shift > 0) <= 0.02

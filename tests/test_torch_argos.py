"""The ARGOS fast path of the port against the JAX package, on the CPU.

- The fused chain's plain version in the ARGOS geometry (interp 1, 50-tap
  FIR, squelch after the AGC, symbol period 40) against the JAX Pallas
  kernel in interpret mode, f32 and int16 input, with the lane rule of
  tests/test_torch_fused.py.
- The port's ``demod_argos --fast --device cpu`` CLI loads the WAV with
  the mode's float64 time axis, runs ``demodulate_blocked`` on the CPU in
  the ARGOS mode and writes its frames to the packets file.  The
  demodulation itself, most of a minute of plain per-sample loops here,
  is held against JAX in tests/test_torch_argos_blocked.py on the same
  kind of recording.

The ARGOS_REALTIME inverse-sync case is in tests/test_torch_argos_realtime.py
(each file stays under a minute on the CPU).
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu import chain as JC
from project_desert_tortoise_tpu.utils.config import ARGOS as J_ARGOS
from project_desert_tortoise_tpu_torch.apps import demod_argos
from project_desert_tortoise_tpu_torch.ops.framer import Frame
from project_desert_tortoise_tpu_torch.parallel import blocked as TB
from project_desert_tortoise_tpu_torch.utils import synth, wav as W
from project_desert_tortoise_tpu_torch.utils.config import ARGOS
from project_desert_tortoise_tpu_torch.utils.output import parse_frames_file
from test_torch_fused import _both, _check_lanes

torch.set_num_threads(1)
FS = 32000.0
PLAN = (8192, 8192, 8192, 8)          # tests/test_blocked_argos.py:33


def _argos_input(B, L, seed):
    """tests/test_pallas_fused.py:101-108: 40-sample symbols with noise."""
    rng = np.random.default_rng(seed)
    sym = rng.choice([-1.0, 1.0], size=(B, L // 40 + 2))
    base = np.repeat(sym, 40, axis=1)[:, :L]
    re = (base * 0.01 + 0.001 * rng.standard_normal((B, L))).astype(np.float32)
    im = (0.001 * rng.standard_normal((B, L))).astype(np.float32)
    tn = np.tile(np.arange(L, dtype=np.float32) / FS, (B, 1))
    return re, im, tn


@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_argos_fused_ref_matches_pallas(dtype):
    params = JC.make_params(J_ARGOS, FS, quirks=False)
    assert (params.interp, len(params.taps)) == (1, 50)
    assert params.squelch_position == "after_agc"
    re, im, tn = _argos_input(128, 2048, 1)
    if dtype == "int16":
        re = np.round(re * 32768.0).astype(np.int16)
        im = np.round(im * 32768.0).astype(np.int16)
    _check_lanes(*_both(params, re, im, tn, gain=50.0), min_emitted=1000,
                 fs=FS)


def recording(tmp_path, name, cfg, **kw):
    """A synthetic ARGOS WAV, loaded back with the mode's time axis (float64
    for ARGOS, as the CLI loads it)."""
    iq, payloads = synth.make_argos_recording(fs=FS, carrier_hz=200.0,
                                              snr_db=30.0, **kw)
    path = str(tmp_path / name)
    W.write_iq_wav(path, iq / (np.abs(iq).max() * 1.2), int(FS))
    iq, t, fs, _ = W.load_iq_wav(path, cfg.np_dtype())
    return path, iq, t, payloads


def test_demod_argos_cli_on_cpu(tmp_path, monkeypatch, capsys):
    path, iq, t, payloads = recording(tmp_path, "argos.wav", ARGOS,
                                      n_packets=4)
    assert t.dtype == np.float64
    frames = [Frame(1.2225 * k + 0.5, False, p)
              for k, p in enumerate(payloads)]
    seen = []

    def demod(iq_, t_, fs, mode, norm_factor=None, device="cuda"):
        seen.append((mode, device, fs))
        assert np.array_equal(iq_, iq) and np.array_equal(t_, t)
        assert t_.dtype == np.float64
        return frames
    monkeypatch.setattr(TB, "demodulate_blocked", demod)
    out = str(tmp_path / "packets.txt")
    monkeypatch.setattr("sys.argv", ["demod_argos", path, "--fast",
                                     "--device", "cpu", "--out", out])
    with pytest.raises(SystemExit) as done:
        demod_argos.main()
    assert done.value.code == 0
    assert seen == [(ARGOS, "cpu", FS)]
    lines = parse_frames_file(out)
    assert len(lines) == len(frames) >= 4
    for (ts, inv, data), f in zip(lines, frames):
        assert bytes(data) == bytes(f.data) and inv == f.inverted
        assert abs(ts - f.time) <= 1e-5          # printed with 5 decimals
    assert "Total samples" in capsys.readouterr().out

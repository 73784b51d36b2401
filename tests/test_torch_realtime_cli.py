"""The port's realtime and serving CLIs (``apps/demod_realtime.py``,
``apps/demod_serve.py``) on the CPU against the JAX package's functions on
the same samples, and the port's ``deinterleave`` against JAX's.

``demod_realtime`` reads interleaved float32 IQ on stdin in a subprocess
(as a live feed would arrive).  The JAX realtime CLI itself needs JAX's
native ring, which this tree cannot build (tests/conftest.py), so its
streamers are run with the port's ring instead; ``demod_serve`` is
compared with the JAX CLI's output files.  Tolerance (docs/DESIGN.md
section 4b): frame counts, ``inverted`` and payloads identical, times
within one sample period on at most 2% of the frames (at most one here).
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from project_desert_tortoise_tpu.apps import demod_serve as JServe
from project_desert_tortoise_tpu.models import streaming as JSM
from project_desert_tortoise_tpu.utils import audio as JA
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu.utils.config import POES_TIP_REALTIME
from project_desert_tortoise_tpu_torch.apps import demod_serve as TServe
from project_desert_tortoise_tpu_torch.native.wavio import IQRing
from project_desert_tortoise_tpu_torch.utils import audio as TA
from project_desert_tortoise_tpu_torch.utils.output import parse_frames_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 48000.0


def _parity(a, b, fs):
    """a, b: (time, inverted, bytes) lines as parse_frames_file gives."""
    assert len(a) == len(b) > 0
    assert [x[1:] for x in a] == [y[1:] for y in b]
    shifted = [abs(x[0] - y[0]) for x, y in zip(a, b) if x[0] != y[0]]
    assert all(d <= 1.0001 / fs + 1e-5 for d in shifted)
    assert len(shifted) <= max(1, 0.02 * len(a))


@pytest.fixture(scope="module")
def live():
    """6 frames of poes_tip_realtime at the CLI's default 48 kHz, as the
    interleaved float32 bytes stdin carries; a whole number of chunks."""
    iq, _ = synth.make_poes_recording(n_frames=6, fs=FS, carrier_hz=-2000.0,
                                      snr_db=28.0,
                                      rng=np.random.default_rng(2))
    chunk = POES_TIP_REALTIME.chunk_size
    iq = iq[:len(iq) // chunk * chunk].astype(np.complex64)
    x = np.empty((len(iq), 2), "<f4")
    x[:, 0], x[:, 1] = iq.real, iq.imag
    return iq, x.tobytes()


def _realtime(tmp_path, stdin: bytes, *flags):
    out = str(tmp_path / ("fast.txt" if flags else "exact.txt"))
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run(
        [sys.executable, "-m",
         "project_desert_tortoise_tpu_torch.apps.demod_realtime",
         "--device", "cpu", "--out", out, *flags],
        input=stdin, capture_output=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert b"frames ->" in r.stdout and b"0 overrun" in r.stdout
    assert b"Sec:" in r.stderr              # the status line
    return parse_frames_file(out)


def _jax_stream(sd, iq):
    def produce():
        JSM.feed_array(sd.ring, iq, chunk=8192)
        sd.stop()
    th = threading.Thread(target=produce, daemon=True)
    th.start()
    frames = sd.run(poll_s=0.002)
    th.join(timeout=60)
    return [(float(f"{f.time:.5f}"), f.inverted, list(f.data))
            for f in frames]


def test_demod_realtime_exact_from_stdin(live, tmp_path):
    iq, stdin = live
    port = _realtime(tmp_path, stdin)
    jax = _jax_stream(JSM.StreamingDemodulator(
        POES_TIP_REALTIME, FS, ring=IQRing(1 << 18)), iq)
    assert len(port) >= 3
    _parity(jax, port, FS)


def test_demod_realtime_fast_from_stdin(live, tmp_path):
    iq, stdin = live
    port = _realtime(tmp_path, stdin, "--fast")
    jax = _jax_stream(JSM.FastStreamingDemodulator(
        POES_TIP_REALTIME, FS, ring=IQRing(1 << 20)), iq)
    assert len(port) >= 3
    _parity(jax, port, FS)


def test_demod_serve_matches_the_jax_cli(tmp_path):
    """Two int16 WAV channels through both CLIs with a small core: the
    same file names and lines."""
    paths = []
    for c, seed in enumerate((3, 11)):
        iq, _ = synth.make_poes_recording(n_frames=8, fs=50000.0,
                                          snr_db=28.0,
                                          rng=np.random.default_rng(seed))
        paths.append(str(tmp_path / f"ch{c}.wav"))
        W.write_iq_wav(paths[-1], iq / (np.abs(iq).max() * 1.1), 50000)
    common = ["--batch-blocks", "16", "--core", "16384", "--chunk", "100000"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert JServe.run(paths + ["--out-dir", str(tmp_path / "jax")]
                      + common) == 0
    assert TServe.run(paths + ["--out-dir", str(tmp_path / "port"),
                               "--device", "cpu"] + common) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["frames_0_ch0.txt", "frames_1_ch1.txt"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        jax = parse_frames_file(str(tmp_path / "jax" / name))
        port = parse_frames_file(str(tmp_path / "port" / name))
        assert len(port) >= 6
        _parity(jax, port, 50000.0)


def test_demod_serve_refuses_fused_without_128_lane_batches(tmp_path):
    with pytest.raises(SystemExit):
        TServe.run([str(tmp_path / "x.wav"), "--use-pallas", "fused",
                    "--batch-blocks", "64", "--device", "cpu"])


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_deinterleave_matches_jax(channels, dtype):
    rng = np.random.default_rng(channels)
    if dtype == np.int16:
        buf = rng.integers(-32768, 32768, 4002 * channels).astype(np.int16)
    else:
        buf = rng.standard_normal(4002 * channels).astype(np.float32)
    for a, b in zip(TA.deinterleave(buf, channels),
                    JA.deinterleave(buf, channels)):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)


@pytest.mark.parametrize("cli", ["demod_realtime", "demod_serve"])
def test_the_clis_default_to_the_card(cli, tmp_path, monkeypatch):
    """Without --device the CLIs ask for cuda, and without a card they
    raise before reading any input or writing any output."""
    import importlib
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(
        f"project_desert_tortoise_tpu_torch.apps.{cli}")
    argv = ([str(tmp_path / "x.wav"), "--out-dir", str(tmp_path)]
            if cli == "demod_serve" else ["--out", str(tmp_path / "f.txt")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.run(argv)
    assert list(tmp_path.iterdir()) == []

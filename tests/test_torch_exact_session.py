"""The port's ``StreamFramer`` and whole ``DemodSession`` runs against the
JAX package's, on the CPU (the kernels' plain versions).

Tolerance.  The framer is exact: the same bits and times give the same
frames, field for field.  Whole sessions are held to the
``docs/DESIGN.md`` §4b contract: frame counts, payloads and polarity
identical, timestamps equal or one sample period apart on at most a few
frames.  From the first sample on, the two chains' soft values differ by
the float32 envelope of ``tests/test_torch_exact_chain.py`` (XLA's
``sin``/``cos`` and contractions, the convolution's order), so the noise
bits before the PLL locks can differ and the bit counts are not compared;
the annotations (quality from the PLL's ``avg_phase``, the M2M4 SNR in
numpy's float32 order, the carrier) are held to 0.05 dB and 0.5 Hz, the
post-AGC ``raw_tap`` stream (values near 1) to 1e-3: from an unlocked
start the acquisition sweep carries the ulp differences into the phase
for a whole clip, where the carried-state test of
``tests/test_torch_exact_chain.py`` sees 1e-4 over three chunks.
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu.models.demodulator import (
    DemodSession as JaxSession)
from project_desert_tortoise_tpu.ops.framer import StreamFramer as JaxFramer
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu.utils.config import ARGOS_REALTIME
from project_desert_tortoise_tpu.utils.config import (
    POES_TIP_REALTIME as J_POES_RT)
from project_desert_tortoise_tpu_torch.models.demodulator import (
    DemodSession as PortSession)
from project_desert_tortoise_tpu_torch.ops.framer import StreamFramer
from project_desert_tortoise_tpu_torch.utils import config as TCFG
from test_framer import _plant

torch.set_num_threads(1)


def parity(a, b, fs):
    """§4b: counts, payloads and polarity identical; timestamps within one
    sample period, shifted on at most a tenth of the frames."""
    assert len(a) == len(b) > 0
    shifted = 0
    for x, y in zip(a, b):
        assert x.inverted == y.inverted and x.complete == y.complete
        assert np.array_equal(x.data, y.data)
        if x.time != y.time:
            assert abs(x.time - y.time) <= 1.0001 / fs
            shifted += 1
    assert shifted <= max(1, len(a) // 10)


@pytest.mark.parametrize("mode", ["poes_tip", "argos_realtime"])
def test_stream_framer_matches_jax(mode):
    """Planted sync words (every other one inverted), fed in uneven
    chunks, with a partial frame left at the end for flush()."""
    cfg = TCFG.MODES[mode].framer
    rng = np.random.default_rng(4)
    bits, _ = _plant(rng, cfg, 6, gap=30, inverted_every=2)
    bits = bits[:-30 - cfg.payload_bits // 2]       # a partial last frame
    times = (np.arange(len(bits)) * 1.25e-4).astype(np.float32)
    jf, tf = JaxFramer(cfg), StreamFramer(cfg)
    edges = [0, 7, 300, 301, 1500, len(bits)]
    for a, b in zip(edges[:-1], edges[1:]):
        j, t = jf.process(bits[a:b], times[a:b]), tf.process(bits[a:b],
                                                              times[a:b])
        assert [f.hex_line() for f in j] == [f.hex_line() for f in t]
    assert jf.flush().hex_line() == tf.flush().hex_line()
    assert len(tf.frames) == len(jf.frames) >= 4
    for x, y in zip(jf.frames, tf.frames):
        assert (x.time, x.inverted, x.complete) == (y.time, y.inverted,
                                                    y.complete)
        assert np.array_equal(x.data, y.data) and x.data.dtype == y.data.dtype


def _clip(mode, n):
    if mode.startswith("argos"):
        iq, _ = synth.make_argos_recording(n_packets=n, fs=32000.0)
        fs = 32000.0
    else:
        iq, _ = synth.make_poes_recording(n_frames=n, fs=50000.0)
        fs = 50000.0
    iq = (iq / (np.abs(iq).max() * 1.2)).astype(np.complex64)
    return iq, W.time_axis(len(iq), fs, np.float32), fs


@pytest.mark.parametrize("mode,n,port_cfg,jax_cfg", [
    ("poes_tip_realtime", 4, TCFG.POES_TIP_REALTIME, J_POES_RT),
    ("argos_realtime", 2, TCFG.ARGOS_REALTIME, ARGOS_REALTIME),
])
def test_session_matches_jax(mode, n, port_cfg, jax_cfg, tmp_path):
    """Whole sessions with the quality annotation and the raw tap on:
    ``poes_tip_realtime`` (chunk 2,400, squelch after the PLL) and
    ``argos_realtime`` (interp 1, squelch after the AGC, inverse sync)."""
    iq, t, fs = _clip(mode, n)
    sessions, taps = [], []
    for cls, cfg, kw in ((JaxSession, jax_cfg, {}),
                         (PortSession, port_cfg, {"device": "cpu"})):
        s = cls(cfg, fs, annotate_quality=True, **kw)
        path = tmp_path / f"{cls.__module__}.raw"
        with open(path, "wb") as s.raw_tap:
            sessions.append((s, s.run(iq, t)))
        taps.append(np.fromfile(path, np.float32))
    (js, jr), (ts, tr) = sessions
    parity(jr.frames, tr.frames, fs)
    assert len(tr.frames) >= n - 1
    assert tr.total_samples == jr.total_samples == len(iq)
    assert abs(tr.lock_freq_hz - jr.lock_freq_hz) < 0.5
    assert abs(tr.quality_db - jr.quality_db) < 0.05
    for x, y in zip(jr.frames, tr.frames):
        assert abs(x.quality_db - y.quality_db) < 0.05
        assert abs(x.carrier_hz - y.carrier_hz) < 0.5
        assert abs(x.snr_db - y.snr_db) < 0.05 or np.isnan(x.snr_db)
    assert taps[0].shape == taps[1].shape
    assert np.abs(taps[0] - taps[1]).max() < 1e-3


def test_reacquire_watchdog_matches_jax():
    """A quality floor no signal meets: once locked, each session resets
    its PLL to acquisition every 0.1 s of low quality, as often as the
    JAX one (the first 0.9 s of a packet's clip: lock at 0.6 s)."""
    iq, t, fs = _clip("argos_realtime", 1)
    iq, t = iq[:28800], t[:28800]
    kw = dict(reacquire_after_s=0.1, reacquire_quality_db=100.0)
    j = JaxSession(ARGOS_REALTIME, fs, **kw)
    p = PortSession(TCFG.ARGOS_REALTIME, fs, device="cpu", **kw)
    j.run(iq, t)
    p.run(iq, t)
    assert p.reacquisitions == j.reacquisitions > 0

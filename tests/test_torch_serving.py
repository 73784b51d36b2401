"""The port's multi-channel serving (``parallel/serving.py::ChannelBank``)
and ``demodulate_many`` against the JAX package's, and against each other.

Two synthetic POES channels (PCM-quantized, so int16 and float32 staging
see the same samples), the small plan of tests/test_serving.py, the CPU
(the kernels' plain versions).  Tolerance (docs/DESIGN.md section 4b):
against JAX, frame counts, ``inverted`` and payloads identical, times
within one sample period on at most 2% of frames; inside the port (bank
against ``demodulate_many``, int16 against float32 staging, padded
against unpadded batches) the hex lines are identical.  A CPU launch of
the plain versions takes ~20 s at this plan whatever the lane count, so
each run pushes in a few large chunks.
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.parallel import serving as JS
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu.utils.config import POES_TIP
from project_desert_tortoise_tpu_torch.parallel import blocked as TB
from project_desert_tortoise_tpu_torch.parallel import serving as TS

torch.set_num_threads(1)
FS = 50000.0
PLAN = (16384, 12288, 8192, 8)
# per-channel push sizes of the streaming runs: awkward, different, and
# large enough that each pump releases a few blocks
STEPS = (33331, 40000)


def _parity(a, b, fs=FS):
    assert len(a) == len(b) > 0
    shifted = 0
    for x, y in zip(a, b):
        assert x.inverted == y.inverted
        assert np.array_equal(x.data, y.data)
        if x.time != y.time:
            assert abs(x.time - y.time) <= 1.0001 / fs
            shifted += 1
    assert shifted <= 0.02 * len(a)


def _lines(frames):
    return [f.hex_line() for f in frames]


@pytest.fixture(scope="module")
def recordings():
    """Two 10-frame channels, quantized to int16 PCM: (float IQ, re, im)."""
    chans = []
    for seed in (3, 11):
        iq, _ = synth.make_poes_recording(n_frames=10, fs=FS, snr_db=28.0,
                                          rng=np.random.default_rng(seed))
        chans.append(iq)
    n = min(len(c) for c in chans)
    iq = np.stack([c[:n] for c in chans])
    q = lambda x: np.clip(np.round(x * 32768.0), -32768, 32767).astype(
        np.int16)
    re, im = q(np.real(iq)), q(np.imag(iq))
    iq = (re.astype(np.float32) / 32768.0
          + 1j * (im.astype(np.float32) / 32768.0)).astype(np.complex64)
    return iq, re, im


def _stream(bank, iq, pump=True):
    """Push each channel in STEPS-sized pieces, pumping after each round;
    returns the largest history a channel held after a pump."""
    C, n = iq.shape
    pos, held = [0] * C, 0
    while any(p < n for p in pos):
        for c in range(C):
            hi = min(pos[c] + STEPS[c], n)
            if pos[c] < hi:
                bank.push(c, np.real(iq[c, pos[c]:hi]),
                          np.imag(iq[c, pos[c]:hi]))
                pos[c] = hi
        if pump:
            bank.pump()
            held = max(held, max(len(ch.re) for ch in bank.channels))
    bank.drain()
    return held


@pytest.fixture(scope="module")
def port_bank(recordings):
    iq, _, _ = recordings
    bank = TS.ChannelBank(POES_TIP, FS, len(iq), plan=TB.BlockPlan(*PLAN),
                          batch_blocks=16, device="cpu")
    held = _stream(bank, iq)
    return bank, held


@pytest.fixture(scope="module")
def port_many(recordings):
    iq, _, _ = recordings
    t = W.time_axis(iq.shape[1], FS, np.float32)
    return TB.demodulate_many(iq, t, FS, POES_TIP, plan=TB.BlockPlan(*PLAN),
                              batch_blocks=16, device="cpu")


@pytest.fixture(scope="module")
def jax_many(recordings):
    iq, _, _ = recordings
    t = W.time_axis(iq.shape[1], FS, np.float32)
    return JB.demodulate_many(iq, t, FS, POES_TIP, plan=JB.BlockPlan(*PLAN),
                              batch_blocks=16)


def test_bank_matches_jax_bank(recordings, port_bank):
    """The same pushes and pumps through JAX's ChannelBank (its XLA
    branch, JAX's default) and the port's (the scan kernels' plain
    versions)."""
    iq, _, _ = recordings
    jbank = JS.ChannelBank(POES_TIP, FS, len(iq), plan=JB.BlockPlan(*PLAN),
                           batch_blocks=16)
    _stream(jbank, iq)
    bank, _ = port_bank
    for c in range(len(iq)):
        _parity(jbank.frames[c], bank.frames[c])


def test_demodulate_many_matches_jax(port_many, jax_many):
    assert len(port_many) == len(jax_many) == 2
    for a, b in zip(jax_many, port_many):
        _parity(a, b)


def test_bank_matches_demodulate_many(port_bank, port_many):
    """The parity contract: streamed in awkward pieces and batched as they
    became ready, the bank gives demodulate_many's lines."""
    bank, _ = port_bank
    assert bank.batches >= 3          # it did stream: several launches
    for c, want in enumerate(port_many):
        assert len(want) >= 9
        assert _lines(bank.frames[c]) == _lines(want)


def test_history_stays_bounded(port_bank):
    bank, held = port_bank
    P = TB.BlockPlan(*PLAN)
    assert 0 < held <= 6 * P.core + P.total
    assert all(c.base > 0 for c in bank.channels)


def test_int16_staging_matches_f32(recordings, port_many):
    """stage_dtype=int16 banks the raw PCM planes and converts on the
    device; pushed int16, every frame is as with float32 staging.  The
    same run checks on_frame: every frame once, in stream order per
    channel."""
    iq, re, im = recordings
    got = []
    bank = TS.ChannelBank(POES_TIP, FS, len(iq), plan=TB.BlockPlan(*PLAN),
                          batch_blocks=16, stage_dtype=np.int16,
                          on_frame=lambda ci, f: got.append((ci, f)),
                          device="cpu")
    for c in range(len(iq)):
        bank.push(c, re[c], im[c])
    assert bank.channels[0].re.dtype == np.int16
    assert bank.drain() == 10 and bank.batches == 1
    for c, want in enumerate(port_many):
        assert _lines(bank.frames[c]) == _lines(want)
        mine = [f for ci, f in got if ci == c]
        assert len(mine) == len(bank.frames[c])
        assert all(a is b for a, b in zip(mine, bank.frames[c]))
    assert len(got) == sum(map(len, port_many))


def test_pad_batches_off_matches_on(recordings, port_bank, monkeypatch):
    """pad_batches=False launches only the ready rows; the frames are the
    padded bank's."""
    iq, _, _ = recordings
    bank = TS.ChannelBank(POES_TIP, FS, len(iq), plan=TB.BlockPlan(*PLAN),
                          batch_blocks=16, pad_batches=False, device="cpu")
    shapes = []
    real = TB.coarse_carrier_est

    def spy(zre, *a, **k):
        shapes.append(tuple(zre.shape))
        return real(zre, *a, **k)
    monkeypatch.setattr(TB, "coarse_carrier_est", spy)
    for c in range(len(iq)):
        bank.push(c, np.real(iq[c]), np.imag(iq[c]))
    bank.drain()
    assert shapes == [(10, PLAN[0] + PLAN[1] + PLAN[2])]
    ref, _ = port_bank
    for c in range(len(iq)):
        assert _lines(bank.frames[c]) == _lines(ref.frames[c])

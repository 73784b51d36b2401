"""The port's block-parallel slice against the JAX package's fast path, on
a synthetic POES recording.

Tolerance (docs/DESIGN.md section 4b): frame counts and payloads
identical; timestamps equal, or one sample period apart on at most 2% of
frames.  The CPU runs take the kernel's plain PyTorch version, so the plan
is the small one of tests/test_pallas_fused.py (the default plan's blocks
are 126,976 samples, too long for a per-sample loop here).
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu.utils.config import POES_TIP
from project_desert_tortoise_tpu_torch.parallel import blocked as TB

torch.set_num_threads(1)
FS = 50000.0
PLAN = (8192, 12288, 8192, 8)


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


@pytest.fixture(scope="module")
def recording():
    """An 8-frame synthetic pass and the port's frames for it."""
    iq, sent = synth.make_poes_recording(n_frames=8, fs=FS)
    t = W.time_axis(len(iq), FS, np.float32)
    frames = TB.demodulate_blocked(iq, t, FS, POES_TIP,
                                   plan=TB.BlockPlan(*PLAN),
                                   use_pallas="fused", device="cpu")
    return iq, t, sent, frames


@pytest.fixture(scope="module")
def jax_frames(recording):
    """JAX's frames for the recording through its XLA branch, what the JAX
    CLI's ``--fast`` runs."""
    iq, t, _, _ = recording
    return JB.demodulate_blocked(iq, t, FS, POES_TIP,
                                 plan=JB.BlockPlan(*PLAN), use_pallas=False)


def test_demodulate_blocked_matches_jax(recording, jax_frames):
    iq, t, sent, tf = recording
    _parity(jax_frames, tf)
    sent = {bytes(s) for s in sent}
    assert sum(bytes(f.data) in sent for f in tf) >= len(sent) - 1


@pytest.mark.parametrize("use_pallas", ["front", False])
def test_unfused_branches_match_jax(recording, jax_frames, use_pallas):
    """The front (PLL+FIR+AGC kernel) and scan (PLL, FIR, AGC kernels)
    branches against JAX's XLA branch."""
    iq, t, sent, _ = recording
    tf = TB.demodulate_blocked(iq, t, FS, POES_TIP, plan=TB.BlockPlan(*PLAN),
                               use_pallas=use_pallas, device="cpu")
    _parity(jax_frames, tf)
    sent = {bytes(s) for s in sent}
    assert sum(bytes(f.data) in sent for f in tf) >= len(sent) - 1


def test_stitching_survives_a_stalled_time_axis(recording):
    """The float32 accumulated axis stops advancing at 512 s (50 kHz), as
    on a 12-minute pass (ROADMAP fault (f)).  The port stitches on sample
    positions, so it keeps every frame and labels each with the axis value
    at its sync."""
    iq, t, _, ok = recording
    t_stall = W.time_axis(len(iq), FS, np.float32, t0=511.99)
    assert np.sum(np.diff(t_stall) == 0) > len(iq) // 2
    stalled = TB.demodulate_blocked(iq, t_stall, FS, POES_TIP,
                                    plan=TB.BlockPlan(*PLAN),
                                    use_pallas="fused", device="cpu")
    assert [bytes(f.data) for f in stalled] == [bytes(f.data) for f in ok]
    idx = [int(np.argmin(np.abs(t - f.time))) for f in ok]
    assert [f.time for f in stalled] == [float(t_stall[i]) for i in idx]


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    iq = np.zeros(1000, np.complex64)
    t = W.time_axis(len(iq), FS, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TB.demodulate_blocked(iq, t, FS, POES_TIP, use_pallas="fused",
                              device="cuda")

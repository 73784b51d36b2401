"""In-kernel time generation of the fused chain (``t_next=None`` with
per-block seeds, padded-head counts and a step), on the CPU.

- The plain version against the JAX Pallas kernel's time generation in
  interpret mode, with block 0 zero-padded at its head; the lane rule of
  tests/test_torch_fused.py (emitted bits identical on every lane, bit
  times identical on >= 99% of lanes, within one sample period elsewhere).
- The fused branch of ``demod_frames`` generates the block-local sample
  positions it stitches on (step 1 from ``position_seeds``); the staged
  position plane on the same blocks must give the same bits, the same bit
  positions wherever the plane lies inside the recording, and the same
  frames.
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu import chain as JC
from project_desert_tortoise_tpu.utils.config import POES_TIP as J_POES
from project_desert_tortoise_tpu_torch import chain as TC
from project_desert_tortoise_tpu_torch.ops import agc, framer
from project_desert_tortoise_tpu_torch.parallel import blocked as TB
from project_desert_tortoise_tpu_torch.utils import synth
from project_desert_tortoise_tpu_torch.utils.config import POES_TIP
from test_torch_fused import FS, _both, _check_lanes, _input

torch.set_num_threads(1)
PLAN = TB.BlockPlan(4096, 2048, 6144, 8)     # short blocks: CPU time


def test_time_generation_ref_matches_pallas():
    params = JC.make_params(J_POES, FS, quirks=False)
    B, L, pad = 128, 2048, 700
    re, im, _ = _input(B, L, 5, 3)
    re[0, :pad] = 0.0                  # block 0: a zero-padded head
    im[0, :pad] = 0.0
    ts = float(np.float32(1.0) / np.float32(FS))
    t_seed = (np.arange(B, dtype=np.float32) * np.float32(0.25)
              + np.float32(ts))
    t_pad0 = np.zeros(B, np.float32)
    t_pad0[0] = pad
    j, t = _both(params, re, im, None, t_seed=t_seed, t_pad0=t_pad0, ts=ts)
    _check_lanes(j, t)
    # lane 0 reports time 0 for bits of its padded head
    assert not t[1][0][:pad][t[2][0][:pad]].any()


def _stitch(params, bits_c, pos_c, n_bits, lo, n):
    """demod_frames' framing and stitching of demod_blocks' output."""
    fb = framer.frame_extract(bits_c, pos_c, n_bits, POES_TIP.framer,
                              PLAN.max_frames)
    fb = fb._replace(times=fb.times.to(torch.float64) + lo[:, None])
    cs = lo + PLAN.head
    bounds = torch.stack([cs, torch.clamp(cs + PLAN.core, max=n)], 1)
    return framer.stitch_frames(fb, bounds, len(lo) * PLAN.max_frames)


def test_generated_positions_match_the_staged_plane(monkeypatch):
    iq, _ = synth.make_poes_recording(n_frames=4, fs=FS)
    n = len(iq)
    dt = np.dtype(np.float32)
    re = np.ascontiguousarray(iq.real, dt)
    im = np.ascontiguousarray(iq.imag, dt)
    brs, bis, lo = TB.stage_blocks(re, im, PLAN, 0, -(-n // PLAN.core), dt)
    zre, zim, lo = (torch.from_numpy(a) for a in (brs, bis, lo))
    assert lo[0] < 0 and int(lo[-1]) + PLAN.total > n   # padded both ends
    params = TC.make_params(POES_TIP, FS)
    fest = TB.coarse_carrier_est(zre, zim, FS, POES_TIP.gardner.baud / 2.0)
    norm = float(agc.static_gain(iq[:POES_TIP.chunk_size],
                                 POES_TIP.static_gain_level, dt))

    pos = TB.sample_positions(lo, n, PLAN.total, 1)
    _, pad0 = TB.position_seeds(lo, 1)
    assert float(pad0[0]) == PLAN.head and not pad0[1:].any()
    staged = TB.demod_blocks(params, PLAN.total, zre, zim, FS, pos, fest,
                             norm, use_pallas="fused")
    # demod_frames' own call of demod_blocks, kept by a spy
    gen = []

    def spy(*args, **kw):
        gen.append(demod_blocks(*args, **kw))
        return gen[-1]
    demod_blocks = TB.demod_blocks
    monkeypatch.setattr(TB, "demod_blocks", spy)
    got = TB.demod_frames(params, PLAN, POES_TIP.framer, FS, zre, zim, lo,
                          n, fest, norm, use_pallas="fused")
    bits_s, pos_s, n_s, avg_s = staged
    bits_g, pos_g, n_g, avg_g = gen[0]
    assert torch.equal(n_s, n_g) and int(n_s.sum()) > 100
    assert torch.equal(bits_s, bits_g) and torch.equal(avg_s, avg_g)
    inside = pos_s >= 0
    assert torch.equal(pos_s[inside], pos_g[inside])
    assert not torch.equal(pos_s, pos_g)       # they differ outside it

    want = _stitch(params, *staged[:3], lo, n)
    assert int(want[3]) >= 3
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_unfused_branches_refuse_time_generation():
    z = torch.zeros((2, 4096))
    params = TC.make_params(POES_TIP, FS)
    for br in ("front", False):
        with pytest.raises(ValueError, match="time generation"):
            TB.demod_blocks(params, 4096, z, z, FS, None, torch.zeros(2),
                            1.0, use_pallas=br, t_seed=torch.zeros(2),
                            t_pad0=torch.zeros(2))

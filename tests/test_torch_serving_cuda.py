"""``ChannelBank`` on the card against its own run on the CPU (the
kernels' plain versions), on each of the three branches: int16 PCM
planes, 16-row batches that mix two channels and pad the rest with silent
rows, streamed in awkward pieces.  Tolerance (docs/DESIGN.md section 4b,
the card's sin/cos round otherwise than the CPU's): frame counts,
``inverted`` and payloads identical, times within one sample period on at
most 2% of frames.  The card's frames must come from the branch's kernels:
each wrapper's launch count rises.

Marked ``cuda``; skips without a card.  On a machine with one:

    python -m pytest tests/test_torch_serving_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    pll_fir_agc)
from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
    fused_demod)
from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
    pll_scan_kernel)
from project_desert_tortoise_tpu_torch.parallel.blocked import BlockPlan
from project_desert_tortoise_tpu_torch.parallel.serving import ChannelBank
from project_desert_tortoise_tpu_torch.utils import synth
from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

FS = 50000.0
PLAN = BlockPlan(16384, 12288, 8192, 8)
KERNELS = {"fused": (fused_demod,),
           "front": (pll_fir_agc, scan_kernels.gardner_manchester),
           False: (pll_scan_kernel, scan_kernels.agc_scan,
                   scan_kernels.gardner_manchester)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def planes():
    out = []
    for seed in (3, 11):
        iq, _ = synth.make_poes_recording(n_frames=10, fs=FS, snr_db=28.0,
                                          rng=np.random.default_rng(seed))
        q = lambda x: np.clip(np.round(x[:70000] * 32768.0), -32768,
                              32767).astype(np.int16)
        out.append((q(iq.real), q(iq.imag)))
    return out


def _run(planes, use_pallas, device):
    bank = ChannelBank(POES_TIP, FS, len(planes), plan=PLAN,
                       batch_blocks=16, use_pallas=use_pallas,
                       stage_dtype=np.int16, device=device)
    steps = (33331, 40000)
    pos = [0, 0]
    while any(p < len(re) for p, (re, _) in zip(pos, planes)):
        for c, (re, im) in enumerate(planes):
            hi = min(pos[c] + steps[c], len(re))
            bank.push(c, re[pos[c]:hi], im[pos[c]:hi])
            pos[c] = hi
        bank.pump()
    bank.drain()
    return bank


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", ["fused", "front", False])
def test_bank_on_card_matches_cpu(card, planes, use_pallas):
    cpu = _run(planes, use_pallas, "cpu")
    for k in KERNELS[use_pallas]:
        k.launches = 0
    gpu = _run(planes, use_pallas, card)
    assert all(k.launches == gpu.batches for k in KERNELS[use_pallas])
    assert gpu.batches == cpu.batches >= 3
    for a, b in zip(cpu.frames, gpu.frames):
        assert len(a) == len(b) >= 9
        shifted = 0
        for x, y in zip(a, b):
            assert x.inverted == y.inverted
            assert np.array_equal(x.data, y.data)
            if x.time != y.time:
                assert abs(x.time - y.time) <= 1.0001 / FS
                shifted += 1
        assert shifted <= 0.02 * len(a)

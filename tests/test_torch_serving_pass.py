"""The reference result that chip_smoke.py's serving phase is held to,
recomputed with the JAX package on the CPU (ROADMAP faults (h), (i)).

chip_smoke.py serves 256 channels built from 32 synthetic POES recordings
(``chip_smoke.serving_recordings``: 24.6 s each, carriers spread evenly
over -3..+3 kHz, ``serve_carrier_hz``) on the fused and the scan branch.
Each channel must recover every payload of its recording once, but for
those JAX misses on it, ``chip_smoke.SERVE_REFERENCE_MISSED``, and decode
nothing else after the lead-in (``SERVE_LEAD_END_S``) but what JAX's same
branch decodes there, ``chip_smoke.SERVE_REFERENCE_LATE``.  The scan
branch's reference is JAX's ``demodulate_many`` (its XLA branch, the
default plan); the fused branch's, JAX's ``ChannelBank(use_pallas=
"fused")`` in 128-lane batches, its kernel on the Pallas interpreter.
JAX's misses are the carriers within ~250-700 Hz, where the fast path
loses the first block's frames.  Marked ``slow`` (~5 min on the CPU): out
of the tier-1 run.
"""

import collections

import numpy as np
import pytest

import chip_smoke
from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.parallel.serving import ChannelBank
from project_desert_tortoise_tpu.utils import wav as W
from project_desert_tortoise_tpu.utils.config import POES_TIP

FS = chip_smoke.POES_FS


def _jax_many(re, im):
    s = np.float32(1.0 / 32768.0)
    iqs = (re * s + 1j * (im * s)).astype(np.complex64)
    t = W.time_axis(iqs.shape[1], FS, np.float32)
    return JB.demodulate_many(iqs, t, FS, POES_TIP, batch_blocks=64)


def _jax_fused_bank(re, im):
    bank = ChannelBank(POES_TIP, FS, len(re), batch_blocks=128,
                       use_pallas="fused", stage_dtype=np.int16)
    for lo in range(0, re.shape[1], 200_000):
        for r in range(len(re)):
            bank.push(r, re[r, lo:lo + 200_000], im[r, lo:lo + 200_000])
        bank.pump()
    bank.drain()
    return bank.frames


def _reference(got, want, lead):
    missed, late = {}, {}
    for r, frames in enumerate(got):
        counts = collections.Counter(bytes(f.data) for f in frames)
        assert max(counts[w] for w in want[r]) == 1        # none twice
        m = tuple(i for i, w in enumerate(want[r]) if counts[w] == 0)
        known = set(want[r]) | {lead[r]}
        x = tuple(sorted(chip_smoke.payload_digest(bytes(f.data))
                         for f in frames if bytes(f.data) not in known
                         and f.time >= chip_smoke.SERVE_LEAD_END_S))
        if m:
            missed[r] = m
        if x:
            late[r] = x
    return missed, late


@pytest.fixture(scope="module")
def recordings():
    return chip_smoke.serving_recordings()


@pytest.mark.slow
@pytest.mark.parametrize("branch", [False, "fused"])
def test_reference_of_the_serving_recordings(recordings, branch):
    re, im, want, lead = recordings
    run = _jax_many if branch is False else _jax_fused_bank
    missed, late = _reference(run(re, im), want, lead)
    assert missed == chip_smoke.SERVE_REFERENCE_MISSED
    assert late == chip_smoke.SERVE_REFERENCE_LATE[branch]
    # fault (h): the misses lie in the first block (frames 0-20 of its
    # 2.05 s core), and only where the carrier is within 250-700 Hz
    for r, m in missed.items():
        assert 250.0 < abs(chip_smoke.serve_carrier_hz(r)) < 700.0, r
        assert max(m) < 21, (r, m)

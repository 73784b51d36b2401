"""The reference result that chip_smoke.py holds the port's ARGOS pass to.

chip_smoke.py decodes a synthetic 12-minute ARGOS pass (589 packets at
32 kHz, ``synth_pass("argos")``) on the card and requires the port to miss
exactly the packets the JAX package's fast path misses on it, listed in
``chip_smoke.ARGOS_REFERENCE_MISSED``, and to decode exactly the same
other payloads, ``chip_smoke.ARGOS_REFERENCE_EXTRA``.  This test
recomputes both lists:
the same WAV, loaded as the port's CLI loads it (float64 time axis),
through JAX's ``demodulate_blocked(ARGOS, use_pallas=False)`` with the
default plan, on the CPU.
"""

import numpy as np

import chip_smoke
from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.utils.config import ARGOS as J_ARGOS
from project_desert_tortoise_tpu_torch.utils import wav as W


def test_reference_misses_of_the_argos_pass(tmp_path):
    wav, want, lead_in = chip_smoke.synth_pass("argos", str(tmp_path))
    assert len(want) == chip_smoke.ARGOS_PACKETS and lead_in is None
    iq, t, fs, _ = W.load_iq_wav(wav, np.float64)
    frames = JB.demodulate_blocked(iq.astype(np.complex64), t, fs, J_ARGOS,
                                   plan=JB.default_plan(J_ARGOS, fs),
                                   use_pallas=False)
    got = [bytes(f.data) for f in frames]
    missed = tuple(i for i, w in enumerate(want) if w not in got)
    assert missed == chip_smoke.ARGOS_REFERENCE_MISSED
    wanted = set(want)
    extra = tuple(sorted(g.hex() for g in got if g not in wanted))
    assert extra == chip_smoke.ARGOS_REFERENCE_EXTRA
    assert len(got) == len(set(got))           # no packet twice

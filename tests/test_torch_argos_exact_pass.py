"""The reference result that chip_smoke.py holds the port's float64
``argos`` exact chain to on the 12-minute ARGOS pass.

chip_smoke.py's ``argos_exact_cli`` phase decodes the synthetic 12-minute
ARGOS pass (``synth_pass("argos")``, 589 packets, 23,041,680 samples at
32 kHz, 9,601 chunks) through the port's ``demod_argos`` without
``--fast`` on the card, and requires it to miss exactly the packets that
the JAX package's exact chain misses on the same WAV
(``chip_smoke.ARGOS_EXACT_REFERENCE_MISSED``) and to decode exactly the
same other payloads (``chip_smoke.ARGOS_EXACT_REFERENCE_EXTRA``).  This
test recomputes both with JAX's ``DemodSession`` in the ``argos`` mode
under x64 (turned off again in a ``finally``) on the CPU, the WAV loaded
as the port's CLI loads it.  It takes two to three minutes here, so it
is marked ``slow`` and stays out of the tier-1 run.
"""

import numpy as np
import jax
import pytest

import chip_smoke
from project_desert_tortoise_tpu.models.demodulator import DemodSession
from project_desert_tortoise_tpu.utils.config import ARGOS as J_ARGOS
from project_desert_tortoise_tpu_torch.utils import wav as W


@pytest.mark.slow
def test_reference_result_of_the_x64_exact_chain_on_the_argos_pass(
        tmp_path):
    wav, want, lead_in = chip_smoke.synth_pass("argos", str(tmp_path))
    assert len(want) == chip_smoke.ARGOS_PACKETS and lead_in is None
    iq, t, fs, _ = W.load_iq_wav(wav, np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        res = DemodSession(J_ARGOS, fs).run(iq, t)
    finally:
        jax.config.update("jax_enable_x64", False)
    got = [bytes(f.data) for f in res.frames]
    missed, extra, repeated = chip_smoke.payload_diff(got, want, lead_in)
    assert tuple(missed) == chip_smoke.ARGOS_EXACT_REFERENCE_MISSED
    assert tuple(extra) == chip_smoke.ARGOS_EXACT_REFERENCE_EXTRA
    assert repeated == []

"""The reference result that chip_smoke.py holds the port's exact chain to
on the 12-minute POES pass.

chip_smoke.py's ``exact_cli`` phase decodes the synthetic 12-minute POES
pass (``synth_pass("poes")``, 36 M samples, 3,600 chunks) through the
port's ``demod_poes`` without ``--fast`` on the card, and requires it to
miss exactly the payloads that the JAX package's exact chain misses on
the same WAV (``chip_smoke.EXACT_REFERENCE_MISSED``) and to decode exactly
the same other payloads (``chip_smoke.EXACT_REFERENCE_EXTRA``).  This test
recomputes both with JAX's ``DemodSession`` on the CPU, the WAV loaded as
the port's CLI loads it.  It takes about five minutes here, so it is
marked ``slow`` and stays out of the tier-1 run.
"""

import numpy as np
import pytest

import chip_smoke
from project_desert_tortoise_tpu.models.demodulator import DemodSession
from project_desert_tortoise_tpu.utils.config import POES_TIP as J_POES
from project_desert_tortoise_tpu_torch.utils import wav as W


@pytest.mark.slow
def test_reference_result_of_the_exact_chain_on_the_poes_pass(tmp_path):
    wav, want, lead_in = chip_smoke.synth_pass("poes", str(tmp_path))
    assert len(want) == chip_smoke.PASS_FRAMES
    iq, t, fs, _ = W.load_iq_wav(wav, np.float32)
    res = DemodSession(J_POES, fs).run(iq, t)
    got = [bytes(f.data) for f in res.frames]
    missed, extra, repeated = chip_smoke.payload_diff(got, want, lead_in)
    assert tuple(missed) == chip_smoke.EXACT_REFERENCE_MISSED
    assert tuple(extra) == chip_smoke.EXACT_REFERENCE_EXTRA
    assert repeated == []

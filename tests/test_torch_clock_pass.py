"""The reference results that chip_smoke.py holds the port's exact chain
under its other clocks to.

chip_smoke.py's ``clocks_exact`` phase decodes a synthetic 60-s POES
recording (``clock_recording``: 601 frames, 3,025,000 samples at 50 kHz)
through ``DemodSession`` on the card with each hand-built clock
configuration (``chip_smoke.clock_cfg``, ``CLOCK_RUNS``: ``"mm"`` with and
without the quirks, the two upsampling clocks without), in float32 and in
float64, and requires the payloads it misses, the other payloads it
decodes and those it decodes twice to be exactly the JAX package's on the
same WAV (``chip_smoke.CLOCK_REFERENCE``).  This test recomputes them with
JAX's ``DemodSession`` on the CPU (float64 under x64, turned off again in
a ``finally``), the WAV loaded as the port loads it.  It takes several
minutes a run here, so it is marked ``slow`` and stays out of the tier-1
run.
"""

import numpy as np
import jax
import pytest

import chip_smoke
from project_desert_tortoise_tpu.models.demodulator import DemodSession
from project_desert_tortoise_tpu.utils import config as JCFG
from project_desert_tortoise_tpu_torch.utils import wav as W


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    return chip_smoke.clock_recording(str(tmp_path_factory.mktemp("clk")))


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("clock,quirks", chip_smoke.CLOCK_RUNS)
def test_reference_result_of_each_clock(recording, clock, quirks, dtype):
    wav, want, lead_in = recording
    assert len(want) == chip_smoke.CLOCK_FRAMES
    iq, t, fs, _ = W.load_iq_wav(wav, np.dtype(dtype))
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        res = DemodSession(chip_smoke.clock_cfg(JCFG, clock, dtype), fs,
                           quirks=quirks).run(iq, t)
    finally:
        jax.config.update("jax_enable_x64", False)
    got = [bytes(f.data) for f in res.frames]
    missed, extra, repeated = chip_smoke.payload_diff(got, want, lead_in)
    assert (tuple(missed), tuple(extra), tuple(repeated)) == \
        chip_smoke.CLOCK_REFERENCE[clock, quirks, dtype]

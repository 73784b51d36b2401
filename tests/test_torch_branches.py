"""``demod_blocks`` of the port against the JAX package's on the same
staged blocks, per branch: compressed bits, bit times and bit counts.

JAX takes its Pallas branches only when the block count is a multiple of
128 (``parallel/blocked.py:266``) and silently runs its XLA scans
otherwise, so the front branch is compared at B = 128; the port runs the
branch it is asked for at any B.  The blocks are the small plan's
(tests/test_torch_blocked.py) cut from a synthetic POES recording and
repeated to fill the lanes.  Exact: the Gardner positions and the bits
agree on every lane.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu import chain as JC
from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.utils import synth
from project_desert_tortoise_tpu.utils.config import POES_TIP
from project_desert_tortoise_tpu_torch import chain as TC
from project_desert_tortoise_tpu_torch.parallel import blocked as TB

torch.set_num_threads(1)
FS = 50000.0
PLAN = TB.BlockPlan(8192, 12288, 8192, 8)


def test_demod_blocks_front_matches_jax_at_128_lanes():
    iq, _ = synth.make_poes_recording(n_frames=8, fs=FS)
    re = np.real(iq).astype(np.float32)
    im = np.imag(iq).astype(np.float32)
    brs, bis, lo = TB.stage_blocks(re, im, PLAN, 0, 5, np.float32)
    B = 128
    lanes = np.arange(B) % len(lo)
    brs, bis, lo = brs[lanes], bis[lanes], lo[lanes]
    pos = TB.sample_positions(torch.from_numpy(lo), len(iq), PLAN.total, 1)
    fest = TB.coarse_carrier_est(torch.from_numpy(brs), torch.from_numpy(bis),
                                 FS, POES_TIP.gardner.baud / 2.0)
    params = JC.make_params(POES_TIP, FS, quirks=False)
    j = JB.demod_blocks(params, PLAN.total, jnp.asarray(brs),
                        jnp.asarray(bis), FS, jnp.asarray(pos.numpy()),
                        jnp.asarray(fest.numpy()), 17.58, 4096, "front",
                        interpret=True)
    t = TB.demod_blocks(TC.from_jax(params), PLAN.total,
                        torch.from_numpy(brs), torch.from_numpy(bis), FS,
                        pos, fest, 17.58, 4096, "front")
    for a, b in zip(j[:3], t[:3]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int(np.asarray(j[2]).min()) > 4000       # every lane decodes


def test_branch_names():
    assert TB.branch(True) == "front"
    for name in ("fused", "front", False):
        assert TB.branch(name) == name
    with pytest.raises(ValueError, match="use_pallas"):
        TB.branch("fused2")
    assert TB.max_lanes(PLAN, False) < TB.max_lanes(PLAN, "front") \
        < TB.max_lanes(PLAN, "fused")


def test_unfused_branches_refuse_what_jax_cannot_run():
    params = TC.make_params(POES_TIP, FS)
    # a block length the window does not divide is no longer refused: it
    # runs unwindowed, as JAX falls back (window=0);
    # tests/test_torch_exact_scan.py holds that fallback to JAX
    z = torch.zeros((2, 1000))
    bits, _, n_bits, _ = TB.demod_blocks(params, 1000, z, z, FS, z,
                                         torch.zeros(2), 1.0, 4096, "front")
    max_syms = int(1000 * params.interp / params.step_size * 1.02) + 16
    assert bits.shape == (2, max_syms // 2 + 8) and n_bits.shape == (2,)
    after_agc = params._replace(squelch_threshold=0.15,
                                squelch_position="after_agc")
    z = torch.zeros((2, 4096))
    with pytest.raises(ValueError, match="after-AGC"):
        TB.demod_blocks(after_agc, 4096, z, z, FS, z, torch.zeros(2), 1.0,
                        4096, False)

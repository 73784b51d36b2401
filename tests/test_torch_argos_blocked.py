"""The port's ARGOS fast path against the JAX package's, on the CPU:
``demodulate_blocked(ARGOS, device="cpu")`` (the fused branch's plain
version) against JAX's ``demodulate_blocked(ARGOS, use_pallas=False)``
(what the JAX CLI's ``--fast`` runs) on a 4-packet synthetic recording
loaded as the CLI loads it (float64 time axis), with the plan of
tests/test_blocked_argos.py: the same payloads, timestamps within 1.5
sample periods (that file's tolerance), every packet decoded.

A file of its own: the port's plain per-sample loops take most of a
minute here.
"""

import numpy as np
import torch

from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.utils.config import ARGOS as J_ARGOS
from project_desert_tortoise_tpu_torch.parallel import blocked as TB
from project_desert_tortoise_tpu_torch.utils.config import ARGOS
from test_torch_argos import FS, PLAN, recording

torch.set_num_threads(1)


def test_argos_blocked_matches_jax(tmp_path):
    _, iq, t, payloads = recording(tmp_path, "argos.wav", ARGOS, n_packets=4)
    assert t.dtype == np.float64
    frames = TB.demodulate_blocked(iq, t, FS, ARGOS, plan=TB.BlockPlan(*PLAN),
                                   use_pallas="fused", device="cpu")
    jf = JB.demodulate_blocked(iq.astype(np.complex64), t, FS, J_ARGOS,
                               plan=JB.BlockPlan(*PLAN), use_pallas=False)
    mine = {bytes(f.data): f.time for f in frames}
    theirs = {bytes(f.data): f.time for f in jf}
    assert len(mine) == len(frames) and set(mine) == set(theirs)
    for k, v in mine.items():
        assert abs(v - theirs[k]) <= 1.5 / FS
    assert set(mine) >= {bytes(p) for p in payloads}

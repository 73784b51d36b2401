"""ARGOS_REALTIME through the port's fast path on the CPU: an inverted bit
stream (indistinguishable from the Costas loop settling on the opposite
BPSK point) decodes only through the framer's inverse sync
(``ARGOSdemodPortAudio/ByteSync.c:112``), as in
tests/test_blocked_argos.py:136-144."""

import torch

from project_desert_tortoise_tpu_torch.parallel import blocked as TB
from project_desert_tortoise_tpu_torch.utils.config import ARGOS_REALTIME
from test_torch_argos import FS, PLAN, recording

torch.set_num_threads(1)


def test_argos_realtime_inverted_uses_inverse_sync(tmp_path):
    _, iq, t, payloads = recording(tmp_path, "inv.wav", ARGOS_REALTIME,
                                   n_packets=2, invert_bits=True)
    frames = TB.demodulate_blocked(iq, t, FS, ARGOS_REALTIME,
                                   plan=TB.BlockPlan(*PLAN),
                                   use_pallas="fused", device="cpu")
    assert {bytes(f.data) for f in frames} >= {bytes(p) for p in payloads}
    # past the first block's warm-up (tests/test_blocked_argos.py:143)
    assert frames and all(f.inverted for f in frames if f.time > 1.0)

"""The upsampling clocks' chunked protocol in the port, on the CPU (the
kernels' plain versions).

- Chunk-size invariance (JAX ``tests/test_upsampling_clock.py:83-103``):
  a session at 7,000-sample chunks and one at 11,000 give the same lines,
  for ``"upsampling_gardner"`` and ``"upsampling_mm"``.  The norm is
  pinned (the first-chunk probe depends on the chunk by definition).
- A checkpoint of an upsampling session (``utils/checkpoint.py``) taken
  halfway and resumed with the hand-built configuration goes on bit for
  bit: the same lines and the same final state, the (2,) split pointers
  included, as the run without the stop.
"""

import functools

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu_torch.models.demodulator import (
    DemodSession)
from project_desert_tortoise_tpu_torch.utils import checkpoint as TCK
from project_desert_tortoise_tpu_torch.utils import config as TCFG
from project_desert_tortoise_tpu_torch.utils import synth, wav as W
from test_torch_clocks import clock_cfg

torch.set_num_threads(1)
FS = 50000.0
NORM = 17.58


@functools.lru_cache(maxsize=None)
def _recording():
    iq, _ = synth.make_poes_recording(n_frames=6, fs=FS, snr_db=30.0)
    t = W.time_axis(len(iq), FS, np.float32)
    ts = np.float32(1.0) / np.float32(FS)
    return iq, t, np.concatenate([t, [t[-1] + ts]]).astype(np.float32)


def _session(algorithm, chunk):
    return DemodSession(clock_cfg(TCFG, algorithm), FS, chunk_size=chunk,
                        quirks=False, norm_factor=NORM, device="cpu")


@functools.lru_cache(maxsize=None)
def _run(algorithm, chunk):
    iq, t, _ = _recording()
    sess = _session(algorithm, chunk)
    res = sess.run(iq, t)
    return [f.hex_line() for f in res.frames], sess.state


@pytest.mark.parametrize("algorithm", ["upsampling_gardner",
                                       "upsampling_mm"])
def test_upsampling_chunk_size_invariance(algorithm):
    a, _ = _run(algorithm, 7000)
    b, _ = _run(algorithm, 11000)
    assert a == b
    assert len(a) >= 4


def _leaves(state):
    if isinstance(state, tuple):
        return [x for f in state for x in _leaves(f)]
    return [state]


def test_upsampling_checkpoint_round_trip(tmp_path):
    algorithm, chunk = "upsampling_gardner", 7000
    iq, t, t_ext = _recording()
    n_chunks = -(-len(iq) // chunk)
    half = n_chunks // 2
    a = _session(algorithm, chunk)
    first = []
    for k in range(half):
        lo, hi = k * chunk, min((k + 1) * chunk, len(iq))
        first += a.process(iq[lo:hi], t[lo:hi], t_ext[lo + 1:hi + 1])
    assert first                  # frames on both sides of the stop
    assert a.state.gardner.next_sample.shape == (2,)
    ck = str(tmp_path / "upsampling.npz")
    TCK.save_session(a, ck)
    with pytest.raises(ValueError):        # another mode's configuration
        TCK.load_session(ck, TCFG.ARGOS, device="cpu")
    b = TCK.load_session(ck, clock_cfg(TCFG, algorithm), device="cpu")
    assert b.params.clock_algorithm == algorithm
    for x, y in zip(_leaves(a.state), _leaves(b.state)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for k in range(half, n_chunks):
        lo, hi = k * chunk, min((k + 1) * chunk, len(iq))
        b.process(iq[lo:hi], t[lo:hi], t_ext[lo + 1:hi + 1])
    b.framer.flush()
    lines, state = _run(algorithm, chunk)
    resumed = [f.hex_line() for f in b.framer.frames]
    assert len(resumed) < len(lines)
    assert [f.hex_line() for f in first] + resumed == lines
    for x, y in zip(_leaves(state), _leaves(b.state)):
        assert torch.equal(x, y)

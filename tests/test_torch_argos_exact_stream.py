"""The float64 ``argos`` mode in the port's exact streamer
(``models/streaming.py``) and in checkpoints (``utils/checkpoint.py``),
against the JAX package under x64 (a module fixture turns it on and, in
a ``finally``, off again), on the CPU (the plain versions in float64).

The input is a synthetic two-packet ARGOS recording cut to whole
2,400-sample chunks (the streamers leave a last partial chunk
unprocessed).  The JAX streamer is given the port's ``IQRing``, as in
``tests/test_torch_streaming.py``.  A checkpoint is taken halfway, after
eight chunks: a JAX x64 session saved in JAX's ``.npz`` layout (float64
leaves) resumes in the port, and a port session saved so resumes in JAX.
Tolerance (``docs/DESIGN.md`` §4b): packet counts, ``inverted`` and
payloads identical, timestamps within one sample period.
"""

import threading

import numpy as np
import jax
import pytest
import torch

from project_desert_tortoise_tpu.models import streaming as JSM
from project_desert_tortoise_tpu.models.demodulator import (
    DemodSession as JSession)
from project_desert_tortoise_tpu.utils import checkpoint as JCK
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu.utils.config import ARGOS
from project_desert_tortoise_tpu_torch.models import streaming as TSM
from project_desert_tortoise_tpu_torch.models.demodulator import (
    DemodSession as TSession)
from project_desert_tortoise_tpu_torch.native.wavio import IQRing
from project_desert_tortoise_tpu_torch.utils import checkpoint as TCK

torch.set_num_threads(1)
FS = 32000.0
CHUNK = ARGOS.chunk_size
HALF = 8                               # chunks before the checkpoint


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def clip():
    iq, payloads = synth.make_argos_recording(n_packets=2, fs=FS)
    iq = (iq / (np.abs(iq).max() * 1.2))[:len(iq) // CHUNK * CHUNK]
    iq = iq.astype(np.complex128)
    t = W.time_axis(len(iq), FS, np.float64)
    t_ext = np.concatenate([t, [t[-1] + 1.0 / FS]])
    return iq, t, t_ext, [bytes(p) for p in payloads]


def _parity(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.inverted == y.inverted
        assert bytes(x.data) == bytes(y.data)
        assert abs(x.time - y.time) <= 1.0001 / FS


def _feed(sess, clip, c0, c1):
    iq, t, t_ext, _ = clip
    frames = []
    for c in range(c0, c1):
        lo, hi = c * CHUNK, (c + 1) * CHUNK
        frames += sess.process(iq[lo:hi], t[lo:hi], t_ext[lo + 1:hi + 1])
    return frames


def _stream(sd, iq):
    """Feed `iq` into the streamer's ring from a thread, stop, run."""
    def produce():
        TSM.feed_array(sd.ring, iq, chunk=4096)
        sd.stop()
    th = threading.Thread(target=produce, daemon=True)
    th.start()
    frames = sd.run(poll_s=0.002)
    th.join(timeout=60)
    assert sd.overruns == 0
    return frames


def test_exact_streamer_on_argos_matches_jax(clip):
    iq, *_, payloads = clip
    port = _stream(TSM.StreamingDemodulator(ARGOS, FS, device="cpu"), iq)
    assert port[0].data.dtype == np.uint8
    jax_frames = _stream(JSM.StreamingDemodulator(ARGOS, FS,
                                                  ring=IQRing(1 << 18)), iq)
    _parity(jax_frames, port)
    assert [bytes(f.data) for f in port] == payloads[1:]


def test_x64_checkpoints_resume_across_packages(clip, tmp_path):
    """JAX x64 -> port and port -> JAX x64, each resumed to the packets
    of JAX's session without the stop."""
    n_chunks = len(clip[0]) // CHUNK
    cont = JSession(ARGOS, FS, quirks=False)
    want = _feed(cont, clip, 0, n_chunks)
    tail = cont.framer.flush()
    want += [tail] if tail is not None else []
    assert [bytes(f.data) for f in want] == clip[3][1:]

    a = JSession(ARGOS, FS, quirks=False)
    first = _feed(a, clip, 0, HALF)
    ck = str(tmp_path / "jax.npz")
    JCK.save_session(a, ck)
    assert np.load(ck)["leaf_0"].dtype == np.float64
    b = TCK.load_session(ck, device="cpu")
    assert b.state.x_img.dtype == b.state.pll.phase.dtype == torch.float64
    assert b.total_samples == HALF * CHUNK
    got = first + _feed(b, clip, HALF, n_chunks)
    tail = b.framer.flush()
    _parity(want, got + ([tail] if tail is not None else []))

    c = TSession(ARGOS, FS, quirks=False, device="cpu")
    first = _feed(c, clip, 0, HALF)
    ck = str(tmp_path / "port.npz")
    TCK.save_session(c, ck)
    assert np.load(ck)["leaf_0"].dtype == np.float64
    d = JCK.load_session(ck)
    assert d.state.x_img.dtype == np.float64
    got = first + _feed(d, clip, HALF, n_chunks)
    tail = d.framer.flush()
    _parity(want, got + ([tail] if tail is not None else []))

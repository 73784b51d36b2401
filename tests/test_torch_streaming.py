"""The port's streaming sessions (``models/streaming.py``) and checkpoints
(``utils/checkpoint.py``) against the JAX package's.

JAX's own ring cannot be built on this tree (tests/conftest.py stops
before ``make``), so the JAX streamers are given the port's ``IQRing``
through their ``ring=`` argument; nothing in the JAX package changes.  A
6-frame POES clip, chunks of 10,000 samples, the CPU (the kernels' plain
versions).  Tolerance (docs/DESIGN.md section 4b): against JAX, frame
counts, ``inverted`` and payloads identical, times within one sample
period on at most one frame; inside the port (the streamer against
``DemodSession``, a resumed session against a continuous one) the hex
lines are identical.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu.models import streaming as JSM
from project_desert_tortoise_tpu.models.demodulator import (
    DemodSession as JSession)
from project_desert_tortoise_tpu.utils import checkpoint as JCK
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu.utils.config import POES_TIP
from project_desert_tortoise_tpu_torch.models import streaming as TSM
from project_desert_tortoise_tpu_torch.models.demodulator import (
    DemodSession as TSession)
from project_desert_tortoise_tpu_torch.native.wavio import IQRing
from project_desert_tortoise_tpu_torch.parallel import blocked as TB
from project_desert_tortoise_tpu_torch.utils import checkpoint as TCK

torch.set_num_threads(1)
FS = 50000.0
CHUNK = 10000
PLAN = (16384, 12288, 8192, 8)


def _parity(a, b, fs=FS):
    assert len(a) == len(b) > 0
    shifted = 0
    for x, y in zip(a, b):
        assert x.inverted == y.inverted
        assert np.array_equal(x.data, y.data)
        if x.time != y.time:
            assert abs(x.time - y.time) <= 1.0001 / fs
            shifted += 1
    assert shifted <= 1


def _lines(frames):
    return [f.hex_line() for f in frames]


@pytest.fixture(scope="module")
def clip():
    iq, _ = synth.make_poes_recording(n_frames=6, fs=FS, snr_db=28.0,
                                      rng=np.random.default_rng(5))
    iq = iq[:len(iq) // CHUNK * CHUNK].astype(np.complex64)
    t = W.time_axis(len(iq), FS, np.float32)
    ts = np.float32(1.0) / np.float32(FS)
    t_ext = np.concatenate([t, [np.float32(t[-1] + ts)]])
    return iq, t, t_ext


def _feed(sess, iq, t, t_ext, c0, c1):
    frames = []
    for c in range(c0, c1):
        lo, hi = c * CHUNK, (c + 1) * CHUNK
        frames += sess.process(iq[lo:hi], t[lo:hi], t_ext[lo + 1:hi + 1])
    return frames


@pytest.fixture(scope="module")
def continuous(clip):
    """The port's exact session over the clip, no stop."""
    iq, t, t_ext = clip
    sess = TSession(POES_TIP, FS, chunk_size=CHUNK, quirks=False,
                    device="cpu")
    _feed(sess, iq, t, t_ext, 0, len(iq) // CHUNK)
    sess.framer.flush()
    return sess.framer.frames


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


def test_exact_streamer_matches_jax_and_the_session(clip, continuous):
    iq, _, _ = clip
    port = _stream(TSM.StreamingDemodulator(POES_TIP, FS, chunk_size=CHUNK,
                                            device="cpu"), iq)
    jsd = JSM.StreamingDemodulator(POES_TIP, FS, chunk_size=CHUNK,
                                   ring=IQRing(1 << 18))
    jax = _stream(jsd, iq)
    assert _lines(port) == _lines(continuous)
    assert len(port) >= 3
    _parity(jax, port)


def test_fast_streamer_matches_jax(clip):
    iq, _, _ = clip
    plan = TB.BlockPlan(*PLAN)
    sd = TSM.FastStreamingDemodulator(POES_TIP, FS, plan=plan, device="cpu")
    port = _stream(sd, iq)
    assert "Frames" in sd.status_line()
    from project_desert_tortoise_tpu.parallel.blocked import BlockPlan
    jsd = JSM.FastStreamingDemodulator(POES_TIP, FS, plan=BlockPlan(*PLAN),
                                       ring=IQRing(1 << 20))
    jax = _stream(jsd, iq)
    _parity(jax, port)


def test_feed_array_pushes_everything_and_honours_stop():
    ring = IQRing(1 << 12)
    iq = (np.arange(1000) + 1j * -np.arange(1000)).astype(np.complex64)
    TSM.feed_array(ring, iq, chunk=300)
    re, im = ring.pop(2000)
    assert np.array_equal(re, iq.real) and np.array_equal(im, iq.imag)
    stop = threading.Event()
    stop.set()
    TSM.feed_array(ring, iq, stop=stop)
    assert ring.available == 0
    t0 = time.perf_counter()
    TSM.feed_array(ring, iq[:200], chunk=100, realtime_fs=2000.0)
    assert time.perf_counter() - t0 >= 0.09 and ring.available == 200


def test_follow_raw_file_tails_a_growing_file(tmp_path):
    """A writer appends interleaved float32 IQ (in pieces that split
    frames) while follow_raw_file tails the file into the ring."""
    path = str(tmp_path / "live.raw")
    x = np.random.default_rng(1).standard_normal((30000, 2)).astype("<f4")
    raw = x.tobytes()
    ring, stop = IQRing(1 << 16), threading.Event()
    th = threading.Thread(target=TSM.follow_raw_file,
                          args=(ring, path, stop),
                          kwargs={"poll_s": 0.005, "chunk_frames": 4096})
    th.start()
    time.sleep(0.02)                  # the file does not exist yet
    with open(path, "wb") as f:
        for lo in range(0, len(raw), 20003):
            f.write(raw[lo:lo + 20003])
            f.flush()
            time.sleep(0.01)
    deadline = time.time() + 10
    while ring.available < len(x) and time.time() < deadline:
        time.sleep(0.01)
    stop.set()
    th.join(timeout=10)
    assert not th.is_alive()
    re, im = ring.pop(len(x) + 10)
    assert np.array_equal(re, x[:, 0]) and np.array_equal(im, x[:, 1])


def test_checkpoint_resume_equals_continuous(clip, continuous, tmp_path):
    iq, t, t_ext = clip
    n_chunks = len(iq) // CHUNK
    half = n_chunks // 2
    a = TSession(POES_TIP, FS, chunk_size=CHUNK, quirks=False, device="cpu")
    first = _feed(a, iq, t, t_ext, 0, half)
    ck = str(tmp_path / "session.npz")
    TCK.save_session(a, ck)
    b = TCK.load_session(ck, device="cpu")
    assert b.total_samples == a.total_samples == half * CHUNK
    second = _feed(b, iq, t, t_ext, half, n_chunks)
    tail = b.framer.flush()
    got = first + second + ([tail] if tail is not None else [])
    assert _lines(got) == _lines(continuous)


def test_jax_checkpoint_resumes_in_the_port(clip, tmp_path):
    """A .npz written by the JAX save_session resumes in the port to JAX's
    frames; one written by the port resumes in JAX."""
    iq, t, t_ext = clip
    n_chunks = len(iq) // CHUNK
    half = n_chunks // 2
    cont = JSession(POES_TIP, FS, chunk_size=CHUNK, quirks=False)
    _feed(cont, iq, t, t_ext, 0, n_chunks)
    cont.framer.flush()

    a = JSession(POES_TIP, FS, chunk_size=CHUNK, quirks=False)
    first = _feed(a, iq, t, t_ext, 0, half)
    ck = str(tmp_path / "jax.npz")
    JCK.save_session(a, ck)
    b = TCK.load_session(ck, device="cpu")
    assert b.total_samples == half * CHUNK
    assert b.framer.bit_idx == a.framer.bit_idx
    _feed(b, iq, t, t_ext, half, n_chunks)
    b.framer.flush()
    _parity(cont.framer.frames, first + b.framer.frames[len(first):])

    ck2 = str(tmp_path / "port.npz")
    TCK.save_session(b, ck2)
    c = JCK.load_session(ck2)
    assert c.total_samples == len(iq)
    for x, y in zip(JCK._flatten_state(c.state)[0],
                    JCK._flatten_state(cont.state)[0]):
        assert np.asarray(x).shape == np.asarray(y).shape
    assert os.path.getsize(ck2) > 0

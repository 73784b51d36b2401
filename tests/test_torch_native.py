"""The port's native IO runtime (``native/wavio.cpp`` through
``native/wavio.py``): built with g++ at first use, the SPSC ring, and the
native WAV reader against the port's numpy reader (``utils/wav.py``)."""

import ctypes
import struct
import threading

import numpy as np
import pytest

from project_desert_tortoise_tpu_torch.native import wavio as N
from project_desert_tortoise_tpu_torch.utils import wav as W


def test_a_fresh_build_directory_builds_the_library(tmp_path):
    so = N.build(tmp_path / "build")
    assert so.exists() and so.parent == tmp_path / "build"
    assert so.name == N.library_path(tmp_path / "build").name
    assert N.build(tmp_path / "build") == so         # keyed: no rebuild
    lib = ctypes.CDLL(str(so))
    lib.pdt_ring_create.restype = ctypes.c_void_p
    lib.pdt_ring_capacity.restype = ctypes.c_uint64
    lib.pdt_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.pdt_ring_destroy.argtypes = [ctypes.c_void_p]
    h = lib.pdt_ring_create(ctypes.c_uint64(1000))
    assert lib.pdt_ring_capacity(h) == 1024
    lib.pdt_ring_destroy(h)


def test_ring_round_trip_and_overruns():
    ring = N.IQRing(1000)
    assert ring.capacity == 1024 and ring.available == 0
    rng = np.random.default_rng(0)
    re = rng.standard_normal(1500).astype(np.float32)
    im = rng.standard_normal(1500).astype(np.float32)
    assert ring.push(re[:600], im[:600]) == 600
    a, b = ring.pop(100)
    assert np.array_equal(a, re[:100]) and np.array_equal(b, im[:100])
    # 524 slots free: the rest of the push is dropped and counted
    assert ring.push(re[600:], im[600:]) == 524
    assert ring.overruns == 900 - 524 and ring.available == 1024
    a, b = ring.pop(2000)                    # wraps around the buffer end
    assert np.array_equal(a, re[100:1124]) and np.array_equal(b, im[100:1124])
    assert ring.pop(10)[0].size == 0 and ring.available == 0
    ring.close()
    ring.close()                            # idempotent


def test_ring_across_threads():
    """One producer thread, one consumer: every sample once, in order."""
    ring = N.IQRing(4096)
    x = np.arange(200_000, dtype=np.float32)
    got = []

    def produce():
        lo = 0
        while lo < len(x):
            lo += ring.push(x[lo:lo + 3000], -x[lo:lo + 3000])
    th = threading.Thread(target=produce)
    th.start()
    n = 0
    while n < len(x):
        a, b = ring.pop(1234)
        assert np.array_equal(a, -b)
        got.append(a)
        n += len(a)
    th.join()
    assert np.array_equal(np.concatenate(got), x)


def _wav(path, fs, bits, frames):
    """A 2-channel PCM WAV of `bits` bits from an (n, 2) integer array."""
    body = frames.astype({8: "<u1", 16: "<i2", 32: "<i4"}[bits]).tobytes()
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(body), b"WAVE",
                      b"fmt ", 16, 1, 2, fs, fs * 2 * bits // 8, 2 * bits // 8,
                      bits, b"data", len(body))
    path.write_bytes(hdr + body)


@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_wav_reader_matches_numpy(tmp_path, bits, dtype):
    rng = np.random.default_rng(bits)
    lo, hi = {8: (0, 256), 16: (-32768, 32768), 32: (-2**31, 2**31)}[bits]
    frames = rng.integers(lo, hi, size=(5001, 2), dtype=np.int64)
    path = tmp_path / f"x{bits}.wav"
    _wav(path, 48000, bits, frames)
    re, im, fs, got_bits = N.load_iq_wav_native(str(path), dtype)
    iq, _, fs_np, hdr = W.load_iq_wav(str(path), dtype)
    assert (fs, got_bits) == (fs_np, hdr.bits_per_sample) == (48000.0, bits)
    assert re.dtype == im.dtype == np.dtype(dtype)
    assert np.array_equal(re, iq.real) and np.array_equal(im, iq.imag)


def test_native_wav_reader_refuses_mono(tmp_path):
    path = tmp_path / "mono.wav"
    body = np.zeros(10, "<i2").tobytes()
    path.write_bytes(struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(body), b"WAVE", b"fmt ", 16,
        1, 1, 8000, 16000, 2, 16, b"data", len(body)) + body)
    with pytest.raises(ValueError):
        N.load_iq_wav_native(str(path))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No compiler that works: the build raises (nothing falls back)."""
    monkeypatch.setenv("CXX", "false")          # a command that exits 1
    with pytest.raises(RuntimeError, match="failed"):
        N.build(tmp_path / "build")
    assert not N.library_path(tmp_path / "build").exists()

"""Live audio-device ingest: the soundcard path of the realtime apps.

The port's own copy of ``project_desert_tortoise_tpu/utils/audio.py``,
twin of the reference's PortAudio capture
(``POESTIPdemodPortAudio/main.c:246-282``): default input device, 48 kHz
float32 stereo (I on the left channel, Q on the right), blocking reads of
one chunk, input overflow tolerated with a counter instead of an abort
(``main.c:327-331``).

The capture thread is a *producer* for the same lock-free SPSC ring every
other realtime source feeds (``native/wavio.cpp``), so the soundcard path
shares the DSP and serving code with stdin and file-follow.

Implementation: ctypes bindings to ALSA's ``libasound`` (ALSA is the
Linux-native layer PortAudio itself wraps).  The binding prefers FLOAT_LE
(the reference's ``paFloat32``) and falls back to S16_LE with the same
/32768 normalization the WAV ingest uses (``common/wave.c:117``).  With no
loadable libasound or no capture device, ``AudioCapture`` raises
(``AudioCapture.available()`` says whether the library loads).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
import threading
from typing import Optional

import numpy as np

# snd_pcm_* constants (alsa-lib pcm.h)
_SND_PCM_STREAM_CAPTURE = 1
_SND_PCM_ACCESS_RW_INTERLEAVED = 3
_SND_PCM_FORMAT_S16_LE = 2
_SND_PCM_FORMAT_FLOAT_LE = 14
_EPIPE = 32


def _find_libasound() -> Optional[str]:
    name = ctypes.util.find_library("asound")
    if name:
        return name
    # vendored copies (e.g. pygame wheels ship one)
    import site
    roots = []
    try:
        roots.extend(site.getsitepackages())
    except Exception:
        pass
    for root in roots:
        hits = glob.glob(os.path.join(root, "**", "libasound*.so*"),
                         recursive=True)
        if hits:
            return hits[0]
    return None


_lib_cache = [False, None]


def _load() -> Optional[ctypes.CDLL]:
    if _lib_cache[0]:
        return _lib_cache[1]
    _lib_cache[0] = True
    path = _find_libasound()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.snd_pcm_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int]
        lib.snd_pcm_set_params.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_uint,
                                           ctypes.c_uint, ctypes.c_int,
                                           ctypes.c_uint]
        lib.snd_pcm_readi.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_ulong]
        lib.snd_pcm_readi.restype = ctypes.c_long
        lib.snd_pcm_prepare.argtypes = [ctypes.c_void_p]
        lib.snd_pcm_close.argtypes = [ctypes.c_void_p]
        _lib_cache[1] = lib
    except OSError:
        return None
    return _lib_cache[1]


class AudioCapture:
    """Blocking stereo capture from an ALSA device.

    read(n) returns (re, im) float32 arrays of exactly n frames (left
    channel = I, right = Q, the reference's convention, ``main.c:340-343``).
    Overruns (-EPIPE) are recovered with ``snd_pcm_prepare`` and counted in
    ``.overflows`` — the tolerated-overflow semantics of ``main.c:327-331``.
    """

    def __init__(self, device: str = "default", fs: float = 48000.0,
                 channels: int = 2):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("no loadable libasound on this system")
        self.fs = float(fs)
        self.channels = channels
        self.overflows = 0
        self._pcm = ctypes.c_void_p()
        rc = self.lib.snd_pcm_open(ctypes.byref(self._pcm),
                                   device.encode(), _SND_PCM_STREAM_CAPTURE, 0)
        if rc < 0:
            raise RuntimeError(f"snd_pcm_open({device!r}) failed: {rc}")
        self.fmt = None
        for fmt in (_SND_PCM_FORMAT_FLOAT_LE, _SND_PCM_FORMAT_S16_LE):
            rc = self.lib.snd_pcm_set_params(
                self._pcm, fmt, _SND_PCM_ACCESS_RW_INTERLEAVED, channels,
                int(fs), 1, 500000)
            if rc >= 0:
                self.fmt = fmt
                break
        if self.fmt is None:
            self.close()
            raise RuntimeError("no supported capture format (f32/s16)")

    @staticmethod
    def available() -> bool:
        return _load() is not None

    def read(self, n: int):
        if self.fmt == _SND_PCM_FORMAT_FLOAT_LE:
            buf = np.empty(n * self.channels, np.float32)
        else:
            buf = np.empty(n * self.channels, np.int16)
        got = 0
        itemsize = buf.itemsize * self.channels
        while got < n:
            ptr = buf.ctypes.data + got * itemsize
            rc = self.lib.snd_pcm_readi(self._pcm, ctypes.c_void_p(ptr),
                                        n - got)
            if rc == -_EPIPE:          # overrun: recover and continue
                self.overflows += 1
                self.lib.snd_pcm_prepare(self._pcm)
                continue
            if rc < 0:
                raise RuntimeError(f"snd_pcm_readi failed: {rc}")
            got += rc
        return deinterleave(buf, self.channels)

    def close(self):
        if self._pcm:
            self.lib.snd_pcm_close(self._pcm)
            self._pcm = ctypes.c_void_p()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def deinterleave(buf: np.ndarray, channels: int = 2):
    """Interleaved capture buffer -> (re, im) float32, reference scaling.

    float32 passes through untouched (``paFloat32``); int16 divides by
    32768 exactly like the 16-bit WAV ingest (``common/wave.c:117``).
    Mono duplicates into I with Q=0 (a degenerate but valid source).
    """
    if buf.dtype == np.int16:
        f = buf.astype(np.float32) / 32768.0
    else:
        f = np.asarray(buf, np.float32)
    if channels == 1:
        return f.copy(), np.zeros_like(f)
    n = len(f) // channels
    return (np.ascontiguousarray(f[0::channels][:n]),
            np.ascontiguousarray(f[1::channels][:n]))


def audio_feed(ring, stop: threading.Event, device: str = "default",
               fs: float = 48000.0, chunk: int = 2400,
               capture: Optional[AudioCapture] = None):
    """Producer thread body: soundcard -> SPSC ring until `stop` is set.

    `chunk` defaults to the realtime apps' 2400-sample chunk
    (``POESTIPdemodPortAudio/main.c:30``).  Pass `capture` to inject a
    fake/loopback source in tests."""
    cap = capture or AudioCapture(device, fs)
    try:
        while not stop.is_set():
            re, im = cap.read(chunk)
            ring.push(re, im)
    finally:
        if capture is None:
            cap.close()

"""ctypes bindings for the port's native IO runtime (``wavio.cpp``).

The port's own copy of ``project_desert_tortoise_tpu/native/wavio.py``.
The JAX package loads a ``libpdtwavio.so`` that ``make`` must have built
beforehand and falls back to numpy where it is missing; here the library
is built with ``g++`` at first use into ``_build/`` beside the package,
keyed by a hash of the source and the flags (no ``-march=native``, so the
library does not depend on the host that built it), as
``ops/kernels/build.py`` builds the CUDA kernels.  A failed build raises,
and nothing falls back: ``IQRing`` and ``load_iq_wav_native`` either run
the native code or raise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("wavio.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint16),
        ("bits_per_sample", ctypes.c_uint16),
        ("format_type", ctypes.c_uint16),
        ("data_size", ctypes.c_uint32),
        ("n_frames", ctypes.c_uint64),
    ]


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return Path(build_dir) / f"libpdtwavio_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library into `build_dir` unless it is there; returns
    its path.  Raises if no C++ compiler is found or the build fails."""
    so = library_path(build_dir)
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, c++ or $CXX) to build "
                           f"{SOURCE.name}")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"({r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)            # atomic: concurrent builds race safely
    return so


@functools.cache
def load() -> ctypes.CDLL:
    """The native library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    c_p, u64 = ctypes.c_void_p, ctypes.c_uint64
    sigs = {
        "pdt_parse_wav_header": (ctypes.c_int, [c_p, u64, c_p]),
        "pdt_pcm_to_iq_f32": (ctypes.c_int, [c_p, u64, ctypes.c_int, c_p,
                                             c_p]),
        "pdt_pcm_to_iq_f64": (ctypes.c_int, [c_p, u64, ctypes.c_int, c_p,
                                             c_p]),
        "pdt_raw_to_iq_f32": (ctypes.c_int, [c_p, u64, c_p, c_p]),
        "pdt_ring_create": (c_p, [u64]),
        "pdt_ring_destroy": (None, [c_p]),
        "pdt_ring_push": (u64, [c_p, c_p, c_p, u64]),
        "pdt_ring_pop": (u64, [c_p, c_p, c_p, u64]),
        "pdt_ring_available": (u64, [c_p]),
        "pdt_ring_capacity": (u64, [c_p]),
        "pdt_ring_overruns": (u64, [c_p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def load_iq_wav_native(path: str, dtype=np.float32):
    """Native-path equivalent of ``utils.wav.load_iq_wav``: returns (re,
    im, fs, bits), planar arrays of `dtype`."""
    lib = load()
    data = np.fromfile(path, np.uint8)
    info = _WavInfo()
    rc = lib.pdt_parse_wav_header(_ptr(data), len(data), ctypes.byref(info))
    if rc != 0 or info.channels != 2 or info.format_type != 1:
        raise ValueError("unsupported wav for native reader")
    n = int(info.n_frames)
    dt = np.dtype(dtype)
    if dt not in (np.float32, np.float64):
        raise ValueError(f"dtype must be float32 or float64, not {dt}")
    re = np.empty(n, dt)
    im = np.empty(n, dt)
    fn = lib.pdt_pcm_to_iq_f32 if dt == np.float32 else lib.pdt_pcm_to_iq_f64
    rc = fn(_ptr(data[44:]), n, int(info.bits_per_sample), _ptr(re),
            _ptr(im))
    if rc != 0:
        raise ValueError(f"unsupported bits: {info.bits_per_sample}")
    return re, im, float(info.sample_rate), int(info.bits_per_sample)


class IQRing:
    """Lock-free single-producer single-consumer ring of float32 IQ
    frames (the streaming transport).  Capacity rounds up to a power of
    two; a push that does not fit drops the rest and counts it in
    ``overruns``."""

    def __init__(self, capacity_frames: int):
        self._h = None
        self._lib = load()
        self._h = self._lib.pdt_ring_create(int(capacity_frames))
        if not self._h:
            raise MemoryError("ring allocation failed")

    @property
    def capacity(self) -> int:
        return int(self._lib.pdt_ring_capacity(self._h))

    @property
    def available(self) -> int:
        return int(self._lib.pdt_ring_available(self._h))

    @property
    def overruns(self) -> int:
        return int(self._lib.pdt_ring_overruns(self._h))

    def push(self, re: np.ndarray, im: np.ndarray) -> int:
        re = np.ascontiguousarray(re, np.float32)
        im = np.ascontiguousarray(im, np.float32)
        if len(re) != len(im):
            raise ValueError(f"re has {len(re)} samples, im {len(im)}")
        return int(self._lib.pdt_ring_push(self._h, _ptr(re), _ptr(im),
                                           len(re)))

    def pop(self, n: int):
        re = np.empty(n, np.float32)
        im = np.empty(n, np.float32)
        got = int(self._lib.pdt_ring_pop(self._h, _ptr(re), _ptr(im), n))
        return re[:got], im[:got]

    def close(self):
        if self._h:
            self._lib.pdt_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

"""Build and bind the CUDA kernels of this package.

``nvcc`` compiles each ``csrc/*.cu`` source into an object file, all at
once in parallel, and links them into one shared library with plain C entry
points, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The library is built at first use into ``_build/`` beside the
sources and keyed by a hash of the sources, the shared header and the
flags, so a fresh checkout builds it on its first call and an edited source
rebuilds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
SOURCES = tuple(CSRC / f for f in ("fused_demod.cu", "chain_kernel.cu",
                                   "pll_kernel.cu", "scan_kernels.cu",
                                   "ablate_kernel.cu", "ablate_fused.cu",
                                   "fp64_latency.cu"))
HEADERS = (CSRC / "pdt_common.cuh", CSRC / "front_stages.cuh")
BUILD_DIR = PKG / "_build"
# -fmad=false and no fast math: the kernels match their plain PyTorch
# versions operation for operation (see csrc/pdt_common.cuh)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of each entry point (see the extern "C" functions)
_SIGNATURES = {
    # zre, zim, tn, st_in, be, btime, avg_out, unlocked, B, L, in_int16,
    # squelch, tgen, interp, hist, ring_t, n_tg, params, n_params, stream
    "pdt_fused_demod": [_P] * 8 + [_I] * 9 + [_P, _I, _P],
    # interp, hist, ring_t, n_tg, in_int16, squelch, tgen, out
    "pdt_fused_demod_config": [_I] * 7 + [_P],
    # zre, zim, tn, st_in, be, btime, avg_out, B, L, in_int16, squelch,
    # tgen, interp, hist, ring_t, n_tg, params, n_params, stream
    "pdt_fused_demod_serial": [_P] * 7 + [_I] * 9 + [_P, _I, _P],
    # zre, zim, st_in, y, lock, st_out, unlocked, B, L, interp, hist,
    # squelch_after_pll, params, n_params, stream
    "pdt_pll_fir_agc": [_P] * 7 + [_I] * 5 + [_P, _I, _P],
    # interp, hist, squelch_after_pll, out
    "pdt_pll_fir_agc_config": [_I] * 3 + [_P],
    # zre, zim, st_in, y, lock, st_out, B, L, interp, hist,
    # squelch_after_pll, params, n_params, stream
    "pdt_pll_fir_agc_serial": [_P] * 6 + [_I] * 5 + [_P, _I, _P],
    # zre, zim, st_in, out, lock, st_out, unlocked, B, L, params,
    # n_params, stream
    "pdt_pll_scan": [_P] * 7 + [_I] * 2 + [_P, _I, _P],
    # out
    "pdt_pll_scan_config": [_P],
    # zre, zim, st_in, out, lock, st_out, B, L, params, n_params, stream
    "pdt_pll_scan_serial": [_P] * 6 + [_I] * 2 + [_P, _I, _P],
    # the decoupled kernel in double (no unlocked counts): zre, zim,
    # st_in, out, lock, st_out, B, L, params, n_params, stream
    "pdt_pll_scan_f64": [_P] * 6 + [_I] * 2 + [_P, _I, _P],
    # out
    "pdt_pll_scan_f64_config": [_P],
    # the serial kernel in double
    "pdt_pll_scan_f64_serial": [_P] * 6 + [_I] * 2 + [_P, _I, _P],
    # x, g_in, y, g_out, B, n, params, n_params, stream
    "pdt_agc_scan": [_P] * 4 + [_I] * 2 + [_P, _I, _P],
    # out
    "pdt_agc_scan_config": [_P],
    # x, g_in, y, g_out, B, n, params, n_params, stream
    "pdt_agc_scan_serial": [_P] * 4 + [_I] * 2 + [_P, _I, _P],
    # the same in double
    "pdt_agc_scan_f64": [_P] * 4 + [_I] * 2 + [_P, _I, _P],
    # x, t, n_valid, st_f_in, st_i_in, bits, btimes, emit, st_f_out,
    # st_i_out, filled, B, n_win, window, margin, spw, params, n_params,
    # stream
    "pdt_gardner_manchester": [_P] * 11 + [_I] * 5 + [_P, _I, _P],
    # window, margin, spw, out
    "pdt_gardner_manchester_config": [_I] * 3 + [_P],
    # x, t, n_valid, st_f_in, st_i_in, bits, btimes, emit, st_f_out,
    # st_i_out, B, n_win, window, margin, spw, params, n_params, stream
    "pdt_gardner_manchester_serial": [_P] * 10 + [_I] * 5 + [_P, _I, _P],
    # x, t, n_valid, st_f_in, st_i_in, syms, times, valid, bits, emit,
    # st_f_out, st_i_out, count, B, cap, max_syms, ring_floats, params,
    # n_params, stream
    "pdt_gardner_scan": [_P] * 13 + [_I] * 4 + [_P, _I, _P],
    # B, cap, ring_floats, out
    "pdt_gardner_scan_config": [_I] * 3 + [_P],
    # x, t, n_valid, st_f_in, st_i_in, syms, times, valid, bits, emit,
    # st_f_out, st_i_out, count, B, cap, max_syms, params, n_params, stream
    "pdt_gardner_scan_serial": [_P] * 13 + [_I] * 3 + [_P, _I, _P],
    # the whole-image kernel in double, as pdt_gardner_scan
    "pdt_gardner_scan_f64": [_P] * 13 + [_I] * 4 + [_P, _I, _P],
    # B, cap, ring_floats, out
    "pdt_gardner_scan_f64_config": [_I] * 3 + [_P],
    # the serial kernel in double, as pdt_gardner_scan_serial
    "pdt_gardner_scan_f64_serial": [_P] * 13 + [_I] * 3 + [_P, _I, _P],
    # the exact chain's other clocks, float and double: the whole-image
    # kernel as pdt_gardner_scan (with ring_floats) and its config entry;
    # their serial twins as pdt_gardner_scan_serial: x, t, n_valid,
    # st_f_in, st_i_in, syms, times, valid, bits, emit, st_f_out,
    # st_i_out, count, B, cap, max_syms, params, n_params, stream
    **{f"pdt_{clock}_scan{suffix}": [_P] * 13 + [_I] * 4 + [_P, _I, _P]
       for clock in ("mm", "upsampling_gardner", "upsampling_mm")
       for suffix in ("", "_f64")},
    **{f"pdt_{clock}_scan{suffix}_config": [_I] * 3 + [_P]
       for clock in ("mm", "upsampling_gardner", "upsampling_mm")
       for suffix in ("", "_f64")},
    **{f"pdt_{clock}_scan{suffix}_serial": [_P] * 13 + [_I] * 3
       + [_P, _I, _P]
       for clock in ("mm", "upsampling_gardner", "upsampling_mm")
       for suffix in ("", "_f64")},
    # variant, in, st_in, out, st_out, B, L, params, n_params, stream: the
    # staged kernel and its serial twin
    "pdt_ablate_kernel": [_I] + [_P] * 4 + [_I] * 2 + [_P, _I, _P],
    "pdt_ablate_kernel_serial": [_I] + [_P] * 4 + [_I] * 2 + [_P, _I, _P],
    # variant, out
    "pdt_ablate_kernel_config": [_I, _P],
    # flags, re, im, tn, st_in, bit, btime, emit, st_out, B, L, window,
    # params, n_params, stream: the staged kernel and its serial twin
    "pdt_ablate_fused": [_I] + [_P] * 8 + [_I] * 3 + [_P, _I, _P],
    "pdt_ablate_fused_serial": [_I] + [_P] * 8 + [_I] * 3 + [_P, _I, _P],
    # flags, out
    "pdt_ablate_fused_config": [_I, _P],
    # kind, in, out, cycles, steps, stream
    "pdt_fp64_latency": [_I, _P, _P, _P, _I, _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda)")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"pdt_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile the library if it is not built yet; returns
    (path, compiler output), the output empty when nothing was built.
    One nvcc per source runs in parallel, then one link."""
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    if not failed:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                            *map(str, objs)],
                           capture_output=True, text=True)
        logs.append(r.stdout + r.stderr)
        if r.returncode != 0:
            failed.append(f"link ({r.returncode})")
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    os.replace(tmp, so)          # atomic: concurrent builds race safely
    return so, log


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib

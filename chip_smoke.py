#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one CUDA card).

Builds the kernels from the sources of this checkout (one library, one
nvcc per source in parallel) and holds each against its plain PyTorch
version on the card, bit for bit: at small shapes, then on the blocks the
main paths stage (their first 8,192 samples).  It checks the
block-parallel slice on the CPU against the card on each of its three
branches (``use_pallas`` "fused", "front", False), for POES and for ARGOS,
and drives the port's three entry points:

- a synthetic 12-minute NOAA POES pass (50 kHz, 36 M samples, 7,201
  minor frames) through ``demod_poes --fast`` (the scan branch,
  ``use_pallas=False``, the JAX CLI's), then through
  ``demodulate_blocked`` on the fused branch (in-kernel time generation),
  whose lines must equal those of the fused path on the staged position
  plane, and on the front branch;
- a synthetic 12-minute ARGOS pass (32 kHz, 23.04 M samples, 589
  packets) through ``demod_argos --fast`` and the same two branches;
- the same POES pass through ``demod_poes`` without ``--fast``, the exact
  chunked chain (3,600 chunks, one lane each: ``pll_scan``, ``agc_scan``
  and ``gardner_manchester_scan``), whose payloads must be the JAX exact
  chain's and each one the fast path's (``exact_cli``: the wall split
  into chunk steps, fetches, framer and writer; each kernel's ms a
  chunk), and the telemetry explorer on the fast CLI's frames file
  (``products``: the files JAX's explorer writes, the summary's
  error-free count ``check_parity``'s);
- the same ARGOS pass through ``demod_argos`` without ``--fast``, the
  float64 ``argos`` mode's exact chain (9,601 chunks of 2,400 samples on
  the double instances ``pll_scan_f64`` (decoupled), ``agc_scan_f64`` and
  ``gardner_manchester_scan_f64`` (the image in shared memory)), whose
  payloads must be the JAX float64 exact chain's (``argos_exact_cli``,
  split as ``exact_cli``);
- the POES pass through the flat whole-file path (``flat_path``):
  ``demod_frames_flat`` one-shot on branch False and on the fused branch
  (int16 planes uploaded whole, windows cut on the card), each frames file
  byte for byte ``demodulate_blocked``'s on that branch;
  ``demod_frames_flat_pipelined`` in ``bench.py``'s end-to-end
  configuration (fused, tgen, pack=-1, 4 slices); the planes scaled to 13
  signed bits, packed to 13 bits, their frames those of the same planes
  as int16; every payload once;
- a synthetic 60-s POES recording through ``DemodSession`` with each of
  the exact chain's other clocks (``clocks_exact``: ``"mm"`` with and
  without the quirks, ``"upsampling_gardner"`` and ``"upsampling_mm"``,
  float32 and float64, one lane, on ``mm_manchester_scan``,
  ``upsampling_gardner_manchester_scan`` and
  ``upsampling_mm_manchester_scan`` or their ``_f64`` instances), whose
  payloads must be the JAX exact chain's (``CLOCK_REFERENCE``), the
  upsampling clocks also at 7,000-sample chunks with the same lines;
- the port's upsampling-level study
  (``tools/study_upsampling.py``, ``study``) at the committed study's
  settings (22 dB, 10 frames, levels 1-6 and 8, both clocks and kinds: 28
  ``DemodSession`` runs), each row's recovered frames the JAX tool's
  (``STUDY_REFERENCE``), and for each clock and level whether the float32
  whole-image kernel holds a chunk's upsampled image resident or recycles
  its tiles;
- the multi-device path over the one card: the POES pass through
  ``demodulate_sharded`` on meshes (1, 1) and (1, 4), on branch False and
  on the fused branch, each frame set ``demodulate_blocked``'s
  (``multichip_sharded``); ``demodulate_multihost`` in one spawned NCCL
  rank, its frames ``demodulate_sharded``'s (``multichip_multihost``); and
  ``multichip_dryrun_torch.dryrun_multichip`` over four entries of the
  card (``multichip_dryrun``);
- the two ablation tools (``project_desert_tortoise_tpu_torch/tools``),
  every variant at 128 and at 4,224 lanes (``ablation`` lines); the staged
  ``ablate_kernel`` and ``ablate_fused`` against their serial twins
  ``ablate_kernel_serial`` and ``ablate_fused_serial`` at the tools' full
  sizes, both timed in turns (``ablation_vs_serial``, ``design``;
  ``ablation_chain`` has both times);
- multi-channel serving (``serving``): a ``ChannelBank`` of 256 POES
  channels of 1,228,800 int16 samples (32 synthetic recordings, each on 8
  channels), pushed by producer threads and pumped in 128-lane batches,
  on the fused and on the scan branch: every payload once on every
  channel (extra frames only from the lead-in's acquisition), the scan
  branch's lines ``demodulate_many``'s, the fused
  branch's ``demodulate_blocked``'s, float32 staging's int16's; wall,
  Msamples/s, per-batch dispatch-to-collect ms and each kernel's ms a
  batch (CUDA events); then ``demod_serve`` on 16 of those channels as
  WAVs, its files the API run's lines;
- ``demod_realtime`` on 30 s of ``poes_tip_realtime`` fed on stdin (the
  exact chain: an offline ``DemodSession``'s lines; ``--fast``:
  ``demodulate_many``'s), and ``--fast --source follow:PATH`` on a RAW
  file written while it runs, stopped by SIGINT; a checkpoint of the
  exact session halfway, resumed to the lines of the run without the
  stop (``realtime``, ``checkpoint``).

The exact chain's kernels are held to their plain versions at one lane
(``pll_scan`` and ``agc_scan`` from an unlocked start,
``gardner_manchester_scan`` over a quirks image with stale mid-bit
pointers), ``gardner_manchester_scan`` also at 352 lanes on the
unwindowed layout of the POES blocks, each time against its serial twin
``gardner_manchester_scan_serial`` too (timed in the same run; a
``design`` line each), and ``DemodSession`` on a short clip on the card
against the CPU and, on the clip's first 12,500 samples, against its
plain versions on the card (``exact_small``).  The float64 kernels are
held to their plain versions at one lane from an unlocked start (and the
PLL from a locked one), over a 2,400-sample chunk, the pass's final one
of 1,680 and a short one of 1,234, on quirks images with stale mid-bit
pointers and on the chunk-invariant image, ``pll_scan_f64`` and
``gardner_manchester_scan_f64`` also against their serial twins
``pll_scan_f64_serial`` and ``gardner_manchester_scan_f64_serial``
(``argos_exact_kernels``: ``kernel_vs_plain`` and
``whole_chunk_vs_serial`` lines and a ``design`` line with the chain
bounds at the FP64 latency that ``fp64_latency`` measures first).  The
three clock kernels are held to their plain versions at one lane over one
POES chunk's image, in float32 and float64, from a fresh and a carried
state, over the whole image and a ragged final chunk (``clock_kernels``:
their ms, bytes and chain bounds); each (all three run the whole-image
kernel) also against its serial twin (``*_serial``, ``*_f64_serial``) and
on a forced small ring (``whole_chunk_vs_serial`` and ``design`` lines,
the chain bounds at the float add and ``ld.shared`` latencies that
``fp64_latency`` measures).

It holds the decoupled ``fused_demod``, ``pll_fir_agc``, ``pll_scan`` and
``agc_scan`` and the windowed ``gardner_manchester`` to their serial twins
(``fused_demod_serial``, ``pll_fir_agc_serial``, ``pll_scan_serial``,
``agc_scan_serial``, ``gardner_manchester_serial``, on no path) on every
entry of each pass's blocks, times old and new in the same run
(``whole_pass_vs_serial`` lines) and prints their launch configuration
(``design`` lines).  It times the steps of each pass one by one
(``stages`` lines) and each kernel on the blocks of its pass.  Each phase prints one JSON line, with
``t`` the seconds since the start; any failure raises and the script exits
non-zero.  The last lines are the kernel table, the card's name and power
limit as nvidia-smi reports them, and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()
POES_FS, ARGOS_FS = 50000.0, 32000.0
SMALL_PLAN = (8192, 12288, 8192, 8)      # core, head, tail, max_frames
ARGOS_SMALL_PLAN = (8192, 8192, 8192, 8)  # tests/test_blocked_argos.py's
PASS_FRAMES = 7200                       # 12 minutes of 0.1 s minor frames
ARGOS_PACKETS = 589                      # 12 minutes of 1.2225 s packets
# the packets of that ARGOS pass which the JAX package's fast path
# (demodulate_blocked, use_pallas=False, default plan) does not decode:
# after each 0.9 s noise gap the squelch after the AGC (|lock| below its
# threshold) can zero a packet's preamble and sync word before the lock
# signal has risen.  tests/test_torch_argos_pass.py recomputes the list
# with the JAX package on the CPU.
ARGOS_REFERENCE_MISSED = (
    0, 11, 12, 13, 24, 47, 55, 86, 102, 105, 109, 115, 170, 175, 178, 203,
    208, 214, 215, 219, 222, 229, 273, 290, 306, 343, 381, 397, 403, 404,
    447, 453, 459, 464, 470, 482, 500, 534, 555, 556, 558, 575, 587)
# what else that fast path decodes on the pass (packets whose tail the
# squelch zeroed), in hex; the test recomputes it too
ARGOS_REFERENCE_EXTRA = ("250e9fffffffff", "77b73fffffffff")
# what the JAX package's exact chain (DemodSession, POES_TIP, quirks on)
# misses on the POES pass, and what else it decodes (in hex; the
# acquisition lead-in frame apart): nothing either way.  The exact_cli
# phase holds the port's exact chain to both;
# tests/test_torch_exact_pass.py recomputes them on the CPU.
EXACT_REFERENCE_MISSED = ()
EXACT_REFERENCE_EXTRA = ()
# what the JAX package's float64 exact chain (DemodSession, ARGOS under
# x64, quirks on, 2,400-sample chunks) misses on the ARGOS pass, and what
# else it decodes (in hex).  The argos_exact_cli phase holds the port's
# float64 exact chain to both; tests/test_torch_argos_exact_pass.py
# recomputes them on the CPU.
ARGOS_EXACT_REFERENCE_MISSED = (
    0, 10, 11, 12, 20, 24, 37, 86, 105, 109, 115, 170, 174, 175, 178, 201,
    208, 214, 215, 216, 222, 229, 290, 306, 320, 343, 352, 381, 403, 404,
    439, 444, 453, 470, 474, 500, 536, 558, 575, 587)
ARGOS_EXACT_REFERENCE_EXTRA = ("250e9fffffffff", "7da33fffffffff")
# the exact chain's other clocks (clocks_exact): a synthetic 60-s POES
# recording (CLOCK_FRAMES frames after the acquisition lead-in) through
# DemodSession with each hand-built clock configuration (clock_cfg), in
# these (clock, quirks) runs, float32 and float64, at the mode's chunk;
# the upsampling clocks also at CLOCK_SECOND_CHUNK, whose lines must be
# the same
CLOCK_FRAMES = 600
CLOCK_RUNS = (("mm", True), ("mm", False), ("upsampling_gardner", False),
              ("upsampling_mm", False))
CLOCK_SECOND_CHUNK = 7000
# what the JAX package's exact chain (DemodSession with the same
# configuration, float64 under x64) misses of those payloads, what else it
# decodes (in hex; the lead-in apart) and what it decodes twice, by
# (clock, quirks, dtype): each run misses the first two frames after the
# lead-in (its clock still acquiring) and nothing else, decodes nothing
# else and nothing twice.  tests/test_torch_clock_pass.py recomputes them
# on the CPU
CLOCK_REFERENCE = {(clock, quirks, dtype): ((0, 1), (), ())
                   for clock, quirks in CLOCK_RUNS
                   for dtype in ("float32", "float64")}
# the upsampling-level study (study): the port's tools/study_upsampling.py
# at the settings of the committed docs/studies/upsampling_levels.json (22
# dB, 10 frames, these levels: 28 rows), each row's frames_ok that of the
# JAX package's tool at the same arguments on the CPU: 7 at every level
# from 2, but 6 for the M&M clock's cubic kernel at level 2, and 0 at
# level 1.  The committed file, from an earlier JAX tree, has 7 at that
# level 2 and 1 for the M&M clock at level 1, both kinds.
# tests/test_torch_study_upsampling.py recomputes the rows (marked slow)
STUDY_SNR_DB, STUDY_FRAMES = 22.0, 10
STUDY_LEVELS = (1, 2, 3, 4, 5, 6, 8)
STUDY_REFERENCE = {
    (alg, kind, lv): 0 if lv == 1 else 6 if (alg, kind, lv) == (
        "upsampling_mm", "cubic", 2) else 7
    for alg in ("upsampling_gardner", "upsampling_mm")
    for kind in ("cubic", "linear") for lv in STUDY_LEVELS}
# the study's float32 clock kernels held against their plain versions at
# the study's own images (study_clock_checks): level 5 resident in shared
# memory, 6 and 8 on the recycled tiles of the default ring, both kinds
STUDY_CHECK_LEVELS = (5, 6, 8)
STUDY_RECYCLED_FROM = 6
# the multi-process path (multihost): one NCCL rank on a short recording
# of this many frames, on a mesh of two entries of the card
MULTIHOST_FRAMES = 40
# the mesh-shape dry run (dryrun): entries, all on the one card
DRYRUN_DEVICES = 4
# the exact chain's B=1 checks of pll_scan and agc_scan from an unlocked
# start: poes_tip's and poes_tip_realtime's chunks and a short final one
EXACT_CHECK_L = (10000, 2400, 1234)
# samples per lane of the plain-version checks on the main paths' blocks,
# the serving batch and the window=0 layout: 2 of the unfused branches'
# 4,096-sample Gardner windows (the plain versions are per-sample loops of
# ~0.1-3.5 ms a step on the card, host-bound; 16,384 until the float64
# exact chain's phases joined the run, which then passed the 1,200 s limit
# on a slower host)
MAIN_CHECK_L = 8192
# the same for the two kernels without Gardner windows, fused_demod and
# pll_fir_agc, on the main blocks: 16 of their 256-sample chunks (8,192
# until the exact chain's other clocks and the flat path joined the run,
# which then took 799 s of the 1,200 s limit)
FRONT_CHECK_L = 4096
# floats of the forced small ring on which gardner_manchester_scan is
# also checked (four tiles of 512: recycled, the stale pointer read from
# device memory)
SMALL_RING = 2048
SMALL_RING_F64 = 256            # doubles: four tiles of 64, the chunk 2,400
# the ablation tools: lane counts (S x 128) of the timed runs, at each of
# which every variant is checked against its plain version over
# (steps, window); ablate_kernel also on seeded varied inputs at these lane
# counts and at ABLATION_PART_LANES (a part-full last CTA)
ABLATION_S = (1, 33)
ABLATION_PART_LANES = (100, 4200)
ABLATION_CHECK = (512, 256)
CSRC = "project_desert_tortoise_tpu_torch/csrc/"
JAX = "project_desert_tortoise_tpu/"
# name: (source, the TPU kernel or XLA scan it replaces)
KERNELS = {
    "fused_demod": (CSRC + "fused_demod.cu",
                    JAX + "ops/pallas/fused_kernel.py:291"),
    "pll_fir_agc": (CSRC + "chain_kernel.cu",
                    JAX + "ops/pallas/chain_kernel.py:100"),
    # the serial designs of the two, kept as the whole-pass oracle and the
    # timing baseline; no path launches them
    "fused_demod_serial": (CSRC + "fused_demod.cu",
                           JAX + "ops/pallas/fused_kernel.py:291"),
    "pll_fir_agc_serial": (CSRC + "chain_kernel.cu",
                           JAX + "ops/pallas/chain_kernel.py:100"),
    "pll_scan": (CSRC + "pll_kernel.cu", JAX + "ops/pallas/pll_kernel.py:60"),
    "agc_scan": (CSRC + "scan_kernels.cu", JAX + "ops/agc.py:65"),
    # the serial designs of the scan branch's two, kept in the same way
    "pll_scan_serial": (CSRC + "pll_kernel.cu",
                        JAX + "ops/pallas/pll_kernel.py:60"),
    "agc_scan_serial": (CSRC + "scan_kernels.cu", JAX + "ops/agc.py:65"),
    "gardner_manchester": (CSRC + "scan_kernels.cu", JAX + "ops/clock.py:151"),
    # its serial design, kept in the same way
    "gardner_manchester_serial": (CSRC + "scan_kernels.cu",
                                  JAX + "ops/clock.py:151"),
    # the exact chain's Gardner scan followed by its Manchester scan
    "gardner_manchester_scan": (CSRC + "scan_kernels.cu",
                                JAX + "ops/clock.py:58, " + JAX
                                + "ops/manchester.py:34"),
    # its serial design, kept in the same way
    "gardner_manchester_scan_serial": (CSRC + "scan_kernels.cu",
                                       JAX + "ops/clock.py:58, " + JAX
                                       + "ops/manchester.py:34"),
    # the float64 argos exact chain's three (JAX runs the same functions
    # there under x64): the decoupled PLL, the serial AGC and the
    # whole-image Gardner scan instantiated in double
    "pll_scan_f64": (CSRC + "pll_kernel.cu",
                     JAX + "ops/pallas/pll_kernel.py:60"),
    "agc_scan_f64": (CSRC + "scan_kernels.cu", JAX + "ops/agc.py:65"),
    "gardner_manchester_scan_f64": (CSRC + "scan_kernels.cu",
                                    JAX + "ops/clock.py:58, " + JAX
                                    + "ops/manchester.py:34"),
    # the serial designs of the PLL and the Gardner scan in double, kept in
    # the same way
    "pll_scan_f64_serial": (CSRC + "pll_kernel.cu",
                            JAX + "ops/pallas/pll_kernel.py:60"),
    "gardner_manchester_scan_f64_serial": (CSRC + "scan_kernels.cu",
                                           JAX + "ops/clock.py:58, " + JAX
                                           + "ops/manchester.py:34"),
    # the exact chain's other clocks, each followed by its Manchester scan,
    # and their double instances (JAX runs them under x64 there); their
    # serial twins, kept in the same way
    **{name + suffix: (CSRC + "scan_kernels.cu",
                       JAX + f"ops/clock.py:{line}, " + JAX
                       + "ops/manchester.py:34")
       for name, line in (("mm_manchester_scan", 111),
                          ("upsampling_gardner_manchester_scan", 272),
                          ("upsampling_mm_manchester_scan", 344))
       for suffix in ("", "_f64", "_serial", "_f64_serial")},
    "ablate_kernel": (CSRC + "ablate_kernel.cu", "tools/ablate_kernel.py:32"),
    # its serial design, kept as the oracle and the timing baseline
    "ablate_kernel_serial": (CSRC + "ablate_kernel.cu",
                             "tools/ablate_kernel.py:32"),
    "ablate_fused": (CSRC + "ablate_fused.cu", "tools/ablate_fused.py:42"),
    # its serial design, kept as the oracle and the timing baseline
    "ablate_fused_serial": (CSRC + "ablate_fused.cu",
                            "tools/ablate_fused.py:42"),
}
# the three clock kernels' wrappers in scan_kernels, float32 and float64,
# and their serial twins
CLOCK_KERNELS = tuple(f"{clock}_manchester_scan{suffix}"
                      for clock in ("mm", "upsampling_gardner",
                                    "upsampling_mm")
                      for suffix in ("", "_f64"))
WHOLE_IMAGE_CLOCKS = ("mm", "upsampling_gardner", "upsampling_mm")
CLOCK_TWINS = tuple(f"{clock}_manchester_scan{suffix}_serial"
                    for clock in WHOLE_IMAGE_CLOCKS
                    for suffix in ("", "_f64"))
# the kernels each main path launches: the branches of demod_blocks and
# the two ablation tools
PATH_KERNELS = {"fused": ("fused_demod",),
                "front": ("pll_fir_agc", "gardner_manchester"),
                False: ("pll_scan", "agc_scan", "gardner_manchester"),
                "exact": ("pll_scan", "agc_scan", "gardner_manchester_scan"),
                "argos_exact": ("pll_scan_f64", "agc_scan_f64",
                                "gardner_manchester_scan_f64"),
                "ablate_kernel": ("ablate_kernel",),
                "ablate_fused": ("ablate_fused",),
                # the flat whole-file path (demod_frames_flat and the
                # pipelined slices) on the fused branch and on branch False
                "flat_fused": ("fused_demod",),
                "flat_scan": ("pll_scan", "agc_scan", "gardner_manchester"),
                # the exact chain under each other clock, in float32 and in
                # float64
                **{f"exact_{clock}": ("pll_scan", "agc_scan",
                                      f"{clock}_manchester_scan")
                   for clock in ("mm", "upsampling_gardner",
                                 "upsampling_mm")},
                **{f"exact_{clock}_f64": ("pll_scan_f64", "agc_scan_f64",
                                          f"{clock}_manchester_scan_f64")
                   for clock in ("mm", "upsampling_gardner",
                                 "upsampling_mm")},
                # the upsampling-level study: the exact chain under both
                # upsampling clocks, float32
                "study": ("pll_scan", "agc_scan",
                          "upsampling_gardner_manchester_scan",
                          "upsampling_mm_manchester_scan"),
                # the mesh-shape dry run: the scan branch (its blocks of
                # 30,720 samples take no 4,096-sample windows: the whole
                # block in one Gardner scan), then the fused
                "dryrun": ("pll_scan", "agc_scan", "gardner_manchester_scan",
                           "fused_demod")}
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, fp32 and
# fp64 (outside the tensor cores) flop/s
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
FP64_FLOP_S = 34e12


def emit(phase: str, **kv):
    print(json.dumps({"phase": phase, "t": round(time.time() - T0, 1),
                      **kv}), flush=True)


def modes():
    """name: (mode config, sample rate) of the two passes."""
    from project_desert_tortoise_tpu_torch.utils.config import ARGOS, POES_TIP
    return {"poes": (POES_TIP, POES_FS), "argos": (ARGOS, ARGOS_FS)}


def kernel_fns() -> dict:
    """Each kernel's wrapper (whose ``.launches`` counts its launches)."""
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels
    from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
        pll_fir_agc, pll_fir_agc_serial)
    from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
        fused_demod, fused_demod_serial)
    from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
        pll_scan_f64, pll_scan_f64_serial, pll_scan_kernel, pll_scan_serial)
    from project_desert_tortoise_tpu_torch.tools import (
        ablate_fused, ablate_kernel)
    return {"fused_demod": fused_demod, "pll_fir_agc": pll_fir_agc,
            "fused_demod_serial": fused_demod_serial,
            "pll_fir_agc_serial": pll_fir_agc_serial,
            "pll_scan": pll_scan_kernel, "agc_scan": scan_kernels.agc_scan,
            "pll_scan_serial": pll_scan_serial,
            "agc_scan_serial": scan_kernels.agc_scan_serial,
            "gardner_manchester": scan_kernels.gardner_manchester,
            "gardner_manchester_serial":
                scan_kernels.gardner_manchester_serial,
            "gardner_manchester_scan": scan_kernels.gardner_manchester_scan,
            "gardner_manchester_scan_serial":
                scan_kernels.gardner_manchester_scan_serial,
            "pll_scan_f64": pll_scan_f64,
            "agc_scan_f64": scan_kernels.agc_scan_f64,
            "gardner_manchester_scan_f64":
                scan_kernels.gardner_manchester_scan_f64,
            "pll_scan_f64_serial": pll_scan_f64_serial,
            "gardner_manchester_scan_f64_serial":
                scan_kernels.gardner_manchester_scan_f64_serial,
            **{name: getattr(scan_kernels, name)
               for name in CLOCK_KERNELS + CLOCK_TWINS},
            "ablate_kernel": ablate_kernel.ablate_kernel,
            "ablate_kernel_serial": ablate_kernel.ablate_kernel_serial,
            "ablate_fused": ablate_fused.ablate_fused,
            "ablate_fused_serial": ablate_fused.ablate_fused_serial}


def drive(path, fn):
    """Run one main path: every kernel count set to 0 just before fn(),
    read just after; fails unless each kernel of the path launched and no
    other did (the serial kernels among them, gardner_manchester_serial,
    gardner_manchester_scan_serial, the float64 twins pll_scan_f64_serial
    and gardner_manchester_scan_f64_serial, the clocks' CLOCK_TWINS and the
    ablation tools' ablate_kernel_serial and ablate_fused_serial too).
    Returns (fn's result, {kernel: launches})."""
    import torch
    fns = kernel_fns()
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in fns.items()}
    missing = [k for k in PATH_KERNELS[path] if counts[k] <= 0]
    if missing:
        raise AssertionError(f"path {path!r} did not launch {missing}")
    stray = [k for k, n in counts.items() if n and k not in PATH_KERNELS[path]]
    if stray:
        raise AssertionError(f"path {path!r} launched {stray}")
    return out, counts


def bound(n_bytes: float, flops: float, peak: float = FP32_FLOP_S) -> dict:
    """Least time the card could take: the larger of bytes over the HBM
    rate and operations over their type's peak (fp32 unless `peak` says
    otherwise)."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# dependent operations a sample on the front stages' loop-carried chains,
# counted from csrc/pdt_common.cuh (all kernels of the chain compute the
# same recurrences): the AGC gain, 10 an output (multiply, add, compare,
# select, multiply, add, two compare-selects); the locked PLL phase, 12
# (add, compare, two selects of the wrap, multiply, three adds, two
# compare-selects of the second wrap); the EMAs 2.  Gardner's next-sample
# chain, from the same sources: gardner_manchester_serial's
# (csrc/scan_kernels.cu) a symbol slot, active or not, 17 (rintf,
# float->int, subtract, two clamps, add, the gather's index, address and
# load, subtract, two multiplies, two clamps, subtract, add, select), the
# count kept for gardner_manchester too, over the slots its chain computes
# (up to each window's first inactive one) and for gardner_manchester_scan
# (up to the first inactive slot), whose load is a shared-memory one;
# fused_demod's stage E
# (csrc/fused_demod.cu, GardnerLane::run) a due symbol, 16 (the age:
# subtract, two clamps; the read's index and load; subtract, two
# multiplies, two clamps, subtract, add; rintf, float->int, clamp; the
# next due test).  The Manchester state is off that chain.  Each at
# CHAIN_CYCLES, the latency of a dependent FP32 add, multiply, compare or
# select (a load counted as one operation: its cache latency is more).
# The chain bound is computed from these counts, not measured: it goes on
# the design and stages lines, not on the kernels line.
CHAIN_CYCLES = 4
AGC_CHAIN_OPS, PLL_CHAIN_OPS = 10, 12
GM_SLOT_CHAIN_OPS, E_SYMBOL_CHAIN_OPS = 17, 16
# The float64 kernels compute the same operations in double.  Their
# chains: the AGC gain, 10 an output; Gardner's next-sample chain, 17 a
# slot; pll_scan_f64 (the decoupled kernel in double) stage A's locked
# phase update, 12 a sample, as in float32 (the lock signal is stage M's,
# sin/cos and q_rsqrt stage B's); its serial twin's step, whose `locked`
# flag feeds back through the lock signal and so puts the data arm's
# sin/cos and q_rsqrt on the chain: those 12 and the lock signal's 6 (two
# multiplies, two adds, the threshold's compare and the gain select),
# sin/cos and q_rsqrt not counted.  Each at the latency of a dependent
# FP64 operation that phase_fp64_latency measures on the card
# (chain_cycles_f64(): the least of a double add's, multiply's and
# compare-select's, so a lower bound).
PLL_F64_SERIAL_CHAIN_OPS = PLL_CHAIN_OPS + 6
# cycles a step of each dependent operation's chain, as measured by
# phase_fp64_latency (csrc/fp64_latency.cu's kinds, in order): the double
# add, multiply, FMA, compare-select, sin, cos and sin/cos pair, the float
# add, a shared-memory load whose address is the previous load's value,
# and a float add and floor (FRND.FLOOR: the upsampling clocks' split
# pointers renormalise through two a slot)
LATENCY_KINDS = ("add", "mul", "fma", "select", "sin", "cos", "sincos",
                 "f32_add", "ld_shared", "f32_add_floor")
LATENCY_CYCLES = {}


def chain_cycles_f64() -> float:
    """The latency the float64 chain bounds count for each dependent
    operation: the least of the measured add, multiply and compare-select
    latencies (phase_fp64_latency must have run)."""
    return min(LATENCY_CYCLES[k] for k in ("add", "mul", "select"))


def max_sm_clock_hz() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, check=True)
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def chain_bound_ms(steps: int, ops_per_step: float,
                   cycles: float = CHAIN_CYCLES) -> float:
    """Least time of `steps` steps of a loop-carried chain of
    `ops_per_step` dependent operations of `cycles` cycles each, at the
    card's maximum SM clock."""
    return steps * ops_per_step * cycles / max_sm_clock_hz() * 1e3


def front_chain_ops(interp: int) -> int:
    """The PLL-FIR-AGC chain's longest recurrence a sample: the AGC over
    interp outputs, or the PLL phase (stage E apart)."""
    return max(AGC_CHAIN_OPS * interp, PLL_CHAIN_OPS)


def max_abs_err(a, b) -> float:
    """Largest absolute difference over matching outputs (nested tuples of
    tensors)."""
    if isinstance(a, (tuple, list)):
        return max((max_abs_err(x, y) for x, y in zip(a, b)), default=0.0)
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_equal(a, b, what: str):
    """Bit-exact agreement of two results (nested tuples of tensors)."""
    import torch
    if isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            check_equal(x, y, what)
    elif not torch.equal(a, b):
        raise AssertionError(f"{what}: kernel and plain version differ "
                             f"(max abs {max_abs_err(a, b)})")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


# device clock cycles a timed run waits behind (~10 ms at 1.98 GHz): its
# launches are queued before the first one starts, so host time between
# them (argument checks, allocation) is not counted in short kernels' ms
QUEUE_CYCLES = 20_000_000


def cuda_ms(fn, reps: int = 1):
    """Mean device milliseconds of fn() over reps runs (CUDA events, the
    runs queued behind a device sleep), and the last result."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def compare(kern, ref, fs: float) -> dict:
    """Per-lane agreement of two (bits, bit_times, emit, avg_phase)
    results: emitted bit sequences, bit times, and the largest absolute
    difference over all outputs."""
    k = [x.cpu().numpy() for x in kern]
    r = [x.cpu().numpy() for x in ref]
    B = k[0].shape[0]
    bits_same = times_same = times_within = 0
    for b in range(B):
        kb, rb = k[0][b][k[2][b]], r[0][b][r[2][b]]
        kt, rt = k[1][b][k[2][b]], r[1][b][r[2][b]]
        same_len = len(kb) == len(rb)
        bits_same += same_len and np.array_equal(kb, rb)
        if same_len and np.array_equal(kt, rt):
            times_same += 1
        elif same_len and np.abs(kt - rt).max() <= 1.0001 / fs:
            times_within += 1
    max_err = max(float(np.abs(k[0] - r[0]).max()),
                  float(np.abs(k[1] - r[1]).max()),
                  float(np.abs(k[2].astype(np.float32)
                               - r[2].astype(np.float32)).max()),
                  float(np.abs(k[3] - r[3]).max()))
    return dict(lanes=B, bits_same=bits_same, times_same=times_same,
                times_within_1_sample=times_within, max_abs_err=max_err)


def check_parity(c: dict, what: str):
    """Tolerance (docs/DESIGN.md section 4b envelope): emitted bits
    identical on every lane; bit times identical on >= 99% of lanes and
    within one sample period on the rest.  -fmad=false makes exact
    agreement the expectation; the share is reported."""
    lanes = c["lanes"]
    if c["bits_same"] != lanes:
        raise AssertionError(f"{what}: emitted bits differ on "
                             f"{lanes - c['bits_same']} of {lanes} lanes")
    if c["times_same"] < 0.99 * lanes:
        raise AssertionError(f"{what}: bit times identical on only "
                             f"{c['times_same']} of {lanes} lanes")
    if c["times_same"] + c["times_within_1_sample"] != lanes:
        raise AssertionError(f"{what}: bit times off by more than one "
                             "sample period")


def test_input(B: int, L: int, seed: int = 0):
    """The fused-kernel test input of tests/test_pallas_fused.py: a
    3-samples-per-symbol BPSK stream with noise, float32."""
    rng = np.random.default_rng(seed)
    sym = rng.choice([-1.0, 1.0], size=(B, L // 3 + 9))
    base = np.repeat(sym, 3, axis=1)[:, :L]
    re = (base * 0.01 + 0.002 * rng.standard_normal((B, L))).astype(np.float32)
    im = (0.002 * rng.standard_normal((B, L))).astype(np.float32)
    tn = np.tile(np.arange(1, L + 1, dtype=np.float32) / POES_FS, (B, 1))
    return re, im, tn


def argos_input(B: int, L: int, seed: int = 0):
    """The ARGOS test input of tests/test_pallas_fused.py:101-108:
    40-sample BPSK symbols with noise, float32."""
    rng = np.random.default_rng(seed)
    sym = rng.choice([-1.0, 1.0], size=(B, L // 40 + 2))
    base = np.repeat(sym, 40, axis=1)[:, :L]
    re = (base * 0.01 + 0.001 * rng.standard_normal((B, L))).astype(np.float32)
    im = (0.001 * rng.standard_normal((B, L))).astype(np.float32)
    return re, im


def to_int16(a):
    return np.clip(np.round(a * 32768.0), -32768, 32767).astype(np.int16)


def tgen_inputs(B: int, fs: float, pad: int, dev):
    """Time generation's inputs for a small check: lane b seeded at
    0.25 b + ts, lane 0 with a zero-padded head of `pad` samples."""
    import torch
    ts = float(np.float32(1.0) / np.float32(fs))
    seed = torch.arange(B, dtype=torch.float32, device=dev) * 0.25 + ts
    pad0 = torch.zeros(B, device=dev)
    pad0[0] = float(pad)
    return seed, pad0, ts


def phase_toolchain():
    import torch
    from project_desert_tortoise_tpu_torch.ops.kernels import build
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    emit("toolchain", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc.stdout.strip().splitlines()[-1],
         card=card_line(), device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())


def phase_build():
    from project_desert_tortoise_tpu_torch.ops.kernels import build
    t0 = time.time()
    so, log = build.build()
    build.load()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit("build", library=os.path.relpath(so, REPO),
         sources=[s.name for s in build.SOURCES],
         seconds=round(time.time() - t0, 3), ptxas=ptxas,
         smem_per_cta=decoupled_smem())


def decoupled_smem() -> dict:
    """Dynamic shared memory bytes a CTA of the decoupled kernels'
    main-path instantiations (ptxas reports static shared memory only)."""
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops.kernels import chain_kernel
    from project_desert_tortoise_tpu_torch.ops.kernels import fused_kernel
    out = {}
    for mode_name, (mode, fs) in modes().items():
        params = chain.make_params(mode, fs)
        for kern in (fused_kernel, chain_kernel):
            name = kern.__name__.rsplit(".", 1)[1]
            out[f"{name} {mode_name}"] = kern.launch_config(params)[
                "smem_bytes"]
    return out


def phase_kernel():
    """Kernel vs plain version on the card at B=256, L=4096, f32 and int16
    input; the latch guard."""
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops import pll
    from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
        fused_demod, fused_demod_ref)
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

    dev = torch.device("cuda")
    params = chain.make_params(POES_TIP, POES_FS)
    B, L = 256, 4096
    re, im, tn = test_input(B, L)
    st = pll.init_state(params.pll, (B,), device=dev)
    gain = torch.full((B,), 17.58, device=dev)
    t_next = torch.from_numpy(tn).to(dev)
    for name, (a, b) in (("f32", (re, im)),
                         ("int16", (to_int16(re), to_int16(im)))):
        z = (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
        plain_ms, ref = cuda_ms(
            lambda: fused_demod_ref(params, st, gain, z, t_next))
        fused_demod(params, st, gain, z, t_next)          # warm-up
        ms, kern = cuda_ms(lambda: fused_demod(params, st, gain, z, t_next),
                           reps=5)
        c = compare(kern, ref, POES_FS)
        check_parity(c, f"kernel vs plain ({name})")
        emit("kernel_vs_plain", input=name, B=B, L=L, ms=ms,
             plain_ms=plain_ms, card=card_line(), **c)

    # the capture-latch guard refuses geometries the latch cannot serve
    bad = params._replace(step_size=4.0, baud=POES_FS * 3 / 4.0)
    z = torch.zeros((B, 512), device=dev)
    try:
        fused_demod(bad, st, gain, (z, z), z)
    except ValueError as e:
        if "capture-latch" not in str(e):
            raise
        emit("latch_guard", raised="ValueError")
    else:
        raise AssertionError("latch guard did not raise")


def time_pair(name: str, case: str, kern, plain, shape, stats: dict):
    """One kernel against its plain version on the same inputs: bit-exact
    or raise; CUDA-event ms of both (the kernel's after a warm-up, over 5
    runs).  Keeps the worst error and the slowest plain time per kernel
    in stats; returns (ms, plain_ms, max_abs_err)."""
    plain_ms, want = cuda_ms(plain)
    kern()
    ms, got = cuda_ms(kern, reps=5)
    check_equal(got, want, f"{name} ({case})")
    err = max_abs_err(got, want)
    emit("kernel_vs_plain", kernel=name, case=case, shape=shape, ms=ms,
         plain_ms=plain_ms, max_abs_err=err, bit_exact=True, card=card_line())
    st = stats.setdefault(name, dict(max_abs_err=0.0, plain_ms=0.0))
    st["max_abs_err"] = max(st["max_abs_err"], err)
    if plain_ms > st["plain_ms"]:
        st.update(plain_ms=plain_ms, plain_shape=shape)
    return ms, plain_ms, err


def phase_tgen_small(stats: dict):
    """The fused kernel with in-kernel time generation against its plain
    version at B=256, L=2048: POES f32 and int16, ARGOS f32, lane 0 with a
    zero-padded head of 700 samples.  stats: per mode."""
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops import pll
    from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
        fused_demod, fused_demod_ref)

    dev = torch.device("cuda")
    B, L, pad = 256, 2048, 700
    poes_re, poes_im, _ = test_input(B, L, seed=1)
    argos_re, argos_im = argos_input(B, L, seed=2)
    cases = (("poes", "f32", poes_re, poes_im),
             ("poes", "int16", to_int16(poes_re), to_int16(poes_im)),
             ("argos", "f32", argos_re, argos_im))
    for mode_name, dtype, re, im in cases:
        mode, fs = modes()[mode_name]
        params = chain.make_params(mode, fs)
        re, im = re.copy(), im.copy()
        re[0, :pad] = 0
        im[0, :pad] = 0
        z = (torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev))
        st = pll.init_state(params.pll, (B,), device=dev)
        gain = torch.full((B,), 17.58, device=dev)
        seed, pad0, ts = tgen_inputs(B, fs, pad, dev)
        time_pair("fused_demod", f"{mode_name} {dtype}, time generation",
                  lambda: fused_demod(params, st, gain, z, None, seed, pad0,
                                      ts),
                  lambda: fused_demod_ref(params, st, gain, z, None, seed,
                                          pad0, ts), [B, L], stats[mode_name])


def phase_new_kernels(stats: dict):
    """The kernels of the front and scan branches against their plain
    versions on the card at B=256, L=4096 on a synthetic input, covering
    cases the main path does not reach: pll_fir_agc from a cold state with
    no squelch and after the PLL, pll_scan cold and warm, agc_scan on the
    interpolated PLL output, gardner_manchester on the front kernel's
    output in two windows.  phase_new_kernels_at_main_shape checks them on
    the main path's own blocks."""
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops import fir, pll
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
        pll_fir_agc, pll_fir_agc_ref)
    from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
        pll_scan_kernel)
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

    dev = torch.device("cuda")
    params = chain.make_params(POES_TIP, POES_FS)
    B, L = 256, 4096
    re, im, tn = test_input(B, L)
    z = (torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev))
    cold = pll.init_state(params.pll, (B,), device=dev)
    gain = torch.full((B,), 17.58, device=dev)
    for sq in (None, "after_pll"):
        cp = params._replace(squelch_threshold=0.05 if sq else None,
                             squelch_position=sq)
        time_pair("pll_fir_agc", f"squelch={sq}",
                  lambda: pll_fir_agc(cp, cold, gain, z),
                  lambda: pll_fir_agc_ref(cp, cold, gain, z), [B, L], stats)
    warm = cold._replace(freq=torch.full((B,), 0.1, device=dev),
                         locked=torch.ones((B,), dtype=torch.bool, device=dev))
    for case, st in (("cold", cold), ("warm", warm)):
        time_pair("pll_scan", case,
                  lambda: pll_scan_kernel(params.pll, st, z),
                  lambda: pll.pll_scan_ref(params.pll, st, *z), [B, L], stats)

    _, soft, _ = pll_scan_kernel(params.pll, warm, z)
    x = fir.fir_interp(soft, params.taps, params.interp)
    ap = sk.AGCParams(params.agc_attack, params.agc_decay)
    time_pair("agc_scan", "interpolated PLL output",
              lambda: sk.agc_scan(gain, x, ap),
              lambda: sk.agc_scan_ref(gain, x, ap), list(x.shape), stats)

    _, _, y, _ = pll_fir_agc(params, warm, gain, z)
    t = fir.fir_out_times(torch.from_numpy(tn).to(dev), params.interp)
    gp = sk.GardnerParams(params.step_size, params.gardner_err_limit,
                          params.gardner_gain, params.resync_threshold)
    lay = sk.layout(y.shape[1], y.shape[1] // 2, params.step_size,
                    params.gardner_err_limit)
    zf = torch.zeros((B,), device=dev)
    zi = torch.zeros((B,), dtype=torch.int32, device=dev)
    n = torch.full((B,), y.shape[1], dtype=torch.int32, device=dev)
    args = ((zf,) * 6, (zi, zi), y, t, n, gp, lay)
    time_pair("gardner_manchester", "front kernel output, 2 windows",
              lambda: sk.gardner_manchester(*args),
              lambda: sk.gardner_manchester_ref(*args), list(y.shape), stats)


def phase_argos_kernels(stats: dict):
    """The ARGOS geometry (interp 1, 50-tap FIR; the fused kernel's
    (1, 50, 4, 4)) against the plain versions at B=256, L=2048: fused_demod
    on a staged time plane with the mode's squelch after the AGC, f32 and
    int16 input, and pll_fir_agc (whose caller applies that squelch)."""
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops import pll
    from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
        pll_fir_agc, pll_fir_agc_ref)
    from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
        fused_demod, fused_demod_ref, geometry)
    from project_desert_tortoise_tpu_torch.utils.config import ARGOS

    dev = torch.device("cuda")
    params = chain.make_params(ARGOS, ARGOS_FS)
    g = geometry(params)
    if ((g.interp, g.hist, g.ring_t, g.n_tg) != (1, 50, 4, 4)
            or params.squelch_position != "after_agc"):
        raise AssertionError(f"ARGOS geometry {g[0]}, {g[2:]}, squelch "
                             f"{params.squelch_position}")
    B, L = 256, 2048
    re, im = argos_input(B, L)
    st = pll.init_state(params.pll, (B,), device=dev)
    gain = torch.full((B,), 50.0, device=dev)
    tn = torch.arange(L, dtype=torch.float32, device=dev).expand(B, L)
    tn = tn.contiguous()
    for name, (a, b) in (("f32", (re, im)),
                         ("int16", (to_int16(re), to_int16(im)))):
        z = (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
        time_pair("fused_demod", f"argos {name}, staged times, squelch "
                  "after the AGC",
                  lambda: fused_demod(params, st, gain, z, tn),
                  lambda: fused_demod_ref(params, st, gain, z, tn), [B, L],
                  stats)
    z = (torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev))
    time_pair("pll_fir_agc", "argos", lambda: pll_fir_agc(params, st, gain, z),
              lambda: pll_fir_agc_ref(params, st, gain, z), [B, L], stats)


def frame_parity(a, b, fs: float) -> dict:
    """Frame-level parity: counts, payloads, timestamp shifts."""
    if len(a) != len(b):
        raise AssertionError(f"frame counts differ: {len(a)} vs {len(b)}")
    if not a:
        raise AssertionError("no frames decoded")
    payload_diff = sum(not np.array_equal(x.data, y.data) or
                       x.inverted != y.inverted for x, y in zip(a, b))
    shifted = sum(x.time != y.time for x, y in zip(a, b))
    far = sum(abs(x.time - y.time) > 1.0001 / fs for x, y in zip(a, b))
    if payload_diff or far or shifted > 0.02 * len(a):
        raise AssertionError(f"frame parity: {payload_diff} payloads differ, "
                             f"{shifted} timestamps shifted ({far} by more "
                             "than one sample)")
    return dict(frames=len(a), payloads_differ=payload_diff,
                time_shifted=shifted)


SLICE_BRANCHES = ("fused", "front", False)


def slice_run(mode_name: str, br, device: str):
    """demodulate_blocked on the slice's recording (POES 40 frames, ARGOS
    6 packets, small plans) on branch br.  Returns (frames, seconds)."""
    from project_desert_tortoise_tpu_torch.parallel.blocked import (
        BlockPlan, demodulate_blocked)
    from project_desert_tortoise_tpu_torch.utils import synth, wav as W

    mode, fs = modes()[mode_name]
    if mode_name == "poes":
        iq, _ = synth.make_poes_recording(n_frames=40, fs=fs)
        plan = BlockPlan(*SMALL_PLAN)
    else:
        iq, _ = synth.make_argos_recording(n_packets=6, fs=fs)
        plan = BlockPlan(*ARGOS_SMALL_PLAN)
    t = W.time_axis(len(iq), fs, mode.np_dtype())
    t0 = time.time()
    frames = demodulate_blocked(iq, t, fs, mode, plan=plan, use_pallas=br,
                                device=device)
    return frames, time.time() - t0


def cpu_slice() -> dict:
    """The slice on the CPU (the plain versions) on every branch of both
    modes, run in the CPU worker (cpu_worker): {(mode, branch): (frames,
    seconds)}."""
    import torch
    torch.set_num_threads(2)
    return {(m, br): slice_run(m, br, "cpu") for m in ("poes", "argos")
            for br in SLICE_BRANCHES}


def phase_slice(mode_name: str, cpu: dict):
    """The slice on the CPU (plain versions, `cpu` from cpu_slice) against
    the card (kernels), on each branch: POES 40 frames, ARGOS 6 packets,
    small plans."""
    mode, fs = modes()[mode_name]
    for br in SLICE_BRANCHES:
        cpu_frames, cpu_s = cpu[(mode_name, br)]
        gpu, card_s = slice_run(mode_name, br, "cuda")
        emit("slice_cpu_vs_card", mode=mode_name, use_pallas=br,
             cpu_s=cpu_s, card_s=card_s,
             **frame_parity(cpu_frames, gpu, fs))


def synth_pass(mode_name: str, workdir: str):
    """The 12-minute pass as a WAV.  Returns (path, the payloads to
    recover, the acquisition lead-in's payload or None)."""
    from project_desert_tortoise_tpu_torch.utils import synth, wav as W

    t0 = time.time()
    _, fs = modes()[mode_name]
    if mode_name == "poes":
        # frame 0 is the acquisition lead-in (the receiver locks during it,
        # as on a real pass entered mid-stream); frames 1..7200 are checked
        iq, frames = synth.make_poes_recording(n_frames=PASS_FRAMES + 1,
                                               fs=fs)
        want, lead_in = frames[1:], bytes(frames[0])
    else:
        iq, want = synth.make_argos_recording(n_packets=ARGOS_PACKETS, fs=fs)
        lead_in = None
    wav = os.path.join(workdir, f"{mode_name}_pass.wav")
    W.write_iq_wav(wav, iq / (np.abs(iq).max() * 1.2), int(fs))
    emit("synth", mode=mode_name, samples=len(iq), payloads=len(want),
         seconds=time.time() - t0)
    return wav, [bytes(w) for w in want], lead_in


def payload_diff(got, want, lead_in):
    """The indices of the synthesized payloads `want` missing from the
    decoded payloads `got` and of those decoded more than once, and what
    else was decoded (in hex, sorted; the acquisition lead-in apart)."""
    counts = collections.Counter(got)
    wanted = set(want)
    missed = [i for i, w in enumerate(want) if counts[w] == 0]
    repeated = [i for i, w in enumerate(want) if counts[w] > 1]
    extra = sorted(g.hex() for g in got if g not in wanted and g != lead_in)
    return missed, extra, repeated


def payload_check(mode_name: str, got, want, lead_in,
                  exact: bool = False) -> dict:
    """How many of the synthesized payloads came out exactly once, which
    were missed or repeated, and what else was decoded (the acquisition
    lead-in apart).  Raises if any repeats, or unless the missed and the
    extra payloads are exactly the reference's: POES's fast path none,
    ARGOS ARGOS_REFERENCE_MISSED and ARGOS_REFERENCE_EXTRA, the exact
    chain (`exact`) EXACT_REFERENCE_MISSED and EXACT_REFERENCE_EXTRA, or
    for ARGOS ARGOS_EXACT_REFERENCE_MISSED and _EXTRA."""
    counts = collections.Counter(got)
    missed, extra, repeated = payload_diff(got, want, lead_in)
    once = len(want) - len(missed) - len(repeated)
    ref, ref_extra = {
        ("poes", False): ((), ()),
        ("argos", False): (ARGOS_REFERENCE_MISSED, ARGOS_REFERENCE_EXTRA),
        ("poes", True): (EXACT_REFERENCE_MISSED, EXACT_REFERENCE_EXTRA),
        ("argos", True): (ARGOS_EXACT_REFERENCE_MISSED,
                          ARGOS_EXACT_REFERENCE_EXTRA)}[mode_name, exact]
    ref_extra = list(ref_extra)
    differ = sorted(set(missed) ^ set(ref))
    out = dict(frames_written=len(got), recovered_once=once, of=len(want),
               missed=missed, repeated=repeated, extra=len(extra),
               extra_payloads=extra[:10], reference_missed=len(ref),
               missed_unlike_reference=differ,
               extra_as_reference=extra == ref_extra)
    if lead_in is not None:
        out["lead_in_recovered"] = counts[lead_in]
    if repeated or differ or extra != ref_extra:
        raise AssertionError(f"payloads: {once} of {len(want)} once, "
                             f"missed {missed[:20]}, repeated "
                             f"{repeated[:20]}, unlike the reference "
                             f"{differ[:20]}, extra {extra[:10]} (the "
                             f"reference's {ref_extra})")
    return out


def phase_cli_path(mode_name: str, workdir: str, wav: str, want, lead_in):
    """The pass through the port's CLI on the card, ``demod_poes --fast``
    or ``demod_argos --fast`` (the scan branch, use_pallas=False, as the
    JAX CLI runs it).  Returns the output file, the wall seconds, the
    kernels' launches and the (timestamp, payload) lines written."""
    import torch
    from project_desert_tortoise_tpu_torch.apps import demod_argos, demod_poes
    from project_desert_tortoise_tpu_torch.utils.output import (
        parse_frames_file)

    out = os.path.join(workdir, f"{mode_name}_cli.txt")
    argv = [wav, "--fast", "--out", out]

    def cli():
        if mode_name == "poes":
            return demod_poes.run(argv)
        try:
            demod_argos.main(argv)
        except SystemExit as done:
            return done.code
        raise AssertionError("demod_argos.main returned without an exit code")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rc, counts = drive(False, cli)
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"the {mode_name} CLI exited {rc}")
    lines = [(f"{t:.5f}", bytes(b)) for t, _, b in parse_frames_file(out)]
    emit("main_path", mode=mode_name, use_pallas=False, entry="cli",
         launches=counts, wall_s=wall,
         peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
         card=card_line(),
         **payload_check(mode_name, [b for _, b in lines], want, lead_in))
    return out, wall, counts, lines


def phase_branch_path(mode_name: str, workdir: str, wav: str, br, want,
                      lead_in, cli_lines):
    """The pass through ``demodulate_blocked(use_pallas=br)`` on the card
    with the default plan, from the WAV: the payloads, the branch's
    kernels launched, wall seconds, peak device memory (and above what was
    held before, per lane-sample of the blocks), and how many frames match
    the CLI's (the scan branch's) in payload and timestamp.  Returns the
    launches, the wall seconds and the frames written as the CLI writes
    them."""
    import torch
    from project_desert_tortoise_tpu_torch.parallel.blocked import (
        default_plan, demodulate_blocked)
    from project_desert_tortoise_tpu_torch.utils import wav as W
    from project_desert_tortoise_tpu_torch.utils.output import FrameWriter

    mode, _ = modes()[mode_name]
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    lane_samples = []
    t0 = time.time()

    def run():
        iq, t, fs, _ = W.load_iq_wav(wav, mode.np_dtype())
        plan = default_plan(mode, fs)
        lane_samples.append(-(-len(iq) // plan.core) * plan.total)
        return demodulate_blocked(iq, t, fs, mode, use_pallas=br,
                                  device="cuda")
    got, counts = drive(br, run)
    wall = time.time() - t0
    cli = set(cli_lines)
    same = sum((f"{f.time:.5f}", bytes(f.data)) in cli for f in got)
    peak = torch.cuda.max_memory_allocated()
    # what the branch allocated at its peak, per (lane, sample) of the
    # plan's blocks: what parallel/blocked.py's _LANE_SAMPLE_BYTES budgets
    emit("main_path", mode=mode_name, use_pallas=br, launches=counts,
         wall_s=wall, peak_device_gib=peak / 2**30,
         peak_bytes_a_lane_sample=(peak - held) / lane_samples[0],
         frames_as_cli=same, cli_frames=len(cli_lines),
         card=card_line(),
         **payload_check(mode_name, [bytes(f.data) for f in got], want,
                         lead_in))
    path = os.path.join(workdir, f"{mode_name}_{br}.txt")
    with FrameWriter(path, inverted_mark=mode.framer.inverted_mark) as w:
        w.write_all(got)
    return counts, wall, path


def timed(stages: dict, name: str, fn):
    """fn(), then a device synchronise; its host seconds go to stages."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    stages[name] = time.perf_counter() - t0
    return out


def phase_stages(mode_name: str, wav: str, workdir: str, cli_wall: float,
                 reps: int = 2):
    """Where the CLI path's time goes: the steps of ``--fast``
    (parallel/blocked.py::demodulate_blocked on its default branch,
    use_pallas=False, and the frame writer) once more, one by one, on the
    host clock with a device synchronise after each.  Returns the last
    run's staged blocks and state for the kernel phases, and the extended
    time axis."""
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops import agc
    from project_desert_tortoise_tpu_torch.parallel import blocked
    from project_desert_tortoise_tpu_torch.utils import wav as W
    from project_desert_tortoise_tpu_torch.utils.output import FrameWriter

    mode, _ = modes()[mode_name]
    dev = torch.device("cuda")
    dt = np.dtype(np.float32)
    for rep in range(reps):
        st = {}
        iq, t, fs, _ = timed(st, "load_wav",
                             lambda: W.load_iq_wav(wav, mode.np_dtype()))
        params = chain.make_params(mode, fs)
        plan = blocked.default_plan(mode, fs)
        n = len(iq)

        def planes():
            norm = agc.static_gain(iq[:mode.chunk_size],
                                   mode.static_gain_level, dt)
            t_ext = np.concatenate([np.asarray(t, dt),
                                    [dt.type(t[-1] + dt.type(1.0)
                                             / dt.type(fs))]])
            return (float(norm), np.ascontiguousarray(iq.real, dt),
                    np.ascontiguousarray(iq.imag, dt), t_ext)
        norm, re, im, t_ext = timed(st, "planes", planes)
        del iq, t
        brs, bis, lo = timed(st, "stage_blocks", lambda: blocked.stage_blocks(
            re, im, plan, 0, -(-n // plan.core), dt))
        del re, im
        zre, zim, lo = timed(st, "h2d", lambda: [
            torch.from_numpy(a).to(dev) for a in (brs, bis, lo)])
        del brs, bis
        fest = timed(st, "carrier_est", lambda: blocked.coarse_carrier_est(
            zre, zim, fs, mode.gardner.baud / 2.0))
        stitched = timed(st, "demod_frames", lambda: blocked.demod_frames(
            params, plan, mode.framer, fs, zre, zim, lo, n, fest, norm,
            use_pallas=False))
        frames = timed(st, "fetch",
                       lambda: blocked._fetch_frames(stitched, t_ext))

        def write():
            with FrameWriter(os.path.join(workdir, "stages.txt"),
                             inverted_mark=mode.framer.inverted_mark) as w:
                w.write_all(frames)
        timed(st, "write", write)
        emit("stages", mode=mode_name, use_pallas=False, rep=rep,
             frames=len(frames), B=int(zre.shape[0]), L=int(zre.shape[1]),
             total_s=sum(st.values()), cli_wall_s=cli_wall, card=card_line(),
             **{k + "_s": v for k, v in st.items()})
    return (params, plan, fs, n, norm, zre, zim, lo, fest), t_ext


def phase_plane_lines(mode_name: str, staged, t_ext, fused_out: str,
                      workdir: str):
    """The fused path on the staged position plane (what the fused branch
    ran before time generation) on the same blocks: its frames, written as
    the CLI writes them, must equal the fused branch's file (time
    generation) line for line."""
    import torch
    from project_desert_tortoise_tpu_torch.ops import framer
    from project_desert_tortoise_tpu_torch.parallel import blocked
    from project_desert_tortoise_tpu_torch.utils.output import FrameWriter

    mode, _ = modes()[mode_name]
    params, plan, fs, n, norm, zre, zim, lo, fest = staged
    pos = blocked.sample_positions(lo, n, plan.total,
                                   1 if params.interp > 1 else 0)
    bits_c, pos_c, n_bits, _ = blocked.demod_blocks(
        params, plan.total, zre, zim, fs, pos, fest, norm,
        use_pallas="fused")
    fb = framer.frame_extract(bits_c, pos_c, n_bits, mode.framer,
                              plan.max_frames)
    fb = fb._replace(times=fb.times.to(torch.float64) + lo[:, None])
    cs = lo + plan.head
    bounds = torch.stack([cs, torch.clamp(cs + plan.core, max=n)], 1)
    frames = blocked._fetch_frames(
        framer.stitch_frames(fb, bounds, zre.shape[0] * plan.max_frames),
        t_ext)
    path = os.path.join(workdir, f"{mode_name}_plane.txt")
    with FrameWriter(path, inverted_mark=mode.framer.inverted_mark) as w:
        w.write_all(frames)
    with open(fused_out) as f:
        gen = f.read().splitlines()
    with open(path) as f:
        plane = f.read().splitlines()
    differ = sum(a != b for a, b in zip(gen, plane))
    if len(gen) != len(plane) or differ:
        raise AssertionError(f"time generation wrote {len(gen)} lines, the "
                             f"staged plane {len(plane)}; {differ} differ")
    emit("tgen_vs_plane_lines", mode=mode_name, fused_lines=len(gen),
         plane_lines=len(plane), identical=True)


def plane_agreement(gen, plane, pos, n_tg: int) -> dict:
    """The fused kernel's results with time generation and with the staged
    position plane on the same blocks: bits, emissions and avg_phase must
    be equal, and bit times wherever the plane holds positions for every
    input sample the time ring reaches (the plane holds -1 where a window
    lies outside the recording, the generator 0 in a padded head and
    further positions past the end)."""
    import torch
    for k, what in ((0, "bits"), (2, "emit"), (3, "avg_phase")):
        if not torch.equal(gen[k], plane[k]):
            raise AssertionError(f"time generation changed {what}")
    valid = pos >= 0
    for k in range(1, n_tg):
        valid[:, k:] &= pos[:, :-k] >= 0
    if not torch.equal(gen[1][valid], plane[1][valid]):
        raise AssertionError("generated bit times differ from the plane's")
    return dict(samples_compared=int(valid.sum()),
                emitted_compared=int((valid & gen[2]).sum()),
                samples_outside=int((~valid).sum()))


def phase_fused_at_main_shape(mode_name: str, staged, fused_wall: float,
                              stats: dict) -> None:
    """The fused kernel on the blocks the pass stages: timed (CUDA events)
    with time generation (the path's mode) and with the staged position
    plane on the whole blocks, the two held to each other; then the
    path's mode held bit for bit to the plain version on the blocks' first
    FRONT_CHECK_L samples (block 0's padded head among them), and for POES
    the staged plane on the same samples."""
    from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
        fused_demod, fused_demod_ref, geometry)
    from project_desert_tortoise_tpu_torch.parallel import blocked

    params, plan, fs, n, norm, zre, zim, lo, fest = staged
    shift = 1 if params.interp > 1 else 0
    pos = blocked.sample_positions(lo, n, plan.total, shift)
    seed, pad0 = blocked.position_seeds(lo, shift)
    st, gain = blocked.warm_state(params, fest, fs, norm)
    B, L = zre.shape

    def gen(z, ref=False):
        f = fused_demod_ref if ref else fused_demod
        return f(params, st, gain, z, None, seed, pad0, 1.0)

    def plane(z, p, ref=False):
        f = fused_demod_ref if ref else fused_demod
        return f(params, st, gain, z, p)
    z = (zre, zim)
    gen(z)
    ms_gen, k_gen = cuda_ms(lambda: gen(z), reps=3)
    plane(z, pos)
    ms_plane, k_plane = cuda_ms(lambda: plane(z, pos), reps=3)
    agree = plane_agreement(k_gen, k_plane, pos, geometry(params).n_tg)
    emit("main_path_kernel", mode=mode_name, kernel="fused_demod", B=B, L=L,
         time_generation_ms=ms_gen, staged_plane_ms=ms_plane,
         kernel_share_of_fused_wall=ms_gen / 1e3 / fused_wall,
         card=card_line(),
         **agree)

    if float(pad0.max()) <= 0:
        raise AssertionError("no padded block among the main blocks")
    zc = tuple(x[:, :FRONT_CHECK_L].contiguous() for x in z)
    time_pair("fused_demod", f"{mode_name} main blocks, time generation",
              lambda: gen(zc), lambda: gen(zc, ref=True),
              [B, FRONT_CHECK_L], stats)
    if mode_name == "poes":
        pc = pos[:, :FRONT_CHECK_L].contiguous()
        time_pair("fused_demod", "poes main blocks, staged plane",
                  lambda: plane(zc, pc), lambda: plane(zc, pc, ref=True),
                  [B, FRONT_CHECK_L], stats)
    # float32 re, im in and the merged bit plane and bit time out (no time
    # plane with time generation); operations counted from the source
    # (sinf/cosf one each): PLL ~40 a sample, FIR 2 a tap, AGC 8 an
    # output, Gardner and Manchester ~20
    ops = 40.0 + 2 * len(params.taps) + 8 * params.interp + 20
    stats["fused_demod"].update(ms=ms_gen, shape=[B, L],
                                staged_plane_ms=ms_plane,
                                **bound(B * L * 16.0, B * L * ops))


def old_new_ms(new, old, reps: int = 2):
    """CUDA-event ms of two kernels on the same inputs in one run, in
    turns old, new, new, old (each a mean over reps launches); returns
    (new ms, old ms, new's result, old's result)."""
    old_a, want = cuda_ms(old)
    new_a, got = cuda_ms(new, reps)
    new_b, _ = cuda_ms(new, reps)
    old_b, _ = cuda_ms(old)
    return (new_a + new_b) / 2, (old_a + old_b) / 2, got, want


def phase_decoupled_at_main_shape(mode_name: str, staged, stats: dict):
    """The decoupled fused_demod and pll_fir_agc against their serial twins
    (fused_demod_serial, pll_fir_agc_serial) on every entry of the pass's
    main blocks, bit for bit: fused_demod on time generation and on the
    staged position plane, pll_fir_agc with the mode's squelch and (POES)
    with one after the PLL.  Times both at this shape in this run; one
    `design` line: the launch configuration the card reports, the times,
    the share of lane-steps that ran the unlocked PLL step and the front
    stages' chain bound (computed from counted operations, not
    measured)."""
    import torch
    from project_desert_tortoise_tpu_torch.ops.kernels import chain_kernel
    from project_desert_tortoise_tpu_torch.ops.kernels import fused_kernel
    from project_desert_tortoise_tpu_torch.parallel import blocked

    params, plan, fs, n, norm, zre, zim, lo, fest = staged
    B, L = zre.shape
    z = (zre, zim)
    pst, gain = blocked.warm_state(params, fest, fs, norm)
    pos = blocked.sample_positions(lo, n, plan.total,
                                   1 if params.interp > 1 else 0)
    seed, pad0 = blocked.position_seeds(lo, 1 if params.interp > 1 else 0)
    unlocked = torch.zeros((B,), dtype=torch.int32, device=zre.device)
    FD, FS_ = fused_kernel.fused_demod, fused_kernel.fused_demod_serial
    PF, PS = chain_kernel.pll_fir_agc, chain_kernel.pll_fir_agc_serial
    times, share = {}, {}
    for src, targs in (("time generation", (None, seed, pad0, 1.0)),
                       ("staged plane", (pos,))):
        ms, ms_old, got, want = old_new_ms(
            lambda: FD(params, pst, gain, z, *targs),
            lambda: FS_(params, pst, gain, z, *targs))
        check_equal(got, want, f"fused_demod vs serial ({src})")
        times["fused_demod", src] = (ms, ms_old)
        # the most symbols a lane: two a bit (Manchester emits every other)
        symbols = 2 * int(got[2].sum(1).max())
    FD(params, pst, gain, z, None, seed, pad0, 1.0, unlocked=unlocked)
    share["fused_demod"] = float(unlocked.sum()) / (B * L)
    sq_cases = [params]
    if mode_name == "poes":
        sq_cases.append(params._replace(squelch_threshold=0.05,
                                        squelch_position="after_pll"))
    for cp in sq_cases:
        case = f"squelch {cp.squelch_position}"
        ms, ms_old, got, want = old_new_ms(lambda: PF(cp, pst, gain, z),
                                           lambda: PS(cp, pst, gain, z))
        check_equal(got, want, f"pll_fir_agc vs serial ({case})")
        times["pll_fir_agc", case] = (ms, ms_old)
    PF(params, pst, gain, z, unlocked=unlocked)
    share["pll_fir_agc"] = float(unlocked.sum()) / (B * L)
    for (name, case), (ms, ms_old) in times.items():
        emit("whole_pass_vs_serial", mode=mode_name, kernel=name, case=case,
             B=B, L=L, bit_exact=True, ms=ms, serial_ms=ms_old,
             speedup=ms_old / ms, card=card_line())
    configs = {"fused_demod": fused_kernel.launch_config(params),
               "pll_fir_agc": chain_kernel.launch_config(params)}
    main = {"fused_demod": "time generation",
            "pll_fir_agc": f"squelch {params.squelch_position}"}
    # fused_demod's E (Gardner, Manchester) apart: its own chain, a symbol
    chain = chain_bound_ms(L, front_chain_ops(params.interp))
    emit("design", mode=mode_name, B=B, L=L, card=card_line(),
         **{k: dict(configs[k], ms=times[k, main[k]][0],
                    serial_ms=times[k, main[k]][1],
                    unlocked_step_share=share[k],
                    front_chain_bound_ms=chain) for k in configs},
         e_chain_bound_ms=chain_bound_ms(symbols, E_SYMBOL_CHAIN_OPS),
         e_symbols_a_lane=symbols)
    # the serial twins' rows of the kernels line: their time here, bound and
    # plain version those of the decoupled kernel (the same function); the
    # decoupled kernel equals them on every entry above
    for k in configs:
        ms, ms_old = times[k, main[k]]
        stats[k + "_serial"] = dict(ms=ms_old, shape=[B, L],
                                    decoupled_ms=ms, max_abs_err=0.0)
        stats[k]["serial_ms"] = ms_old


def phase_scan_at_main_shape(mode_name: str, staged, stats: dict):
    """The decoupled pll_scan and agc_scan against their serial twins
    (pll_scan_serial, agc_scan_serial) on every entry of the pass's main
    blocks, bit for bit, with the inputs demod_blocks gives them on the
    scan branch: warm state, the mode's squelch after the PLL (if any),
    the fir_interp output for the AGC.  Times both in this run; one
    `design` line: the launch configuration the card reports, the times,
    the share of lane-steps that ran the unlocked PLL step and each
    chain's bound (computed from counted operations, not measured)."""
    import torch
    from project_desert_tortoise_tpu_torch.ops import agc, fir
    from project_desert_tortoise_tpu_torch.ops.kernels import pll_kernel
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels
    from project_desert_tortoise_tpu_torch.parallel import blocked

    params, plan, fs, n, norm, zre, zim, lo, fest = staged
    B, L = zre.shape
    z = (zre, zim)
    pst, gain0 = blocked.warm_state(params, fest, fs, norm)
    PS, PSS = pll_kernel.pll_scan_kernel, pll_kernel.pll_scan_serial
    AS, ASS = scan_kernels.agc_scan, scan_kernels.agc_scan_serial
    ms, ms_old, got, want = old_new_ms(lambda: PS(params.pll, pst, z),
                                       lambda: PSS(params.pll, pst, z))
    check_equal(got, want, "pll_scan vs serial")
    times = {"pll_scan": (ms, ms_old, [B, L])}
    unlocked = torch.zeros((B,), dtype=torch.int32, device=zre.device)
    PS(params.pll, pst, z, unlocked=unlocked)
    share = float(unlocked.sum()) / (B * L)
    _, soft, lock = got
    if params.squelch_position == "after_pll":
        soft = agc.squelch(soft, torch.abs(lock), params.squelch_threshold)
    x = fir.fir_interp(soft, params.taps, params.interp)
    del got, want, soft, lock
    ap = scan_kernels.AGCParams(params.agc_attack, params.agc_decay)
    ms, ms_old, got, want = old_new_ms(lambda: AS(gain0, x, ap),
                                       lambda: ASS(gain0, x, ap))
    check_equal(got, want, "agc_scan vs serial")
    times["agc_scan"] = (ms, ms_old, list(x.shape))
    case = f"scan branch, squelch {params.squelch_position}"
    for k, (ms, ms_old, shape) in times.items():
        emit("whole_pass_vs_serial", mode=mode_name, kernel=k, case=case,
             B=shape[0], L=shape[1], bit_exact=True, ms=ms,
             serial_ms=ms_old, speedup=ms_old / ms, card=card_line())
        # the serial twin's row of the kernels line, as for the others
        stats[k + "_serial"] = dict(ms=ms_old, shape=shape, decoupled_ms=ms,
                                    max_abs_err=0.0)
        stats[k]["serial_ms"] = ms_old
    configs = {"pll_scan": pll_kernel.launch_config(),
               "agc_scan": scan_kernels.agc_launch_config()}
    chains = {"pll_scan": chain_bound_ms(L, PLL_CHAIN_OPS),
              "agc_scan": chain_bound_ms(x.shape[1], AGC_CHAIN_OPS)}
    emit("design", mode=mode_name, card=card_line(),
         **{k: dict(configs[k], shape=times[k][2], ms=times[k][0],
                    serial_ms=times[k][1],
                    unlocked_step_share=share if k == "pll_scan" else None,
                    chain_bound_ms=chains[k]) for k in configs})


def branch_ys(params, z, pst, gain0):
    """The AGC output each unfused branch hands to gardner_manchester on
    the blocks z, as demod_blocks makes it: {"front": pll_fir_agc's y,
    False: agc_scan's y after pll_scan and fir_interp}, each squelched as
    the mode says."""
    import torch
    from project_desert_tortoise_tpu_torch.ops import agc, fir
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
        pll_fir_agc)
    from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
        pll_scan_kernel)

    _, _, y_front, lock_front = pll_fir_agc(params, pst, gain0, z)
    _, soft, lock = pll_scan_kernel(params.pll, pst, z)
    if params.squelch_position == "after_pll":
        soft = agc.squelch(soft, torch.abs(lock), params.squelch_threshold)
    x = fir.fir_interp(soft, params.taps, params.interp)
    del soft
    _, y_scan = sk.agc_scan(gain0, x, sk.AGCParams(params.agc_attack,
                                                   params.agc_decay))
    del x
    if params.squelch_position == "after_agc":
        y_front = agc.squelch(y_front, torch.abs(lock_front),
                              params.squelch_threshold)
        y_scan = agc.squelch(y_scan, torch.abs(lock),
                             params.squelch_threshold)
    return {"front": y_front, False: y_scan}


def phase_gardner_at_main_shape(mode_name: str, staged, stats: dict,
                                window: int = 4096):
    """gardner_manchester against its serial twin (gardner_manchester_serial)
    on every entry of the pass's main blocks, bit for bit, with the inputs
    demod_blocks gives it on each unfused branch: that branch's y, the
    interpolated time plane, the whole blocks valid, windows of
    window * interp.  Times both in this run; one `design` line: the
    launch configuration the card reports, the times, the share of slots
    filled as inactive and the chain bound (17 counted dependent
    operations a slot, computed, not measured) over all slots and over
    the slots the chain computes."""
    import torch
    from project_desert_tortoise_tpu_torch.ops import clock, fir
    from project_desert_tortoise_tpu_torch.ops import manchester as man
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    from project_desert_tortoise_tpu_torch.parallel import blocked

    params, plan, fs, n, norm, zre, zim, lo, fest = staged
    B, L = zre.shape
    interp, dev = params.interp, zre.device
    pst, gain0 = blocked.warm_state(params, fest, fs, norm)
    pos = blocked.sample_positions(lo, n, plan.total, 1 if interp > 1 else 0)
    t = fir.fir_out_times(pos, interp) if interp > 1 else pos
    del pos
    cap = L * interp
    gp = sk.GardnerParams(params.step_size, params.gardner_err_limit,
                          params.gardner_gain, params.resync_threshold)
    lay = sk.layout(cap, window * interp, params.step_size,
                    params.gardner_err_limit)
    g0 = clock.gardner_init((B,), device=dev)
    m0 = man.manchester_init((B,), device=dev)
    fstate = (*g0, m0.cur, m0.prev, m0.prevprev)
    istate = (m0.clockmod, m0.evenodd)
    n_valid = torch.full((B,), cap, dtype=torch.int32, device=dev)
    GM, GS = sk.gardner_manchester, sk.gardner_manchester_serial
    times, filled = {}, {}
    for br, y in branch_ys(params, (zre, zim), pst, gain0).items():
        args = (fstate, istate, y, t, n_valid, gp, lay)
        ms, ms_old, got, want = old_new_ms(lambda: GM(*args),
                                           lambda: GS(*args), reps=10)
        check_equal(got, want, f"gardner_manchester vs serial ({br} "
                    "branch's y)")
        times[br] = (ms, ms_old)
        del got, want
        filled[br] = torch.zeros((B,), dtype=torch.int32, device=dev)
        GM(*args, filled=filled[br])
        emit("whole_pass_vs_serial", mode=mode_name,
             kernel="gardner_manchester", case=f"{br} branch's y", B=B,
             L=cap, windows=lay.n_win, bit_exact=True, ms=ms,
             serial_ms=ms_old, speedup=ms_old / ms, card=card_line())
    slots = lay.n_win * lay.spw
    # the scan branch (the JAX CLI's --fast) as the row's main case
    ms, ms_old = times[False]
    computed = slots - int(filled[False].min())     # the longest lane's
    emit("design", mode=mode_name, card=card_line(), gardner_manchester=dict(
        sk.gardner_launch_config(lay), shape=[B, cap], layout=lay._asdict(),
        ms=ms, serial_ms=ms_old,
        filled_slot_share={str(k): float(f.sum()) / (B * slots)
                           for k, f in filled.items()},
        chain_bound_ms=chain_bound_ms(slots, GM_SLOT_CHAIN_OPS),
        computed_slots_a_lane=computed,
        computed_chain_bound_ms=chain_bound_ms(computed, GM_SLOT_CHAIN_OPS)))
    stats["gardner_manchester_serial"] = dict(ms=ms_old, shape=[B, cap],
                                              redesigned_ms=ms,
                                              max_abs_err=0.0)
    stats["gardner_manchester"].update(ms=ms, shape=[B, cap],
                                       serial_ms=ms_old)


def phase_new_kernels_at_main_shape(mode_name: str, staged, stats: dict,
                                    window: int = 4096):
    """The kernels of the front and scan branches against their plain
    versions on the inputs demod_blocks gives them on the pass: its lanes,
    warm PLL state and gains, its squelch and its Gardner layout (windows
    of window * interp), each bit-exact, on the blocks' first MAIN_CHECK_L
    samples (two Gardner windows; pll_fir_agc on the first FRONT_CHECK_L).
    Also fir_interp on the card against the float64 sum, which TF32 would
    miss (its error is reported beside)."""
    import torch
    from project_desert_tortoise_tpu_torch.ops import agc, clock, fir, pll
    from project_desert_tortoise_tpu_torch.ops import manchester as man
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
        pll_fir_agc, pll_fir_agc_ref)
    from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
        pll_scan_kernel)
    from project_desert_tortoise_tpu_torch.parallel import blocked

    params, plan, fs, n, norm, zre, zim, lo, fest = staged
    B, L, interp = zre.shape[0], MAIN_CHECK_L, params.interp
    z = tuple(x[:, :L].contiguous() for x in (zre, zim))
    pst, gain0 = blocked.warm_state(params, fest, fs, norm)
    case = f"{mode_name} main path blocks"
    zf = tuple(x[:, :FRONT_CHECK_L].contiguous() for x in z)
    time_pair("pll_fir_agc", case,
              lambda: pll_fir_agc(params, pst, gain0, zf),
              lambda: pll_fir_agc_ref(params, pst, gain0, zf),
              [B, FRONT_CHECK_L], stats)
    pos = blocked.sample_positions(lo, n, plan.total, 1 if interp > 1 else 0)
    pos = pos[:, :L].contiguous()
    time_pair("pll_scan", case, lambda: pll_scan_kernel(params.pll, pst, z),
              lambda: pll.pll_scan_ref(params.pll, pst, *z), [B, L], stats)

    # the scan branch's FIR and AGC inputs, as demod_blocks makes them
    _, soft, lock = pll_scan_kernel(params.pll, pst, z)
    if params.squelch_position == "after_pll":
        soft = agc.squelch(soft, torch.abs(lock), params.squelch_threshold)
    x = fir.fir_interp(soft, params.taps, interp)
    exact = fir.fir_interp(soft.cpu().double(), params.taps, interp)
    err = float((x.cpu().double() - exact).abs().max())
    scale = max(1.0, float(exact.abs().max()))
    emit("fir_interp_vs_float64", mode=mode_name, shape=list(x.shape),
         max_abs_err=err, tolerance=1e-5 * scale, tf32_max_abs_err=(
             tf32_fir_err(soft, params.taps, interp, exact)),
         card=card_line())
    if err > 1e-5 * scale:
        raise AssertionError(f"fir_interp on the card is {err} from the "
                             "float64 sum: not full float32")
    ap = sk.AGCParams(params.agc_attack, params.agc_decay)
    time_pair("agc_scan", case, lambda: sk.agc_scan(gain0, x, ap),
              lambda: sk.agc_scan_ref(gain0, x, ap), list(x.shape), stats)
    ys = branch_ys(params, z, pst, gain0)

    t = fir.fir_out_times(pos, interp) if interp > 1 else pos
    cap = L * interp
    gp = sk.GardnerParams(params.step_size, params.gardner_err_limit,
                          params.gardner_gain, params.resync_threshold)
    lay = sk.layout(cap, window * interp, params.step_size,
                    params.gardner_err_limit)
    g0 = clock.gardner_init((B,), device=zre.device)
    m0 = man.manchester_init((B,), device=zre.device)
    fstate = (*g0, m0.cur, m0.prev, m0.prevprev)
    istate = (m0.clockmod, m0.evenodd)
    n_valid = torch.full((B,), cap, dtype=torch.int32, device=zre.device)
    for br, y in (("front", ys["front"]), ("scan", ys[False])):
        args = (fstate, istate, y, t, n_valid, gp, lay)
        time_pair("gardner_manchester", f"{case}, {br} branch's y, "
                  f"{lay.n_win} windows of {lay.window}",
                  lambda: sk.gardner_manchester(*args),
                  lambda: sk.gardner_manchester_ref(*args), [B, cap], stats)


def tf32_fir_err(x, taps, interp: int, exact) -> float:
    """Largest error of fir_interp's convolution with cuDNN's TF32 allowed,
    against the float64 sum: what a check at 1e-5 must be able to see."""
    import torch
    cudnn = torch.backends.cudnn
    n_taps = len(taps)
    hist_len = -(-(n_taps - 1) // interp)
    s = torch.zeros((x.shape[0], 1, (hist_len + x.shape[1]) * interp),
                    device=x.device)
    s[:, 0, hist_len * interp::interp] = x
    w = torch.as_tensor(np.asarray(taps, np.float32), device=x.device)
    with cudnn.flags(enabled=True, allow_tf32=True):
        y = torch.nn.functional.conv1d(
            s[..., hist_len * interp - (n_taps - 1):], w.reshape(1, 1, -1))
    return float((y.reshape(x.shape[0], -1).cpu().double()
                  - exact).abs().max())


def phase_branch_stages(mode_name: str, staged, br,
                        window: int = 4096) -> dict:
    """The steps of demod_blocks(use_pallas=br) on the blocks the pass
    stages, one by one, each timed by CUDA events, then the whole of
    demod_frames on the host clock, three times (the median and each run
    reported).  Returns each kernel's ms and bound at
    this shape."""
    import torch
    from project_desert_tortoise_tpu_torch.ops import agc, clock, fir
    from project_desert_tortoise_tpu_torch.ops import manchester as man
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
        pll_fir_agc)
    from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
        pll_scan_kernel)
    from project_desert_tortoise_tpu_torch.parallel import blocked

    mode, _ = modes()[mode_name]
    params, plan, fs, n, norm, zre, zim, lo, fest = staged
    B, L = zre.shape
    interp = params.interp
    pos = blocked.sample_positions(lo, n, plan.total, 1 if interp > 1 else 0)
    pst, gain0 = blocked.warm_state(params, fest, fs, norm)
    ms = {}

    def step(name, fn):
        ms[name], out = cuda_ms(fn)
        return out
    if br == "front":
        _, _, y, lock = step("pll_fir_agc", lambda: pll_fir_agc(
            params, pst, gain0, (zre, zim)))
    else:
        _, soft, lock = step("pll_scan", lambda: pll_scan_kernel(
            params.pll, pst, (zre, zim)))
        if params.squelch_position == "after_pll":
            soft = step("squelch", lambda: agc.squelch(
                soft, torch.abs(lock), params.squelch_threshold))
        x = step("fir_interp", lambda: fir.fir_interp(soft, params.taps,
                                                      interp))
        _, y = step("agc_scan", lambda: sk.agc_scan(
            gain0, x, sk.AGCParams(params.agc_attack, params.agc_decay)))
    if params.squelch_position == "after_agc":
        y = step("squelch", lambda: agc.squelch(y, torch.abs(lock),
                                                params.squelch_threshold))
    t_out = (step("fir_out_times", lambda: fir.fir_out_times(pos, interp))
             if interp > 1 else pos)
    _, _, bits, btimes, mask = step(
        "gardner_manchester", lambda: clock.gardner_manchester_windowed(
            clock.gardner_init((B,), device=zre.device),
            man.manchester_init((B,), device=zre.device), y, t_out,
            L * interp, params.step_size, params.gardner_err_limit,
            params.gardner_gain, params.resync_threshold,
            window=window * interp))
    step("compress_sorted", lambda: man.compress_sorted(
        bits, btimes, mask, bits.shape[-1] // 2 + 8))
    runs = []                 # the whole stage thrice: its host time varies
    for _ in range(3):
        t0 = time.perf_counter()
        blocked.demod_frames(params, plan, mode.framer, fs, zre, zim, lo, n,
                             fest, norm, window, br)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    # the chains' bound, computed from counted operations (not measured)
    chains = ({"pll_fir_agc": chain_bound_ms(L, front_chain_ops(interp))}
              if br == "front" else
              {"pll_scan": chain_bound_ms(L, PLL_CHAIN_OPS),
               "agc_scan": chain_bound_ms(L * interp, AGC_CHAIN_OPS)})
    chains["gardner_manchester"] = chain_bound_ms(bits.shape[-1],
                                                  GM_SLOT_CHAIN_OPS)
    emit("stages", mode=mode_name, use_pallas=br, B=B, L=L, card=card_line(),
         demod_frames_s=sorted(runs)[1], demod_frames_runs_s=runs,
         **{k + "_ms": v for k, v in ms.items()},
         chain_bound_ms=chains)
    # bytes each input read once, each output written once; operations
    # counted from the sources (sinf/cosf one each): PLL ~40 a sample, FIR
    # 2 a tap and AGC 8 per output, Gardner+Manchester ~30 per symbol
    # (gardner_manchester's kernel ms is phase_gardner_at_main_shape's,
    # over ten launches; this step's adds its wrapper's state ops)
    n_sym = 2.0 * float(mask.sum())          # two symbols per emitted bit
    out = {"gardner_manchester": dict(
        step_ms=ms["gardner_manchester"], **bound(
            n_sym * 12.0 + bits.numel() * 6.0, n_sym * 30.0))}
    if br == "front":
        out["pll_fir_agc"] = dict(ms=ms["pll_fir_agc"], shape=[B, L], **bound(
            B * L * (8.0 + 4 * interp + 4),
            B * L * (40.0 + 8 * interp + 2 * len(params.taps))))
    else:
        out["pll_scan"] = dict(ms=ms["pll_scan"], shape=[B, L],
                               **bound(B * L * 16.0, B * L * 40.0))
        out["agc_scan"] = dict(ms=ms["agc_scan"], shape=[B, L * interp],
                               **bound(B * L * interp * 8.0,
                                       B * L * interp * 8.0))
    return out


@contextlib.contextmanager
def patched(module, name: str, value):
    """module.name replaced by value for the duration."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield saved
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def exact_kernels_replaced(make):
    """The exact chain's three kernel wrappers, as chain.chunk_step reaches
    them (module attributes), replaced by make(name, wrapper, plain) for
    the duration."""
    from project_desert_tortoise_tpu_torch.ops import pll
    from project_desert_tortoise_tpu_torch.ops.kernels import pll_kernel
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels

    def pll_plain(params, state, z, **_):
        return pll.pll_scan_ref(params, state, *z)
    sites = (("pll_scan", pll_kernel, "pll_scan_kernel", pll_plain),
             ("agc_scan", scan_kernels, "agc_scan",
              scan_kernels.agc_scan_ref),
             ("gardner_manchester_scan", scan_kernels,
              "gardner_manchester_scan",
              scan_kernels.gardner_manchester_scan_ref))
    with contextlib.ExitStack() as stack:
        for name, mod, attr, plain in sites:
            stack.enter_context(patched(mod, attr, make(
                name, getattr(mod, attr), plain)))
        yield


def sym_image(L: int, step: float, seed: int):
    """An interpolated-rate stream of +-1 symbols `step` samples long with
    noise (tests/test_torch_chain.py::_sym_stream), float32 (1, L)."""
    rng = np.random.default_rng(seed)
    sym = rng.choice([-1.0, 1.0], int(L / step) + 2)
    pos = (np.arange(L) + rng.uniform(0, step)) / step
    x = sym[pos.astype(int)] + 0.1 * rng.standard_normal(L)
    return x.astype(np.float32)[None]


def phase_exact_kernels(stats: dict):
    """The exact chain's kernels at one lane against their plain versions,
    bit for bit.  pll_scan from an unlocked start (the acquisition sweep
    in the kernel) and agc_scan on its interpolated output, over
    EXACT_CHECK_L samples of a synthetic POES signal from its start;
    gardner_manchester_scan over poes_tip's quirks image (30,000
    interpolated samples) with the mid-bit pointer carried stale inside
    the image, past the valid length (a short final chunk), past the image
    and negative, also against its serial twin (both timed in this run)
    and on a forced small ring; one `design` line: the launch
    configuration the card reports, the times and the chain bound (17
    counted dependent operations a slot, computed, not measured) over all
    slots and over the slots the chain computes."""
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops import agc, fir, pll
    from project_desert_tortoise_tpu_torch.ops import manchester as man
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
        pll_scan_kernel)
    from project_desert_tortoise_tpu_torch.utils import synth
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

    dev = torch.device("cuda")
    params = chain.make_params(POES_TIP, POES_FS, quirks=True)
    iq, _ = synth.make_poes_recording(n_frames=4, fs=POES_FS)
    iq = (iq / (np.abs(iq).max() * 1.2)).astype(np.complex64)
    start = int(0.3 * POES_FS)              # where the signal starts
    cold = pll.init_state(params.pll, (1,), device=dev)
    gain = torch.full((1,), agc.static_gain(iq[:10000], POES_TIP.
                                            static_gain_level), device=dev)
    ap = sk.AGCParams(params.agc_attack, params.agc_decay)
    locked_after = {}
    for L in EXACT_CHECK_L:
        z = tuple(torch.from_numpy(np.ascontiguousarray(
            a[start:start + L])[None]).to(dev) for a in (iq.real, iq.imag))
        unlocked = torch.zeros((1,), dtype=torch.int32, device=dev)
        pll_scan_kernel(params.pll, cold, z, unlocked=unlocked)
        locked_after[L] = int(unlocked[0])
        pll_t = time_pair(
            "pll_scan", f"exact chain, 1 lane, unlocked start, {L} samples",
            lambda: pll_scan_kernel(params.pll, cold, z),
            lambda: pll.pll_scan_ref(params.pll, cold, *z), [1, L], stats)
        _, soft, _ = pll_scan_kernel(params.pll, cold, z)
        x = fir.fir_interp(soft, params.taps, params.interp)
        agc_t = time_pair("agc_scan", f"exact chain, 1 lane, {L} samples",
                          lambda: sk.agc_scan(gain, x, ap),
                          lambda: sk.agc_scan_ref(gain, x, ap),
                          list(x.shape), stats)
        if L == POES_TIP.chunk_size:     # the exact_cli run's chunk
            for name, (ms, plain_ms, _), shape in (
                    ("pll_scan", pll_t, [1, L]),
                    ("agc_scan", agc_t, list(x.shape))):
                stats[name]["exact"] = dict(check_ms=ms, plain_ms=plain_ms,
                                            plain_shape=shape)
    emit("exact_unlocked_steps", card=card_line(), steps_before_lock=
         {str(k): v for k, v in locked_after.items()})

    cap = 10000 * params.interp
    msyms = chain.max_symbols(cap, params.step_size)
    x = torch.from_numpy(sym_image(cap, params.step_size, 1)).to(dev)
    t = (torch.arange(1, cap + 1, device=dev, dtype=torch.float32)
         / float(np.float32(POES_FS)))[None].contiguous()
    gp = sk.GardnerParams(params.step_size, params.gardner_err_limit,
                          params.gardner_gain, params.resync_threshold)
    m0 = man.manchester_init((1,), device=dev)
    istate = (m0.clockmod, m0.evenodd + 1)
    short = cap - 3 * 2591                  # a final chunk of 7,409 samples
    GS, GSS = sk.gardner_manchester_scan, sk.gardner_manchester_scan_serial
    times = {}
    for case, n_valid, half in (("stale inside the image", cap, cap - 9.6),
                                ("past the valid length", short, short + 3.5),
                                ("past the image", cap, cap + 7.25),
                                ("negative", cap, -4.5)):
        f = lambda v: torch.full((1,), float(np.float32(v)), device=dev)
        fstate = (f(7.3), f(half), f(0.4), f(0.9), f(-0.8), f(0.7))
        n = torch.full((1,), n_valid, dtype=torch.int32, device=dev)
        args = (fstate, istate, x, t, n, gp, msyms)
        time_pair("gardner_manchester_scan", f"quirks image, 1 lane, "
                  f"half_raw {case}", lambda: GS(*args),
                  lambda: sk.gardner_manchester_scan_ref(*args), [1, cap],
                  stats)
        ms, ms_old, got, want = old_new_ms(lambda: GS(*args),
                                           lambda: GSS(*args), reps=10)
        check_equal(got, want, f"gardner_manchester_scan vs serial "
                    f"(half_raw {case})")
        check_equal(GS(*args, ring_floats=SMALL_RING), want,
                    f"gardner_manchester_scan, small ring, vs serial "
                    f"(half_raw {case})")
        times[case] = (ms, ms_old, int(got[-1][0]))
        emit("whole_image_vs_serial", kernel="gardner_manchester_scan",
             case=f"quirks image, half_raw {case}", B=1, L=cap,
             bit_exact=True, small_ring_bit_exact=True, ms=ms,
             serial_ms=ms_old, speedup=ms_old / ms, card=card_line())
    ms, ms_old, count = times["stale inside the image"]
    computed = min(count + 1, msyms)      # up to the first inactive slot
    emit("design", mode="poes exact chain", card=card_line(),
         gardner_manchester_scan=dict(
             sk.gardner_scan_launch_config(1, cap), shape=[1, cap],
             max_syms=msyms, ms=ms, serial_ms=ms_old,
             chain_bound_ms=chain_bound_ms(msyms, GM_SLOT_CHAIN_OPS),
             computed_slots_a_lane=computed,
             computed_chain_bound_ms=chain_bound_ms(computed,
                                                    GM_SLOT_CHAIN_OPS),
             small_ring=sk.gardner_scan_launch_config(1, cap, SMALL_RING)))
    stats["gardner_manchester_scan_serial"] = dict(
        ms=ms_old, shape=[1, cap], redesigned_ms=ms, max_abs_err=0.0)
    stats["gardner_manchester_scan"]["isolated"] = dict(
        ms=ms, serial_ms=ms_old, shape=[1, cap])


ARGOS_EXACT_CHECK_L = (2400, 1680, 1234)   # the argos chunk, the pass's
                                           # final one, a short one
LATENCY_STEPS = {"sin": 2048, "cos": 2048, "sincos": 2048}


def phase_fp64_latency():
    """The latency of dependent operations on the card
    (csrc/fp64_latency.cu): one thread runs a chain of 16,384 steps of one
    kind (2,048 of sin, cos and the sin/cos pair, each with an add), the
    clock64() cycles over the steps, the least of three runs, into
    LATENCY_CYCLES: the double kinds, the float add and the dependent
    shared-memory load.  The float64 chain bounds count chain_cycles_f64(),
    the least of the double add, multiply and compare-select latencies;
    the redesigned clock kernels' and the ablation tools' chain bounds the
    float add's, the floor's and the load's (whole_image_chain_cycles)."""
    import torch
    from project_desert_tortoise_tpu_torch.ops.kernels.common import launch

    dev = torch.device("cuda")
    inp = torch.tensor([0.5, 1.0000001, 0.25], dtype=torch.float64,
                       device=dev)
    out = torch.zeros(1, dtype=torch.float64, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    for kind, name in enumerate(LATENCY_KINDS):
        steps = LATENCY_STEPS.get(name, 16384)
        runs = []
        for _ in range(3):
            launch(dev, "pdt_fp64_latency", kind, inp.data_ptr(),
                   out.data_ptr(), cycles.data_ptr(), steps)
            torch.cuda.synchronize()
            runs.append(int(cycles[0]) / steps)
        LATENCY_CYCLES[name] = min(runs)
    emit("fp64_latency", cycles_a_step=dict(LATENCY_CYCLES),
         chain_cycles_f64=chain_cycles_f64(),
         chain_cycles_f32=LATENCY_CYCLES["f32_add"],
         ld_shared_cycles=LATENCY_CYCLES["ld_shared"], card=card_line())


def phase_argos_exact_kernels(stats: dict):
    """The float64 argos exact chain's three kernels at one lane against
    their plain versions on the card, bit for bit (max abs error 0): from
    an unlocked start where the first packet's signal begins (the
    acquisition sweep; the lane locks inside a 256-sample chunk of the
    decoupled PLL), over a 2,400-sample chunk, the pass's final chunk of
    1,680 and a short one of 1,234: pll_scan_f64 (also from a locked
    start, the state after the first chunk), agc_scan_f64 on its filtered
    output, and gardner_manchester_scan_f64 on the squelched AGC output,
    as the quirks image (over the previous chunk's image, the mid-bit
    pointer carried stale inside the image, past the valid length, past
    the image and negative; also on a forced small ring) and as the
    chunk-invariant image (16 carried samples, then the chunk); ms by CUDA
    events.  pll_scan_f64 and gardner_manchester_scan_f64 are also held to
    their serial twins (pll_scan_f64_serial,
    gardner_manchester_scan_f64_serial) and timed beside them in this run
    (`whole_chunk_vs_serial` lines).  One `design` line: the launch
    configurations the card reports, the kernels' and twins' ms at the
    2,400-sample chunk, their chain bounds (computed from counted
    operations at the latency phase_fp64_latency measured) and the share
    of the serial PLL's cycles a sample that its data arm's sin/cos pair
    takes."""
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops import agc, fir, pll
    from project_desert_tortoise_tpu_torch.ops import manchester as man
    from project_desert_tortoise_tpu_torch.ops.kernels import pll_kernel as pk
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    from project_desert_tortoise_tpu_torch.utils import synth
    from project_desert_tortoise_tpu_torch.utils.config import ARGOS

    dev, f64 = torch.device("cuda"), torch.float64
    params = chain.make_params(ARGOS, ARGOS_FS, quirks=True)
    iq, _ = synth.make_argos_recording(n_packets=2, fs=ARGOS_FS)
    iq = (iq / (np.abs(iq).max() * 1.2)).astype(np.complex128)
    start = int(0.4 * ARGOS_FS)           # the first packet's signal
    cold = pll.init_state(params.pll, (1,), device=dev, dtype=f64)
    gain = torch.full((1,), agc.static_gain(
        iq[:ARGOS.chunk_size], ARGOS.static_gain_level, np.float64),
        dtype=f64, device=dev)
    ap = sk.AGCParams(params.agc_attack, params.agc_decay)
    gp = sk.GardnerParams(params.step_size, params.gardner_err_limit,
                          params.gardner_gain, params.resync_threshold)
    cap = ARGOS.chunk_size * params.interp
    msyms = chain.max_symbols(cap, params.step_size)
    m0 = man.manchester_init((1,), device=dev)
    istate = (m0.clockmod, m0.evenodd + 1)
    z_at = lambda a, L: tuple(
        torch.from_numpy(np.ascontiguousarray(v[a:a + L])[None]).to(dev)
        for v in (iq.real, iq.imag))

    def front(a, L):
        """The chunk iq[a:a+L] from the cold state: (pll args, agc args,
        squelched AGC output)."""
        z = z_at(a, L)
        _, soft, lock = pk.pll_scan_kernel(params.pll, cold, z)
        x = fir.fir_interp(soft, params.taps, params.interp)
        _, y = sk.agc_scan(gain, x, ap)
        return z, x, agc.squelch(y, lock, params.squelch_threshold)

    def vs_serial(name, case, new, old, shape):
        """new against its serial twin old: bit-exact, both timed."""
        ms, ms_old, got, want = old_new_ms(new, old)
        check_equal(got, want, f"{name} vs serial ({case})")
        emit("whole_chunk_vs_serial", kernel=name, case=case, shape=shape,
             bit_exact=True, ms=ms, serial_ms=ms_old, speedup=ms_old / ms,
             card=card_line())
        return ms, ms_old
    _, _, prev = front(start - cap, cap)  # the previous chunk's image
    warm, _, lock = pll.pll_scan_ref(params.pll, cold, *z_at(start, cap))
    locks_at = int(torch.nonzero(lock[0] > params.pll.lock_threshold)[0])
    times, serial = {}, {}
    for L in ARGOS_EXACT_CHECK_L:
        z, x, y = front(start, L)
        starts = (("unlocked start", cold, z),
                  ("locked start", warm, z_at(start + cap, L)))
        for case, st0, zs in starts[:2 if L == cap else 1]:
            times["pll_scan_f64", L, case] = time_pair(
                "pll_scan_f64", f"argos exact chain, 1 lane, {case}, "
                f"{L} samples",
                lambda: pk.pll_scan_kernel(params.pll, st0, zs),
                lambda: pll.pll_scan_ref(params.pll, st0, *zs), [1, L], stats)
            serial["pll_scan_f64", L, case] = vs_serial(
                "pll_scan_f64", f"{case}, {L} samples",
                lambda: pk.pll_scan_f64(params.pll, st0, zs),
                lambda: pk.pll_scan_f64_serial(params.pll, st0, zs), [1, L])
        times["agc_scan_f64", L] = time_pair(
            "agc_scan_f64", f"argos exact chain, 1 lane, {L} samples",
            lambda: sk.agc_scan(gain, x, ap),
            lambda: sk.agc_scan_ref(gain, x, ap), list(x.shape), stats)
        n_i = L * params.interp
        quirks_img = torch.cat([y, prev[:, n_i:]], dim=-1)
        times_of = lambda k: (torch.arange(1, k + 1, dtype=f64, device=dev)
                              / ARGOS_FS)[None].contiguous()
        t_img = times_of(cap)
        m = chain.TAIL_MARGIN
        invariant = (torch.cat([prev[:, -m:], y], dim=-1), times_of(m + n_i))
        f = lambda v: torch.full((1,), v, dtype=f64, device=dev)
        for case, img, n_valid, half in (
                ("quirks, stale inside the image", (quirks_img, t_img),
                 n_i, cap - 9.6),
                ("quirks, past the valid length", (quirks_img, t_img), n_i,
                 n_i + 3.5),
                ("quirks, past the image", (quirks_img, t_img), n_i,
                 cap + 7.25),
                ("quirks, negative", (quirks_img, t_img), n_i, -4.5),
                ("chunk-invariant image", invariant, m + n_i, m + 3.25)):
            fstate = (f(7.3), f(half), f(0.4), f(0.9), f(-0.8), f(0.7))
            n = torch.full((1,), n_valid, dtype=torch.int32, device=dev)
            args = (fstate, istate, *img, n, gp, msyms)
            times["gardner_manchester_scan_f64", L, case] = time_pair(
                "gardner_manchester_scan_f64",
                f"argos exact chain, 1 lane, {L} samples, {case}",
                lambda: sk.gardner_manchester_scan(*args),
                lambda: sk.gardner_manchester_scan_ref(*args),
                [1, img[0].shape[1]], stats)
            serial["gardner_manchester_scan_f64", L, case] = vs_serial(
                "gardner_manchester_scan_f64", f"{L} samples, {case}",
                lambda: sk.gardner_manchester_scan_f64(*args),
                lambda: sk.gardner_manchester_scan_f64_serial(*args),
                [1, img[0].shape[1]])
            check_equal(sk.gardner_manchester_scan_f64(
                *args, ring_floats=SMALL_RING_F64),
                sk.gardner_manchester_scan_f64_serial(*args),
                f"gardner_manchester_scan_f64, small ring ({L}, {case})")
    L = ARGOS.chunk_size
    clock = max_sm_clock_hz()
    pll_ms, pll_serial_ms = serial["pll_scan_f64", L, "locked start"]
    gm_case = (L, "quirks, stale inside the image")
    gm_ms, gm_serial_ms = serial[("gardner_manchester_scan_f64",) + gm_case]
    serial_cycles = pll_serial_ms * 1e-3 / L * clock
    sincos = LATENCY_CYCLES["sincos"] - LATENCY_CYCLES["add"]
    cycles = chain_cycles_f64()
    chains = {
        "pll_scan_f64 (stage A, locked)": chain_bound_ms(
            L, PLL_CHAIN_OPS, cycles),
        "pll_scan_f64_serial (without sin/cos, q_rsqrt)": chain_bound_ms(
            L, PLL_F64_SERIAL_CHAIN_OPS, cycles),
        "agc_scan_f64": chain_bound_ms(L * params.interp, AGC_CHAIN_OPS,
                                       cycles),
        "gardner_manchester_scan_f64": chain_bound_ms(
            msyms, GM_SLOT_CHAIN_OPS, cycles)}
    emit("design", mode="argos exact chain (float64)", card=card_line(),
         chain_cycles_f64=cycles, fp64_cycles_a_step=dict(LATENCY_CYCLES),
         pll_scan_f64=dict(pk.launch_config(dtype=f64), shape=[1, L],
                           ms_locked=pll_ms,
                           ms_unlocked=serial["pll_scan_f64", L,
                                              "unlocked start"][0],
                           cold_start_locks_at_sample=locks_at),
         gardner_manchester_scan_f64=dict(
             sk.gardner_scan_launch_config(1, cap, dtype=f64),
             shape=[1, cap], ms=gm_ms, max_syms=msyms,
             small_ring=sk.gardner_scan_launch_config(
                 1, cap, SMALL_RING_F64, dtype=f64)),
         ms={"pll_scan_f64": pll_ms, "pll_scan_f64_serial": pll_serial_ms,
             "agc_scan_f64": times["agc_scan_f64", L][0],
             "gardner_manchester_scan_f64": gm_ms,
             "gardner_manchester_scan_f64_serial": gm_serial_ms},
         chain_bound_ms=chains,
         serial_pll_cycles_a_sample=serial_cycles,
         sincos_cycles=sincos, sincos_share_of_serial_sample=(
             sincos / serial_cycles))
    stats["pll_scan_f64_serial"] = dict(
        ms=pll_serial_ms, shape=[1, L], redesigned_ms=pll_ms,
        max_abs_err=0.0)
    stats["gardner_manchester_scan_f64_serial"] = dict(
        ms=gm_serial_ms, shape=[1, cap], redesigned_ms=gm_ms,
        max_abs_err=0.0)


# the files the telemetry explorer writes for the POES pass's frames: how
# many, and the first 16 hex digits of the sha256 of their sorted names
# joined by newlines.  tests/test_torch_telemetry.py recomputes both with
# the JAX package's explorer (the same with the acquisition lead-in frame
# and without it).
POES_PASS_PRODUCTS = (70, "99a1cec24886e577")


def phase_products(workdir: str, frames_txt: str):
    """The port's telemetry explorer (what ``--products`` runs) on the POES
    CLI's output file: it must exit 0, write the files JAX's explorer
    writes for those frames (POES_PASS_PRODUCTS), and its summary's
    error-free count must be check_parity's on the file's frames.  Its
    wall seconds."""
    from project_desert_tortoise_tpu_torch.apps import telemetry_explorer
    from project_desert_tortoise_tpu_torch.telemetry.minorframes import (
        check_parity)
    from project_desert_tortoise_tpu_torch.utils.output import (
        parse_frames_file)

    outdir = os.path.join(workdir, "products")
    so = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(so):
        rc = telemetry_explorer.run([frames_txt, "--outdir", outdir])
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"the telemetry explorer exited {rc}")
    names = sorted(os.listdir(outdir))
    digest = hashlib.sha256("\n".join(names).encode()).hexdigest()[:16]
    if (len(names), digest) != POES_PASS_PRODUCTS:
        raise AssertionError(f"the explorer wrote {len(names)} files "
                             f"({digest}), not {POES_PASS_PRODUCTS}")
    rows = [r[2] for r in parse_frames_file(frames_txt) if len(r[2]) == 104]
    good, _ = check_parity(np.array(rows, np.uint8))
    want = f"{int(good.sum())} out of {len(rows)} Error Free Frames"
    with open(os.path.join(outdir, "summary.txt")) as f:
        summary = f.read()
    if summary.splitlines()[0] != want:
        raise AssertionError(f"summary {summary.splitlines()[0]!r}, "
                             f"check_parity {want!r}")
    emit("products", files=len(names), names_sha256=digest, wall_s=wall,
         frames=len(rows), error_free=int(good.sum()),
         summary=summary.splitlines(), stdout=so.getvalue().splitlines())


def phase_exact_fallback(staged, stats: dict):
    """gardner_manchester_scan at the block-parallel path's lanes: the
    unwindowed layout demod_blocks falls back to (window=0) on the POES
    pass's 352 blocks, the scan branch's y and the interpolated position
    plane, against its serial twin bit for bit on the whole blocks and
    against its plain version on their first MAIN_CHECK_L samples, the two
    kernels timed on the whole blocks in this run; one `design` line."""
    import torch
    from project_desert_tortoise_tpu_torch.ops import clock, fir
    from project_desert_tortoise_tpu_torch.ops import manchester as man
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    from project_desert_tortoise_tpu_torch.parallel import blocked

    params, plan, fs, n, norm, zre, zim, lo, fest = staged
    B, L = zre.shape
    interp, dev = params.interp, zre.device
    pst, gain0 = blocked.warm_state(params, fest, fs, norm)
    y = branch_ys(params, (zre, zim), pst, gain0)[False]
    pos = blocked.sample_positions(lo, n, plan.total, 1 if interp > 1 else 0)
    t = fir.fir_out_times(pos, interp) if interp > 1 else pos
    del pos
    n_i = L * interp
    max_syms = int(n_i / params.step_size * 1.02) + 16   # JAX's _plan_caps
    g0 = clock.gardner_init((B,), device=dev)
    m0 = man.manchester_init((B,), device=dev)
    fstate = (*g0, m0.cur, m0.prev, m0.prevprev)
    istate = (m0.clockmod, m0.evenodd)
    gp = sk.GardnerParams(params.step_size, params.gardner_err_limit,
                          params.gardner_gain, params.resync_threshold)
    n_c = MAIN_CHECK_L * interp
    cargs = (fstate, istate, y[:, :n_c].contiguous(),
             t[:, :n_c].contiguous(),
             torch.full((B,), n_c, dtype=torch.int32, device=dev), gp,
             int(n_c / params.step_size * 1.02) + 16)
    ms_c, plain_ms, err = time_pair(
        "gardner_manchester_scan", f"poes window=0 layout, {B} lanes",
        lambda: sk.gardner_manchester_scan(*cargs),
        lambda: sk.gardner_manchester_scan_ref(*cargs), [B, n_c], {})
    n_valid = torch.full((B,), n_i, dtype=torch.int32, device=dev)
    args = (fstate, istate, y, t, n_valid, gp, max_syms)
    GS, GSS = sk.gardner_manchester_scan, sk.gardner_manchester_scan_serial
    ms_new, ms_old, got, want = old_new_ms(lambda: GS(*args),
                                           lambda: GSS(*args), reps=5)
    check_equal(got, want, "gardner_manchester_scan vs serial (window=0 "
                "layout)")
    computed = min(int(got[-1].max()) + 1, max_syms)
    del got, want
    emit("whole_pass_vs_serial", mode="poes",
         kernel="gardner_manchester_scan", case="window=0 layout", B=B,
         L=n_i, bit_exact=True, ms=ms_new, serial_ms=ms_old,
         speedup=ms_old / ms_new, card=card_line())
    emit("design", mode="poes window=0", card=card_line(),
         gardner_manchester_scan=dict(
             sk.gardner_scan_launch_config(B, n_i), shape=[B, n_i],
             max_syms=max_syms, ms=ms_new, serial_ms=ms_old,
             chain_bound_ms=chain_bound_ms(max_syms, GM_SLOT_CHAIN_OPS),
             computed_slots_a_lane=computed,
             computed_chain_bound_ms=chain_bound_ms(computed,
                                                    GM_SLOT_CHAIN_OPS)))
    st = stats["gardner_manchester_scan"]
    st["max_abs_err"] = max(st["max_abs_err"], err)
    st["window0"] = dict(ms=ms_new, plain_ms=plain_ms, shape=[B, n_i],
                         plain_shape=[B, n_c], check_ms=ms_c,
                         max_syms=max_syms, serial_ms=ms_old)
    stats["gardner_manchester_scan_serial"]["window0"] = dict(
        ms=ms_old, shape=[B, n_i], redesigned_ms=ms_new)


def state_tensors(state) -> list:
    """A ChainState's tensors, the stream states' fields in order."""
    out = []
    for v in state:
        out.extend(v if isinstance(v, tuple) else (v,))
    return out


# the card's ChainState against the CPU's at the end of a session: the
# envelope of tests/test_torch_exact_chain.py (sin/cos round otherwise on
# the card): soft values and the AGC gain 1e-4, the PLL's phase, frequency
# and lock signal 2e-5, its quality EMA 1e-4, the Gardner pointers 1e-3
# samples, the time image one sample period; what is not listed is equal
STATE_LIMITS = {"pll.phase": 2e-5, "pll.freq": 2e-5, "pll.locksig": 2e-5,
                "pll.avg_phase": 1e-4, "fir_hist": 1e-4, "agc.gain": 1e-4,
                "gardner.next_sample": 1e-3, "gardner.half_raw": 1e-3,
                "gardner.prev_bit": 1e-4, "manchester.cur": 1e-4,
                "manchester.prev": 1e-4, "manchester.prevprev": 1e-4,
                "x_img": 1e-4, "t_img": 1.0001 / POES_FS}


def state_diff(card, cpu, what: str) -> dict:
    """Each field's max abs difference between two ChainStates; raises
    where one is past its STATE_LIMITS entry (0 where none is)."""
    diffs = {}
    for name, a in card._asdict().items():
        b = getattr(cpu, name)
        fields = (a._asdict().items() if isinstance(a, tuple)
                  else ((None, a),))
        for f, v in fields:
            key = name if f is None else f"{name}.{f}"
            w = b if f is None else getattr(b, f)
            if tuple(v.shape) != tuple(w.shape):
                raise AssertionError(f"{what}: {key} has shape "
                                     f"{tuple(v.shape)} against "
                                     f"{tuple(w.shape)}")
            diffs[key] = max_abs_err(v.cpu(), w)
    past = {k: d for k, d in diffs.items() if d > STATE_LIMITS.get(k, 0.0)}
    if past:
        raise AssertionError(f"{what}: final state past its limits {past}")
    return diffs


EXACT_SMALL_MODES = ("poes_tip", "poes_tip no quirks", "poes_tip_realtime")
# the first samples of exact_small's clip on which the session with the
# plain versions on the card runs (~1 ms a sample there, host-bound): a
# poes_tip chunk and a short final one, five poes_tip_realtime chunks and
# a short final one (25,000 until the other clocks and the flat path
# joined the run)
EXACT_SMALL_PLAIN_N = 12_500


def exact_small_session(name: str, device: str, n=None):
    """DemodSession on exact_small's 0.8 s synthetic POES clip (4 frames,
    acquisition included), or its first n samples, in the case `name`
    (EXACT_SMALL_MODES).  Returns (final state, frames, seconds)."""
    from project_desert_tortoise_tpu_torch.models.demodulator import (
        DemodSession)
    from project_desert_tortoise_tpu_torch.utils import synth, wav as W
    from project_desert_tortoise_tpu_torch.utils.config import (
        POES_TIP, POES_TIP_REALTIME)

    iq, _ = synth.make_poes_recording(n_frames=4, fs=POES_FS)
    iq = (iq / (np.abs(iq).max() * 1.2)).astype(np.complex64)[:n]
    t = W.time_axis(len(iq), POES_FS, np.float32)
    mode = POES_TIP_REALTIME if name == "poes_tip_realtime" else POES_TIP
    t0 = time.time()
    s = DemodSession(mode, POES_FS, quirks=name != "poes_tip no quirks",
                     device=device)
    res = s.run(iq, t)
    return s.state, res.frames, time.time() - t0


def cpu_exact_small() -> dict:
    """exact_small's sessions on the CPU (the plain versions), run in the
    CPU worker (cpu_worker): {case: (final state, frames, seconds)}."""
    import torch
    torch.set_num_threads(2)
    return {name: exact_small_session(name, "cpu")
            for name in EXACT_SMALL_MODES}


def phase_exact_small(cpu_sessions: dict):
    """DemodSession on a 0.8 s synthetic POES clip (4 frames, acquisition
    included), for poes_tip with quirks on and off and poes_tip_realtime:
    on the card against the CPU (the plain versions, whose sin/cos round
    otherwise than the card's; `cpu_sessions` from cpu_exact_small),
    frames under the docs/DESIGN.md §4b contract and the final state
    within STATE_LIMITS; and on the clip's first EXACT_SMALL_PLAIN_N
    samples against the same session with the plain versions on the card
    (launches not counted), frames and final state bit for bit."""
    def frames(fr):
        return [(f.time, f.inverted, bytes(f.data), f.complete) for f in fr]
    for name in EXACT_SMALL_MODES:
        cpu_state, a, cpu_wall = cpu_sessions[name]
        card_state, b, card_wall = exact_small_session(name, "cuda")
        diffs = state_diff(card_state, cpu_state, f"exact chain {name}")
        # docs/DESIGN.md §4b on a few frames: payloads identical, at most
        # one timestamp a sample period off
        shifted = sum(x.time != y.time for x, y in zip(a, b))
        if (len(a) != len(b) or len(a) < 2 or shifted > 1
                or any(x.inverted != y.inverted
                       or not np.array_equal(x.data, y.data)
                       or abs(x.time - y.time) > 1.0001 / POES_FS
                       for x, y in zip(a, b))):
            raise AssertionError(f"exact chain {name}: the card's "
                                 f"{len(b)} frames against the CPU's "
                                 f"{len(a)}, {shifted} timestamps shifted")
        n = EXACT_SMALL_PLAIN_N
        kern_state, kern, _ = exact_small_session(name, "cuda", n)
        with exact_kernels_replaced(lambda name, kern, plain: plain):
            plain_state, plain, plain_wall = exact_small_session(name,
                                                                 "cuda", n)
        if frames(kern) != frames(plain):
            raise AssertionError(f"exact chain {name}: the kernels' frames "
                                 "differ from the plain versions'")
        check_equal(tuple(state_tensors(kern_state)),
                    tuple(state_tensors(plain_state)),
                    f"exact chain {name} final state")
        emit("exact_small", card=card_line(), mode=name, cpu_s=cpu_wall,
             card_s=card_wall, plain_on_card_s=plain_wall, frames=len(b),
             time_shifted=shifted, state_max_abs_diff_vs_cpu=diffs,
             plain_samples=n, plain_frames=len(plain),
             frames_and_state_bit_exact_vs_plain=True)


# per mode: the path's name in PATH_KERNELS, and the library entry point
# each of its exact chain's kernels launches
EXACT_PATHS = {
    "poes": ("exact", {"pll_scan": "pdt_pll_scan",
                       "agc_scan": "pdt_agc_scan",
                       "gardner_manchester_scan": "pdt_gardner_scan"}),
    "argos": ("argos_exact", {
        "pll_scan_f64": "pdt_pll_scan_f64",
        "agc_scan_f64": "pdt_agc_scan_f64",
        "gardner_manchester_scan_f64": "pdt_gardner_scan_f64"})}


def phase_exact_cli(mode_name: str, workdir: str, wav: str, want, lead_in,
                    fast_lines, stats: dict):
    """The pass through the port's CLI without ``--fast``: the exact chain
    on the card at one lane, ``demod_poes`` (3,603 chunks of up to 10,000
    samples, float32; ``exact_cli``) or ``demod_argos`` (the float64
    ``argos`` mode, 9,601 chunks of up to 2,400 samples, the kernels'
    double instances; ``argos_exact_cli``).  Its payloads must be the JAX
    exact chain's (EXACT_REFERENCE_* for POES, each one also decoded by
    the fast path in this run; ARGOS_EXACT_REFERENCE_* for ARGOS).  Each
    launch of the three kernels is bracketed by CUDA events in the run
    itself (common.launch_events): their sum is the kernels' device time,
    which also holds the few microseconds a launch takes to reach an idle
    card.  The wall is split on the host clock: the chunk steps' host
    time (launches are queued), the device-to-host fetch (which waits for
    the chunk's device work), the framer, the frame writer, the rest (WAV
    load, static gain); the host's share is the wall outside the fetch.
    Fills the three kernels' rows (ms a launch over the run, the bound of
    the run's mean work a launch); returns the launches."""
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.apps import demod_argos, demod_poes
    from project_desert_tortoise_tpu_torch.models import demodulator
    from project_desert_tortoise_tpu_torch.ops import framer
    from project_desert_tortoise_tpu_torch.ops.kernels import common
    from project_desert_tortoise_tpu_torch.utils import output
    from project_desert_tortoise_tpu_torch.utils.output import (
        parse_frames_file)

    path, entries = EXACT_PATHS[mode_name]
    mode, fs = modes()[mode_name]
    argos = mode_name == "argos"
    out = os.path.join(workdir, f"{mode_name}_exact.txt")
    split = collections.Counter()

    def clocked(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                split[key] += time.perf_counter() - t0
        return run

    def cli():
        if not argos:
            return demod_poes.run([wav, "--out", out])
        try:
            demod_argos.main([wav, "--out", out])
        except SystemExit as done:
            return done.code
        raise AssertionError("demod_argos.main returned without an exit code")
    err, so = io.StringIO(), io.StringIO()
    events = {}
    with contextlib.ExitStack() as stack:
        for key, mod, attr in (
                ("chunk_step", chain, "chunk_step"),
                ("fetch", demodulator.DemodSession, "_fetch"),
                ("framer", framer.StreamFramer, "process"),
                ("write", output.FrameWriter, "write_all")):
            stack.enter_context(patched(mod, attr, clocked(
                key, getattr(mod, attr))))
        stack.enter_context(patched(common, "launch_events", events))
        stack.enter_context(contextlib.redirect_stderr(err))
        stack.enter_context(contextlib.redirect_stdout(so))
        t0 = time.time()
        rc, counts = drive(path, cli)
        wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"the {mode_name} CLI (exact chain) exited {rc}")
    got = [bytes(b) for _, _, b in parse_frames_file(out)]
    if not argos:
        fast = {b for _, b in fast_lines}
        not_fast = [g.hex() for g in got if g not in fast]
        if not_fast:
            raise AssertionError(f"the exact chain decoded {len(not_fast)} "
                                 f"payloads the fast path did not: "
                                 f"{not_fast[:5]}")
    check = payload_check(mode_name, got, want, lead_in, exact=True)
    torch.cuda.synchronize()
    event_s = {}
    for k, entry in entries.items():
        pairs = events.get(entry, [])
        if len(pairs) != counts[k]:
            raise AssertionError(f"{k}: {len(pairs)} timed launches against "
                                 f"{counts[k]} counted")
        event_s[k] = sum(a.elapsed_time(b) for a, b in pairs) / 1e3
    if set(events) != set(entries.values()):
        raise AssertionError(f"the exact chain launched {sorted(events)}")
    progress = re.sub(r"\x1b\[[0-9;]*m", "", err.getvalue().rsplit(
        "\r", 1)[-1]).strip()
    n_bits = int(re.search(r"(\d+) Bits", progress).group(1))
    n_syms = int(re.search(r"(\d+) Sym", progress).group(1))
    n_samples = round(float(re.search(r"([0-9.]+) Ks", progress).group(1))
                      * 1e3)
    # the bound of the run's mean work a launch: bytes each input read once
    # and each output written once, operations counted from the sources as
    # in phase_branch_stages (PLL ~40 a sample, AGC 8 an output,
    # Gardner+Manchester ~30 an active symbol slot), at the stream type's
    # peak; a float64 value is 8 bytes
    params = chain.make_params(mode, fs, quirks=True)
    interp, w = params.interp, (2.0 if argos else 1.0)
    peak = FP64_FLOP_S if argos else FP32_FLOP_S
    slots = chain.max_symbols(mode.chunk_size * interp, params.step_size)
    pll_k, agc_k, gm_k = entries
    per = {k: 1.0 / counts[k] for k in entries}
    work = {
        pll_k: bound((n_samples * 16.0 + counts[pll_k] * 48.0) * w
                     * per[pll_k], n_samples * 40.0 * per[pll_k], peak),
        agc_k: bound(n_samples * interp * 8.0 * w * per[agc_k],
                     n_samples * interp * 8.0 * per[agc_k], peak),
        gm_k: bound((n_syms * 12.0 * w * per[gm_k] + slots * (11.0 + 8.0
                                                              * (w - 1))),
                    n_syms * 30.0 * per[gm_k], peak)}
    shapes = {pll_k: [1, mode.chunk_size],
              agc_k: [1, mode.chunk_size * interp],
              gm_k: [1, mode.chunk_size * interp]}
    ms = {k: event_s[k] * 1e3 / counts[k] for k in entries}
    for k in entries:
        row = dict(ms=ms[k], shape=shapes[k], launches_exact_cli=counts[k],
                   **work[k])
        if argos or k == gm_k:
            stats[k].update(row)
        else:
            stats[k]["exact"].update(row)
    kernels_s = sum(event_s.values())
    split["other"] = wall - sum(split.values())
    cycles = chain_cycles_f64() if argos else CHAIN_CYCLES
    emit("argos_exact_cli" if argos else "exact_cli", wall_s=wall,
         launches={k: counts[k] for k in PATH_KERNELS[path]},
         split_s=dict(split), kernel_event_s=event_s,
         kernel_event_ms_a_launch=ms, kernels_event_s=kernels_s,
         kernels_event_share_of_wall=kernels_s / wall,
         # the wall outside the chunk's one wait on the device (the fetch)
         host_share_of_wall=1.0 - split["fetch"] / wall,
         samples=n_samples, symbols=n_syms, bits=n_bits,
         symbol_slots_a_launch=slots,
         # the Gardner scan's next-sample chain, 17 counted operations a
         # slot (computed, not measured; float64: at the measured latency)
         gardner_manchester_scan_chain_bound_ms=chain_bound_ms(
             slots, GM_SLOT_CHAIN_OPS, cycles),
         **({"pll_scan_f64_chain_bound_ms": chain_bound_ms(
             mode.chunk_size, PLL_CHAIN_OPS, cycles)} if argos else {}),
         framer_bits_per_s=n_bits / split["framer"] if split["framer"]
         else None,
         progress_line=progress, stdout_tail=so.getvalue()[-200:],
         card=card_line(), **check)
    return counts


# operations a step of each ablation variant, counted from
# csrc/ablate_kernel.cu and csrc/ablate_fused.cu (sinf/cosf one each;
# register shifts free): ablate_kernel per variant, ablate_fused per stage
# when on and when stubbed
ABLATE_KERNEL_OPS = {"empty_c1": 1, "empty_c8": 8, "empty_c73": 73,
                     "mac26": 52, "mac78": 156, "pll": 40, "ring16": 33,
                     "store3": 4}
ABLATE_FUSED_OPS = {"pll": (40, 6), "fir": (2 * 78 + 8 * 3, 4),
                    "ring": (0, 32), "gm": (3 * 32 + 30, 1), "store": (0, 0)}
# csrc/ablate_fused.cu's staged kernel: its stages' loop-carried chains a
# step as (dependent operations, dependent
# shared-memory loads) when on and when stubbed: the PLL 18 or 1; the AGC
# three gains, 3 x AGC_CHAIN_OPS, or the gain's 1; the rings 0 (their
# reads are Gardner's) or 1; Gardner's next_sample 15 and a load (rintf,
# float->int, the clamp at 0, the age's subtract and clamps, the row
# address; the load of the value ring; subtract, two multiplies, two
# clamps, subtract, add, select) or 1; the stores 0.  Each stage runs on
# its own warp, so a step costs the longest chain
ABLATE_FUSED_STAGE_CHAINS = {
    "pll": ((PLL_F64_SERIAL_CHAIN_OPS, 0), (1, 0)),
    "fir": ((3 * AGC_CHAIN_OPS, 0), (1, 0)), "ring": ((0, 0), (1, 0)),
    "gm": ((15, 1), (1, 0)), "store": ((0, 0), (0, 0))}
# csrc/ablate_kernel.cu's staged kernel: each variant's loop-carried chain
# a step as (dependent operations, dependent shared-memory loads):
# empty_c* 1 (each carried value's add, the values independent, spread
# over warps); mac26, mac78 2 a multiply-add (-fmad=false: a multiply, then
# an add; x is read from a staged row off the chain); pll 18, the PLL
# step's (PLL_F64_SERIAL_CHAIN_OPS: the phase update and the lock signal
# that feeds back through `locked`; sincosf and the division not counted;
# the sample's own terms are on the B warps); ring16 3 (the ring in
# registers: the newest value enters the last select, so a step costs that
# select and the add, but an older one comes through the tree's four
# selects, the last one and the add: six over two steps); store3 0 (no
# carried value changes)
ABLATE_KERNEL_CHAIN_OPS = {"empty_c1": (1, 0), "empty_c8": (1, 0),
                           "empty_c73": (1, 0), "mac26": (52, 0),
                           "mac78": (156, 0),
                           "pll": (PLL_F64_SERIAL_CHAIN_OPS, 0),
                           "ring16": (3, 0), "store3": (0, 0)}
# dependent operations a step on each variant's longest loop-carried chain on
# the serial kernels.  ablate_kernel_serial: as the staged kernel's but ring16
# 17 (the newest value through the 16 compare-selects of the read, then the
# add; the shift is register renaming); its global load of x a step, off these
# counts, lies on every chain that reads x.  ablate_fused, per stage on and
# stubbed: the PLL 18 or 1; the FIR stage's three AGC gains 3 x AGC_CHAIN_OPS
# or the gain's 1; the rings 0 (a shift) or 1; Gardner's next_sample 31 (rintf,
# float->int, the clamp at 0, the age's subtract and clamps, the 16
# compare-selects of the ring read, subtract, two multiplies, two clamps,
# subtract, add, select) or 1; the stores 0.  The stages' chains are
# independent recurrences, so a variant's is the longest of them.  The chain
# bound is computed at the measured float add latency, not measured: on the
# ablation_chain lines, not in the table.  (The serial kernel,
# ablate_fused_serial, runs these chains; ABLATE_FUSED_STAGE_CHAINS counts the
# staged kernel's.)
ABLATE_KERNEL_SERIAL_CHAIN_OPS = dict(
    {v: ops for v, (ops, _) in ABLATE_KERNEL_CHAIN_OPS.items()}, ring16=17)
ABLATE_FUSED_CHAIN_OPS = {"pll": (PLL_F64_SERIAL_CHAIN_OPS, 1),
                          "fir": (3 * AGC_CHAIN_OPS, 1), "ring": (0, 1),
                          "gm": (31, 1), "store": (0, 0)}


def ablation_chain_ops(tool, name: str) -> int:
    """A variant's counted chain a step on its serial kernel
    (ABLATE_KERNEL_SERIAL_CHAIN_OPS, ABLATE_FUSED_CHAIN_OPS)."""
    if tool.__name__.endswith("ablate_kernel"):
        return ABLATE_KERNEL_SERIAL_CHAIN_OPS[name]
    flags = tool.VARIANTS[name]
    return max(on if s in flags else off
               for s, (on, off) in ABLATE_FUSED_CHAIN_OPS.items())


def staged_cycles(tool, name: str) -> float:
    """Cycles a step on a variant's chain on the staged kernel of either
    tool, at the measured float add and dependent ld.shared latencies:
    ablate_kernel's (ABLATE_KERNEL_CHAIN_OPS), ablate_fused's longest
    stage's (staged_chain_cycles)."""
    if tool.__name__.endswith("ablate_fused"):
        return max(staged_chain_cycles(tool.VARIANTS[name]).values())
    ops, loads = ABLATE_KERNEL_CHAIN_OPS[name]
    return (ops * LATENCY_CYCLES["f32_add"]
            + loads * LATENCY_CYCLES["ld_shared"])


def staged_chain_cycles(flags) -> dict:
    """Cycles a step on each stage's chain of the staged ablate_fused
    kernel for a variant's flags, at the measured float add and dependent
    ld.shared latencies (ABLATE_FUSED_STAGE_CHAINS)."""
    out = {}
    for stage, (on, off) in ABLATE_FUSED_STAGE_CHAINS.items():
        ops, loads = on if stage in flags else off
        out[stage] = (ops * LATENCY_CYCLES["f32_add"]
                      + loads * LATENCY_CYCLES["ld_shared"])
    return out


def ablation_bound(tool, name: str, steps: int, B: int) -> dict:
    """Bytes and operations of one run of a variant: each input plane read
    once, each stored plane written once, the carry read and written."""
    if tool.__name__.endswith("ablate_kernel"):
        v = tool.VARIANTS[name]
        # the empty variants read no plane: the plain version and both
        # kernels leave x unread
        planes_in = 0 if name.startswith("empty") else v.n_in
        n_bytes = (steps * B * 4.0 * (planes_in + v.n_out)
                   + 2 * v.n_carry * B * 4.0)
        ops = ABLATE_KERNEL_OPS[name]
    else:
        flags = tool.VARIANTS[name]
        # re and tn always, im only where the PLL reads it
        planes_in = 2 + ("pll" in flags)
        rows = 3 if "store" in flags else 3.0 / 1024
        n_bytes = steps * B * 4.0 * (planes_in + rows) + 2 * 73 * B * 4.0
        ops = sum(on if s in flags else off
                  for s, (on, off) in ABLATE_FUSED_OPS.items())
    return bound(n_bytes, steps * B * float(ops))


def phase_ablation(stats: dict) -> dict:
    """The two ablation tools: every variant's kernel against its plain
    version and its serial twin bit for bit over 512 steps at each lane
    count of ABLATION_S (ablate_kernel also on seeded varied inputs there
    and at ABLATION_PART_LANES), then each tool's CLI (its ``main``) on the
    card at those lane counts, as a main path whose launches are counted;
    one ``ablation`` line a variant and lane count.  Returns {tool:
    launches}."""
    import torch
    from project_desert_tortoise_tpu_torch.tools import ablate_fused as AF
    from project_desert_tortoise_tpu_torch.tools import ablate_kernel as AK

    dev = torch.device("cuda")
    steps, window = ABLATION_CHECK
    checks = {}
    for S in ABLATION_S:
        xs, state = AF.inputs(steps, S, dev)
        for name in AK.VARIANTS:
            ins, st = AK.inputs(name, steps, S, dev)
            checks["ablate_kernel", name, S] = time_pair(
                "ablate_kernel", f"{name}, {S * 128} lanes",
                lambda: AK.ablate_kernel(name, ins, st, window),
                lambda: AK.ablate_kernel_ref(name, ins, st, window),
                [S * AK.LANES, steps], {})
            check_equal(AK.ablate_kernel(name, ins, st, window),
                        AK.ablate_kernel_serial(name, ins, st, window),
                        f"ablate_kernel {name}, {S * 128} lanes, vs serial")
        for name in AF.VARIANTS:
            checks["ablate_fused", name, S] = time_pair(
                "ablate_fused", f"{name}, {S * 128} lanes",
                lambda: AF.ablate_fused(name, *xs, state, window),
                lambda: AF.ablate_fused_ref(name, *xs, state, window),
                [S * AF.LANES, steps], {})
            check_equal(AF.ablate_fused(name, *xs, state, window),
                        AF.ablate_fused_serial(name, *xs, state, window),
                        f"ablate_fused {name}, {S * 128} lanes, vs serial")
        del xs, state
    for lanes in sorted({S * AK.LANES for S in ABLATION_S}
                        | set(ABLATION_PART_LANES)):
        for name in AK.VARIANTS:
            ins, st = AK.varied_inputs(name, steps, lanes, seed=lanes,
                                       device=dev)
            want = AK.ablate_kernel_ref(name, ins, st, window)
            what = f"ablate_kernel {name}, {lanes} varied lanes"
            check_equal(AK.ablate_kernel(name, ins, st, window), want, what)
            check_equal(AK.ablate_kernel_serial(name, ins, st, window), want,
                        what + ", serial")
        emit("ablate_kernel_varied", lanes=lanes, steps=steps,
             variants=len(AK.VARIANTS), bit_exact=True)

    launches = collections.Counter()
    ns = {}
    for s in ABLATION_S:
        for tool in (AK, AF):
            tname = tool.__name__.rsplit(".", 1)[1]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc, counts = drive(tname, lambda: tool.main(["--s", str(s)]))
            if rc != 0:
                raise AssertionError(f"{tname} --s {s} exited {rc}")
            launches.update(counts)
            for line in buf.getvalue().splitlines():
                m = re.match(r"(\S+)\s+S=(\d+)\s.*?([0-9.]+) ns/step$", line)
                if not m:
                    raise AssertionError(f"{tname}: unparsed line {line!r}")
                ns[tname, m.group(1), s] = float(m.group(3))
                emit("ablation", tool=tname, variant=m.group(1), S=s,
                     lanes=s * 128, ns_per_step=float(m.group(3)),
                     card=card_line())
            if sorted(v for t, v, ss in ns if t == tname and ss == s) != \
                    sorted(tool.VARIANTS):
                raise AssertionError(f"{tname} --s {s}: variants missing")
        torch.cuda.empty_cache()

    # per tool: the time of one run of every variant at the widest lane
    # count and the tool's default steps, beside the sum of their bounds;
    # the plain versions at the check shape of that lane count
    default_steps = {"ablate_kernel": 131072, "ablate_fused": 118784}
    s_max = max(ABLATION_S)
    cycles = LATENCY_CYCLES["f32_add"]
    for tool in (AK, AF):
        tname = tool.__name__.rsplit(".", 1)[1]
        L, B = default_steps[tname], s_max * 128
        bounds = [ablation_bound(tool, v, L, B) for v in tool.VARIANTS]
        # every lane's chain runs beside the others' (one chain warp an SM
        # at s_max): a run's chain bound is one lane's.  The staged
        # kernels' own chains (ablate_fused: the longest stage's) a step,
        # and the serial twins' counted ones
        ops = {v: ablation_chain_ops(tool, v) for v in tool.VARIANTS}
        staged = {v: staged_cycles(tool, v) for v in tool.VARIANTS}
        chain = {v: chain_bound_ms(L, 1, c) for v, c in staged.items()}
        variant_ms = {v: ns[tname, v, s_max] * L * 1e-6
                      for v in tool.VARIANTS}
        serial_ms = (ablation_vs_serial if tool is AF
                     else ablate_kernel_vs_serial)(L, s_max, stats)
        emit("ablation_chain", tool=tname, S=s_max, steps=L,
             chain_bound_ms=chain, chain_bound_ms_sum=sum(chain.values()),
             ms=variant_ms, ms_sum=sum(variant_ms.values()),
             share_of_chain_bound={v: chain[v] / variant_ms[v]
                                   for v in tool.VARIANTS},
             chain_cycles_a_step=staged, f32_add_cycles=cycles,
             serial_chain_ops_a_step=ops,
             serial_chain_bound_ms={v: chain_bound_ms(L, k, cycles)
                                    for v, k in ops.items()},
             serial_ms=serial_ms, serial_ms_sum=sum(serial_ms.values()),
             speedup={v: serial_ms[v] / variant_ms[v]
                      for v in tool.VARIANTS}, card=card_line())
        by = collections.Counter()
        for b in bounds:
            by[b["bound_by"]] += b["bound_ms"]
        stats[tname] = dict(
            ms=sum(ns[tname, v, s_max] * L * 1e-6 for v in tool.VARIANTS),
            shape=[B, L], variants=len(tool.VARIANTS),
            ns_per_step={str(s): {v: ns[tname, v, s] for v in tool.VARIANTS}
                         for s in ABLATION_S},
            bound_ms=sum(b["bound_ms"] for b in bounds),
            bound_by=by.most_common(1)[0][0],
            plain_ms=sum(checks[tname, v, s_max][1] for v in tool.VARIANTS),
            plain_shape=[B, steps],
            check_ms=sum(checks[tname, v, s_max][0] for v in tool.VARIANTS),
            max_abs_err=max(checks[k][2] for k in checks if k[0] == tname))
    for twin in ("ablate_kernel", "ablate_fused"):
        for f in ("bound_ms", "bound_by", "plain_ms", "plain_shape"):
            stats[twin + "_serial"][f] = stats[twin][f]
    return launches


def ablate_kernel_vs_serial(L: int, S: int, stats: dict) -> dict:
    """The staged ablate_kernel kernel against its serial twin at S x 128
    lanes and L steps (the tool's inputs and window), every variant bit for
    bit, both timed in this run in turns (serial, staged, staged, serial);
    one `ablation_vs_serial` line a variant and one `design` line (the
    launch configuration the card reports a variant, the chain cycles a
    step).  Returns {variant: the twin's ms}."""
    import torch
    from project_desert_tortoise_tpu_torch.tools import ablate_kernel as AK

    dev = torch.device("cuda")
    window = 1024
    B = S * AK.LANES
    ms, serial_ms, configs = {}, {}, {}
    for name in AK.VARIANTS:
        ins, state = AK.inputs(name, L, S, dev)
        ms[name], serial_ms[name], got, want = old_new_ms(
            lambda: AK.ablate_kernel(name, ins, state, window),
            lambda: AK.ablate_kernel_serial(name, ins, state, window),
            reps=1)
        check_equal(got, want, f"ablate_kernel {name} vs serial, {B} x {L}")
        configs[name] = dict(AK.ablate_kernel_launch_config(name),
                             chain_cycles_a_step=staged_cycles(AK, name))
        emit("ablation_vs_serial", tool="ablate_kernel", variant=name,
             shape=[B, L], bit_exact=True, ms=ms[name],
             serial_ms=serial_ms[name], ns_per_step=ms[name] * 1e6 / L,
             serial_ns_per_step=serial_ms[name] * 1e6 / L,
             speedup=serial_ms[name] / ms[name], card=card_line())
        del ins, state, got, want
    emit("design", mode="ablate_kernel, staged", shape=[B, L],
         ctas=-(-B // AK.CTA_LANES), chunk_steps=AK.CHUNK_STEPS,
         warp_roles={name: dict(
             chain=[w for w in range(32) if c["chain_warp_mask"] >> w & 1],
             b_terms=[w for w in range(32) if c["b_warp_mask"] >> w & 1],
             loader=c["loader_warp"]) for name, c in configs.items()},
         latency_cycles=dict(LATENCY_CYCLES), variants=configs, ms=ms,
         serial_ms=serial_ms, card=card_line())
    stats["ablate_kernel_serial"] = dict(
        ms=sum(serial_ms.values()), shape=[B, L], variants=len(ms),
        staged_ms=sum(ms.values()), max_abs_err=0.0)
    torch.cuda.empty_cache()
    return serial_ms


def ablation_vs_serial(L: int, S: int, stats: dict) -> dict:
    """The staged ablate_fused kernel against its serial twin at S x 128
    lanes and L steps (the tool's inputs and window), every variant bit for
    bit, both timed in this run in turns (serial, staged, staged, serial);
    one `ablation_vs_serial` line a variant and one `design` line (the
    launch configuration the card reports a variant, the stages' chain
    cycles a step).  Returns {variant: the twin's ms}."""
    import torch
    from project_desert_tortoise_tpu_torch.tools import ablate_fused as AF

    dev = torch.device("cuda")
    window = 1024
    xs, state = AF.inputs(L, S, dev)
    B = S * AF.LANES
    out_new, out_old = (AF.output_buffers(L, B, dev) for _ in range(2))
    ms, serial_ms, configs = {}, {}, {}
    for name in AF.VARIANTS:
        for o in (out_new, out_old):
            o[0].zero_()
        ms[name], serial_ms[name], got, want = old_new_ms(
            lambda: AF.ablate_fused(name, *xs, state, window, out_new),
            lambda: AF.ablate_fused_serial(name, *xs, state, window,
                                           out_old), reps=1)
        check_equal(got, want, f"ablate_fused {name} vs serial, {B} x {L}")
        configs[name] = dict(AF.ablate_fused_launch_config(name),
                             chain_cycles_a_step=staged_chain_cycles(
                                 AF.VARIANTS[name]))
        emit("ablation_vs_serial", tool="ablate_fused", variant=name,
             shape=[B, L], bit_exact=True, ms=ms[name],
             serial_ms=serial_ms[name], ns_per_step=ms[name] * 1e6 / L,
             serial_ns_per_step=serial_ms[name] * 1e6 / L,
             speedup=serial_ms[name] / ms[name], card=card_line())
    cfg = configs["full"]
    emit("design", mode="ablate_fused, staged", shape=[B, L],
         ctas=-(-B // AF.CTA_LANES), stage_warps=dict(
             pll=cfg["pll_warp"], agc=cfg["agc_warp"],
             gardner_manchester_stores=cfg["gardner_warp"],
             loader=cfg["loader_warp"],
             fir_and_pll_input_terms=[w for w in range(32)
                                      if cfg["fir_warp_mask"] >> w & 1]),
         latency_cycles=dict(LATENCY_CYCLES), variants=configs, ms=ms,
         serial_ms=serial_ms, card=card_line())
    stats["ablate_fused_serial"] = dict(
        ms=sum(serial_ms.values()), shape=[B, L], variants=len(ms),
        staged_ms=sum(ms.values()), max_abs_err=0.0)
    del xs, state, out_new, out_old
    torch.cuda.empty_cache()
    return serial_ms


# ---------------------------------------------------------------------------
# Streaming and serving: ChannelBank, demodulate_many, demod_serve,
# demod_realtime, checkpoints


SERVE_CHANNELS = 256
SERVE_RECORDINGS = 32                     # each on SERVE_CHANNELS / 32
SERVE_SAMPLES = 1_228_800                 # 12 cores of the default plan
SERVE_FRAMES = 242                        # 24.6 s of minor frames
# extra frames may come only from the acquisition of the lead-in frame
# (0.3 s of noise, then the lead-in at 0.3-0.4 s; fault (e)): a corrupted
# lead-in, or a sync found in the noise before it
SERVE_LEAD_END_S = 0.4
# what the JAX package misses of each recording's payloads, by recording:
# the carriers within ~250-700 Hz lose the first block's frames (fault
# (h)); the same on its fast path's XLA branch (demodulate_many, the
# default plan) and its fused branch (its ChannelBank, use_pallas="fused",
# 128-lane batches).  And what else each branch decodes after the lead-in
# (from SERVE_LEAD_END_S on), by payload_digest.  Every channel of the
# bank is held to its recording's entries, each branch to JAX's same
# branch; tests/test_torch_serving_pass.py recomputes them
SERVE_REFERENCE_MISSED = {
    12: (0,),
    13: (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11),
    14: (0, 1, 2),
    17: (0, 1, 2),
    18: (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11),
    19: (0,),
}
SERVE_REFERENCE_LATE = {
    False: {
        12: ("078b8d50bb9c5881", "6ecba145fd2091de"),
        14: ("f0323dc895f264c9",),
        18: ("2bf9a21b606b8d1f",),
        19: ("645f155aa9ddc47c",),
    },
    "fused": {
        10: ("35b2ff8ca1920336",),
        12: ("5f853717fa65932f", "90cb6fec7e47e896"),
        14: ("f0323dc895f264c9",),
        18: ("e858175aa5e44205",),
        19: ("645f155aa9ddc47c",),
    },
}
SERVE_CHUNK = 25_000
SERVE_PRODUCERS = 4
SERVE_ENTRY = {"fused_demod": "pdt_fused_demod", "pll_scan": "pdt_pll_scan",
               "agc_scan": "pdt_agc_scan",
               "gardner_manchester": "pdt_gardner_manchester"}
RT_FS = 48000.0
RT_FRAMES = 296                           # 30 s of poes_tip_realtime
# stdin and the followed file are fed faster than real time, at a pace the
# consumer keeps up with (the ring holds 5.5 s of exact-chain input)
RT_PACE = {"exact": 4.0, "fast": 8.0}


def serve_carrier_hz(r: int) -> float:
    """Recording r's carrier offset: the recordings spread evenly over
    -3..+3 kHz.  At offsets of ~250-700 Hz either way the fast path's
    carrier warm start (coarse_carrier_est) fails and loses up to the
    first 1.2 s of frames, in the JAX package as in the port (ROADMAP
    fault (h)); SERVE_REFERENCE_MISSED holds what JAX misses."""
    return -3000.0 + 6000.0 * r / (SERVE_RECORDINGS - 1)


def serving_recordings():
    """SERVE_RECORDINGS synthetic POES recordings (one seed and carrier
    each, serve_carrier_hz) as int16 planes; returns (re, im) (R, N)
    int16, each recording's payloads and lead-in payload."""
    from project_desert_tortoise_tpu_torch.utils import synth

    t0 = time.time()
    R = SERVE_RECORDINGS
    re = np.empty((R, SERVE_SAMPLES), np.int16)
    im = np.empty((R, SERVE_SAMPLES), np.int16)
    want, lead = [], []
    for r in range(R):
        iq, frames = synth.make_poes_recording(
            n_frames=SERVE_FRAMES, fs=POES_FS,
            carrier_hz=serve_carrier_hz(r),
            rng=np.random.default_rng(1000 + r))
        iq = iq[:SERVE_SAMPLES] / (np.abs(iq).max() * 1.2)
        re[r], im[r] = to_int16(iq.real), to_int16(iq.imag)
        want.append([bytes(f) for f in frames[1:]])
        lead.append(bytes(frames[0]))
    emit("serving_synth", recordings=R, samples=SERVE_SAMPLES,
         payloads_each=SERVE_FRAMES - 1, seconds=time.time() - t0)
    return re, im, want, lead


def bank_run(planes, br, recs, stage_dtype):
    """A ChannelBank on the card fed by SERVE_PRODUCERS threads in
    SERVE_CHUNK pushes (channel ci from recording recs[ci]; int16 pushed
    raw, or as float32 PCM values), pumped on this thread until every
    producer is done, then drained.  Returns (bank, wall seconds)."""
    from project_desert_tortoise_tpu_torch.parallel.serving import ChannelBank
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP
    import threading

    re, im = planes
    n_channels = len(recs)
    bank = ChannelBank(POES_TIP, POES_FS, n_channels, batch_blocks=128,
                       use_pallas=br, stage_dtype=stage_dtype,
                       device="cuda")
    cast = ((lambda x: x) if stage_dtype == np.int16 else
            (lambda x: x.astype(np.float32) / np.float32(32768.0)))

    def produce(k):
        mine = range(k, n_channels, SERVE_PRODUCERS)
        for lo in range(0, SERVE_SAMPLES, SERVE_CHUNK):
            for ci in mine:
                r = recs[ci]
                bank.push(ci, cast(re[r, lo:lo + SERVE_CHUNK]),
                          cast(im[r, lo:lo + SERVE_CHUNK]))
        for ci in mine:
            bank.end_of_stream(ci)
    t0 = time.time()
    threads = [threading.Thread(target=produce, args=(k,))
               for k in range(SERVE_PRODUCERS)]
    for th in threads:
        th.start()
    while any(th.is_alive() for th in threads):
        if bank.pump() == 0:
            time.sleep(0.001)
    for th in threads:
        th.join()
    bank.drain()
    return bank, time.time() - t0


def frame_lines(frames):
    """The lines FrameWriter writes for a POES mode (inverted frames
    marked), without the trailing newline."""
    return [f"{f.time:.5f}" + ("i" if f.inverted else "") + " "
            + "".join(f"{b:02X} " for b in f.data) for f in frames]


def serving_bound(name: str, params, B: int, L: int, in_bytes: int) -> dict:
    """The bound of one launch at the serving batch shape (B, L), as the
    other phases count it: bytes each input read once and each output
    written once, operations counted from the sources; Gardner's symbols
    all the slots the rows' samples hold (silent rows included)."""
    interp = params.interp
    if name == "fused_demod":
        ops = 40.0 + 2 * len(params.taps) + 8 * interp + 20
        return bound(B * L * (2.0 * in_bytes + 8.0), B * L * ops)
    if name == "pll_scan":
        return bound(B * L * 16.0, B * L * 40.0)
    if name == "agc_scan":
        return bound(B * L * interp * 8.0, B * L * interp * 8.0)
    n_sym = B * L * interp / params.step_size
    return bound(n_sym * 12.0 + n_sym * 6.0, n_sym * 30.0)


def payload_digest(payload: bytes) -> str:
    """A frame's payload as SERVE_REFERENCE_LATE pins it."""
    import hashlib
    return hashlib.sha256(payload).hexdigest()[:16]


def serving_channel_check(frames, want, lead, r, br):
    """One channel's frames on branch br against its recording r: each
    payload once but those JAX misses (SERVE_REFERENCE_MISSED), and past
    the lead-in (SERVE_LEAD_END_S) nothing else but what JAX's same branch
    decodes there (SERVE_REFERENCE_LATE).  Returns (missed, repeated, late
    extras' digests, the channel's extra frames' times, whether it
    holds)."""
    got = [bytes(f.data) for f in frames]
    missed, _, repeated = payload_diff(got, want, lead)
    known = set(want) | {lead}
    odd = [f for f in frames if bytes(f.data) not in known]
    late = sorted(payload_digest(bytes(f.data)) for f in odd
                  if f.time >= SERVE_LEAD_END_S)
    ok = (tuple(missed) == SERVE_REFERENCE_MISSED.get(r, ()) and
          not repeated and
          tuple(late) == SERVE_REFERENCE_LATE[br].get(r, ()))
    return missed, repeated, late, [f"{f.time:.5f}" for f in odd], ok


def serving_check_channels():
    """The channels the finer checks take (float32 staging, the fused
    branch against demodulate_blocked): the first four, and the first
    channel of each of the four recordings JAX misses most of (channel r
    carries recording r for r < SERVE_RECORDINGS)."""
    worst = sorted(SERVE_REFERENCE_MISSED,
                   key=lambda r: -len(SERVE_REFERENCE_MISSED[r]))[:4]
    return [0, 1, 2, 3] + sorted(worst)


def padded_batch(silent, batch):
    """The batch a bank run kept (demod_frames' planes, lo, stream
    lengths, estimate and norm; `silent` of its rows silent): as it is
    where it has silent rows, else with its last 32 rows made silent as
    _stage makes them (zero samples, lo 0, length 0) and the estimate
    taken anew."""
    from project_desert_tortoise_tpu_torch.parallel import blocked
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

    if silent:
        return batch
    zre, zim, lo, n, fest, norm = batch
    zre, zim, lo, n = (x.clone() for x in (zre, zim, lo, n))
    for x in (zre, zim, lo, n):
        x[-32:] = 0
    fest = blocked.coarse_carrier_est(zre, zim, POES_FS,
                                      POES_TIP.gardner.baud / 2.0)
    return zre, zim, lo, n, fest, norm


def phase_serving(stats: dict):
    """ChannelBank at full width: SERVE_CHANNELS channels of SERVE_SAMPLES
    int16 samples, 128-lane batches, producer threads pushing while this
    thread pumps; once on the fused branch and once on the scan branch
    (False).  Every channel is held to its recording's reference
    (serving_channel_check) on both; on the scan branch every channel's
    lines are demodulate_many's over the same planes; on the fused branch
    the check channels' (serving_check_channels) are demodulate_blocked's
    (fused, the bank's norm); int16 and float32 staging give the same
    lines on the check channels.  Each kernel launch of the bank runs is
    bracketed by CUDA events (common.launch_events).  Then each branch's
    kernels against their plain versions, bit for bit, on the first
    MAIN_CHECK_L samples of the batch the bank staged that mixes blocks
    and silent rows most evenly (padded_batch), with the inputs
    demod_blocks gives them.  Returns ({kernel: launches}, the planes, the
    scan branch's lines of the first 16 channels, the fused branch's)."""
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops import agc, clock, fir
    from project_desert_tortoise_tpu_torch.ops import manchester as man
    from project_desert_tortoise_tpu_torch.ops.kernels import common
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
        fused_demod, fused_demod_ref)
    from project_desert_tortoise_tpu_torch.ops.pll import pll_scan_ref
    from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
        pll_scan_kernel)
    from project_desert_tortoise_tpu_torch.parallel import blocked
    from project_desert_tortoise_tpu_torch.parallel.serving import ChannelBank
    from project_desert_tortoise_tpu_torch.utils import wav as W
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

    re, im, want, lead = serving_recordings()
    R, C = SERVE_RECORDINGS, SERVE_CHANNELS
    recs = [ci % R for ci in range(C)]
    params = chain.make_params(POES_TIP, POES_FS)
    plan = blocked.default_plan(POES_TIP, POES_FS)
    launches = collections.Counter()
    lines = {}
    captured = {}
    problems = []
    real_demod_frames = blocked.demod_frames
    real_stage = ChannelBank._stage
    staged_rows = []

    def stage(bank, rows):
        staged_rows.append(len(rows))
        return real_stage(bank, rows)

    def capture(*a, **k):
        # keep the batch that mixes blocks and silent rows most evenly (its
        # planes, lo, stream lengths, estimate and norm), its rows counted
        # on the host, so that the run does not wait for it
        silent = a[4].shape[0] - staged_rows[-1]
        mix = min(silent, staged_rows[-1])
        if a[11] not in captured or mix > captured[a[11]][0]:
            captured[a[11]] = (mix, silent,
                               (a[4], a[5], a[6], a[7], a[8], a[9]))
        return real_demod_frames(*a, **k)

    for br in ("fused", False):
        events = {}
        with patched(common, "launch_events", events), \
                patched(blocked, "demod_frames", capture), \
                patched(ChannelBank, "_stage", stage):
            (bank, wall), counts = drive(
                br, lambda: bank_run((re, im), br, recs, np.int16))
        launches.update(counts)
        torch.cuda.synchronize()
        lines[br] = [frame_lines(f) for f in bank.frames]
        missed, repeated, bad, extra = collections.Counter(), 0, {}, {}
        as_reference = 0
        for ci in range(C):
            m, rep, late, odd, ok = serving_channel_check(
                bank.frames[ci], want[recs[ci]], lead[recs[ci]], recs[ci],
                br)
            missed.update(m)
            repeated += len(rep)
            as_reference += ok
            if odd:
                extra[ci] = odd
            if not ok:
                bad[ci] = dict(recording=recs[ci], missed=m[:16],
                               repeated=rep[:8], late_extra=late[:4])
        if bad:
            problems.append(f"serving {br}: {len(bad)} channels unlike "
                            "their recording's reference "
                            f"{dict(list(bad.items())[:6])}")
        ms = sorted(bank.batch_ms)
        kernel_ms = {}
        for k in PATH_KERNELS[br]:
            pairs = events.get(SERVE_ENTRY[k], [])
            if len(pairs) != counts[k]:
                raise AssertionError(f"serving {br}: {len(pairs)} timed "
                                     f"launches of {k}, {counts[k]} counted")
            kernel_ms[k] = sum(a.elapsed_time(b) for a, b in pairs) / len(
                pairs)
            in_bytes = 2 if k in ("fused_demod", "pll_scan") else 4
            stats[k].setdefault("serving", {}).update(
                ms=kernel_ms[k], shape=[128, plan.total],
                launches_serving=counts[k], **serving_bound(
                    k, params, 128, plan.total, in_bytes))
        emit("serving", use_pallas=br, channels=C, samples_each=SERVE_SAMPLES,
             stage="int16", batch_blocks=128, producers=SERVE_PRODUCERS,
             wall_s=wall, msamples_per_s=C * SERVE_SAMPLES / wall / 1e6,
             blocks=bank.blocks, batches=bank.batches,
             batch_dispatch_to_collect_ms_p50=ms[len(ms) // 2],
             batch_dispatch_to_collect_ms_p99=ms[min(len(ms) - 1,
                                                     int(0.99 * len(ms)))],
             kernel_ms_a_batch=kernel_ms,
             kernels_ms_a_batch=sum(kernel_ms.values()),
             frames=sum(map(len, bank.frames)), payloads_once=C * (
                 SERVE_FRAMES - 1) - sum(missed.values()) - repeated,
             of=C * (SERVE_FRAMES - 1),
             payloads_missed=sum(missed.values()),
             reference_missed=sum(len(SERVE_REFERENCE_MISSED.get(r, ()))
                                  for r in recs),
             channels_as_reference=as_reference,
             extra_frames={ci: v for ci, v in list(extra.items())[:8]},
             channels_with_extra_frames=len(extra),
             launches=counts, norm=bank.norm,
             card=card_line())
        if br == "fused":
            fused_norm = bank.norm
        del bank

    # the scan branch against demodulate_many over the same planes
    t = W.time_axis(SERVE_SAMPLES, POES_FS, np.float32)
    s = np.float32(1.0 / 32768.0)
    iqs = np.empty((C, SERVE_SAMPLES), np.complex64)
    for ci in range(C):
        iqs[ci].real = re[recs[ci]] * s
        iqs[ci].imag = im[recs[ci]] * s
    t0 = time.time()
    many, counts = drive(False, lambda: blocked.demodulate_many(
        iqs, t, POES_FS, POES_TIP, batch_blocks=128, device="cuda"))
    many_s = time.time() - t0
    launches.update(counts)
    differ = [ci for ci in range(C)
              if frame_lines(many[ci]) != lines[False][ci]]
    many_differ = len(differ)
    if differ:
        ci = differ[0]
        a, b = frame_lines(many[ci]), lines[False][ci]
        problems.append(f"serving False: {len(differ)} channels' lines "
                        f"differ from demodulate_many's {differ[:10]}; "
                        f"channel {ci}: {len(b)} lines against {len(a)}, "
                        f"only the bank's {sorted(set(b) - set(a))[:2]}, "
                        "only demodulate_many's "
                        f"{sorted(set(a) - set(b))[:2]}")
    del many
    # the fused branch's check channels against demodulate_blocked
    check = serving_check_channels()
    t0 = time.time()
    offline, counts = drive("fused", lambda: [blocked.demodulate_blocked(
        iqs[ci], t, POES_FS, POES_TIP, norm_factor=fused_norm,
        use_pallas="fused", device="cuda") for ci in check])
    blocked_s = time.time() - t0
    launches.update(counts)
    differ = [ci for ci, f in zip(check, offline)
              if frame_lines(f) != lines["fused"][ci]]
    if differ:
        ci = differ[0]
        a = frame_lines(offline[check.index(ci)])
        b = lines["fused"][ci]
        problems.append(f"serving fused: channels {differ} differ from "
                        f"demodulate_blocked's lines; channel {ci}: {len(b)} "
                        f"lines against {len(a)}, only the bank's "
                        f"{sorted(set(b) - set(a))[:2]}, only "
                        f"demodulate_blocked's {sorted(set(a) - set(b))[:2]}")
    del iqs
    # float32 staging of the check channels against int16's
    (bank32, wall32), counts = drive(
        False, lambda: bank_run((re, im), False, [recs[ci] for ci in check],
                                np.float32))
    launches.update(counts)
    f32_equal = ([frame_lines(f) for f in bank32.frames] ==
                 [lines[False][ci] for ci in check])
    if not f32_equal:
        problems.append("serving: float32 staging's lines differ from "
                        "int16 staging's")

    # each branch's kernels on a batch the bank staged, silent rows in it
    L = MAIN_CHECK_L
    shift = 1 if params.interp > 1 else 0
    zre, zim, lo, n_rows, fest, norm = padded_batch(*captured["fused"][1:])
    B = int(zre.shape[0])
    silent = {"fused": int((n_rows == 0).sum())}
    pst, gain0 = blocked.warm_state(params, fest, POES_FS, norm)
    seed, pad0 = blocked.position_seeds(lo, shift)
    z = (zre[:, :L].contiguous(), zim[:, :L].contiguous())
    time_pair("fused_demod", "serving batch, int16, time generation, "
              f"{silent['fused']} silent rows",
              lambda: fused_demod(params, pst, gain0, z, None, seed, pad0,
                                  1.0),
              lambda: fused_demod_ref(params, pst, gain0, z, None, seed,
                                      pad0, 1.0), [B, L], stats)
    zre, zim, lo, n_rows, fest, norm = padded_batch(*captured[False][1:])
    del captured
    B = int(zre.shape[0])
    silent["False"] = int((n_rows == 0).sum())
    case = f"serving batch, int16 planes, {silent['False']} silent rows"
    pst, gain0 = blocked.warm_state(params, fest, POES_FS, norm)
    z = tuple(x[:, :L].to(torch.float32) * (1.0 / 32768.0) for x in
              (zre, zim))
    time_pair("pll_scan", case,
              lambda: pll_scan_kernel(params.pll, pst, z),
              lambda: pll_scan_ref(params.pll, pst, *z), [B, L], stats)
    # the AGC's and Gardner's inputs as demod_blocks makes them
    _, soft, lock = pll_scan_kernel(params.pll, pst, z)
    if params.squelch_position == "after_pll":
        soft = agc.squelch(soft, torch.abs(lock), params.squelch_threshold)
    x = fir.fir_interp(soft, params.taps, params.interp)
    ap = sk.AGCParams(params.agc_attack, params.agc_decay)
    time_pair("agc_scan", case, lambda: sk.agc_scan(gain0, x, ap),
              lambda: sk.agc_scan_ref(gain0, x, ap), list(x.shape), stats)
    _, y = sk.agc_scan(gain0, x, ap)
    if params.squelch_position == "after_agc":
        y = agc.squelch(y, torch.abs(lock), params.squelch_threshold)
    pos = blocked.sample_positions(lo, n_rows, plan.total, shift)[:, :L]
    t_out = (fir.fir_out_times(pos, params.interp) if params.interp > 1
             else pos.contiguous())
    cap = L * params.interp
    gp = sk.GardnerParams(params.step_size, params.gardner_err_limit,
                          params.gardner_gain, params.resync_threshold)
    lay = sk.layout(cap, 4096 * params.interp, params.step_size,
                    params.gardner_err_limit)
    g0 = clock.gardner_init((B,), device=zre.device)
    m0 = man.manchester_init((B,), device=zre.device)
    args = ((*g0, m0.cur, m0.prev, m0.prevprev), (m0.clockmod, m0.evenodd),
            y, t_out, torch.full((B,), cap, dtype=torch.int32,
                                 device=zre.device), gp, lay)
    time_pair("gardner_manchester", f"{case}, {lay.n_win} windows of "
              f"{lay.window}", lambda: sk.gardner_manchester(*args),
              lambda: sk.gardner_manchester_ref(*args), [B, cap], stats)
    emit("serving_checks", channels_as_demodulate_many=C - many_differ,
         of=C, demodulate_many_s=many_s, check_channels=check,
         check_channels_as_demodulate_blocked_fused=len(check) - len(differ),
         demodulate_blocked_s=blocked_s, f32_staging_lines_equal=f32_equal,
         f32_staging_wall_s=wall32, checked_batch_silent_rows=silent,
         checked_samples=L, problems=problems, card=card_line())
    if problems:
        raise AssertionError("; ".join(problems))
    return launches, (re, im), {br: v[:16] for br, v in lines.items()}


def write_int16_wav(path: str, re, im, fs: float):
    """A 2-channel 16-bit PCM WAV holding the int16 planes as they are."""
    import struct
    pcm = np.empty((len(re), 2), "<i2")
    pcm[:, 0], pcm[:, 1] = re, im
    body = pcm.tobytes()
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(body), b"WAVE",
                      b"fmt ", 16, 1, 2, int(fs), int(fs) * 4, 4, 16,
                      b"data", len(body))
    with open(path, "wb") as f:
        f.write(hdr + body)


def phase_demod_serve(workdir: str, planes, api_lines) -> dict:
    """The demod_serve CLI on 16 int16 WAVs (the serving phase's first 16
    channels): --use-pallas fused --batch-blocks 128, then --stage f32 on
    the scan branch; each output file's lines must be the API run's for
    that channel."""
    from project_desert_tortoise_tpu_torch.apps import demod_serve

    re, im = planes
    wavs = []
    for ci in range(len(api_lines[False])):
        wavs.append(os.path.join(workdir, f"serve{ci:02d}.wav"))
        write_int16_wav(wavs[-1], re[ci % len(re)], im[ci % len(im)],
                        POES_FS)
    launches = collections.Counter()
    for br, flags in (("fused", ["--use-pallas", "fused", "--batch-blocks",
                                 "128"]),
                      (False, ["--stage", "f32", "--batch-blocks", "128"])):
        out = os.path.join(workdir, f"serve_{br}")
        os.makedirs(out)
        so = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(so):
            rc, counts = drive(br, lambda: demod_serve.run(
                wavs + ["--out-dir", out] + flags))
        wall = time.time() - t0
        if rc != 0:
            raise AssertionError(f"demod_serve {flags} exited {rc}")
        launches.update(counts)
        for ci, wav in enumerate(wavs):
            base = os.path.splitext(os.path.basename(wav))[0]
            with open(os.path.join(out, f"frames_{ci}_{base}.txt")) as f:
                got = f.read().splitlines()
            if got != api_lines[br][ci]:
                raise AssertionError(f"demod_serve {flags}: channel {ci}'s "
                                     "file differs from the API run's lines")
        emit("demod_serve", flags=flags, channels=len(wavs), wall_s=wall,
             launches=counts, files_equal_api=len(wavs),
             stdout_tail=so.getvalue()[-200:], card=card_line())
    for wav in wavs:
        os.remove(wav)
    return launches


class PacedStdin:
    """A stand-in for sys.stdin whose .buffer gives `data` (interleaved
    float32 IQ) at `pace` times the real-time byte rate of `fs`."""

    def __init__(self, data: bytes, fs: float, pace: float):
        self.buffer = self
        self._data, self._pos = data, 0
        self._rate = fs * 8 * pace
        self._t0 = None

    def read(self, n: int) -> bytes:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        due = self._t0 + self._pos / self._rate
        time.sleep(max(0.0, due - time.perf_counter()))
        out = self._data[self._pos:self._pos + n]
        self._pos += len(out)
        return out


def realtime_cli(argv, stdin=None):
    """demod_realtime.run(argv) in this process (stdin replaced by
    `stdin`), its stdout and stderr captured; the SIGINT handler it sets
    is put back afterwards.  Returns (rc, stdout, stderr)."""
    import signal
    from project_desert_tortoise_tpu_torch.apps import demod_realtime

    so, se = io.StringIO(), io.StringIO()
    saved = signal.getsignal(signal.SIGINT)
    try:
        with contextlib.ExitStack() as stack:
            if stdin is not None:
                stack.enter_context(patched(sys, "stdin", stdin))
            stack.enter_context(contextlib.redirect_stdout(so))
            stack.enter_context(contextlib.redirect_stderr(se))
            rc = demod_realtime.run(argv)
    finally:
        signal.signal(signal.SIGINT, saved)
    m = re.search(r"\((\d+) overrun samples\)", so.getvalue())
    if rc != 0 or m is None or int(m.group(1)):
        raise AssertionError(f"demod_realtime {argv}: rc {rc}, "
                             f"{so.getvalue()[-300:]}")
    return so.getvalue(), se.getvalue()


def phase_realtime(workdir: str) -> dict:
    """demod_realtime on the card with 30 s of poes_tip_realtime at 48 kHz:
    from stdin, the exact chain (lines equal an offline DemodSession with
    quirks off over the same samples) and --fast (lines equal
    demodulate_many on them, what a one-channel ChannelBank gives);
    --fast --source follow:PATH on a RAW file written while it runs, until
    SIGINT (Ctrl-C), its lines those of --fast from stdin.  Then a
    checkpoint: the exact session stopped halfway, saved, loaded and
    continued, its lines those of the run without the stop."""
    import signal
    import threading
    from project_desert_tortoise_tpu_torch.models import streaming
    from project_desert_tortoise_tpu_torch.models.demodulator import (
        DemodSession)
    from project_desert_tortoise_tpu_torch.parallel import blocked
    from project_desert_tortoise_tpu_torch.utils import checkpoint
    from project_desert_tortoise_tpu_torch.utils import synth, wav as W
    from project_desert_tortoise_tpu_torch.utils.config import (
        POES_TIP_REALTIME)

    mode = POES_TIP_REALTIME
    iq, frames = synth.make_poes_recording(n_frames=RT_FRAMES, fs=RT_FS,
                                           carrier_hz=-2000.0,
                                           rng=np.random.default_rng(48))
    n = len(iq) // mode.chunk_size * mode.chunk_size
    iq = (iq[:n] / (np.abs(iq[:n]).max() * 1.2)).astype(np.complex64)
    x = np.empty((n, 2), "<f4")
    x[:, 0], x[:, 1] = iq.real, iq.imag
    stdin_bytes = x.tobytes()
    t = W.time_axis(n, RT_FS, np.float32)
    want = {bytes(f) for f in frames}
    launches = collections.Counter()

    def lines_of(path):
        with open(path) as f:
            return f.read().splitlines()

    out = os.path.join(workdir, "rt_exact.txt")
    t0 = time.time()
    (so, se), counts = drive("exact", lambda: realtime_cli(
        ["--out", out], PacedStdin(stdin_bytes, RT_FS, RT_PACE["exact"])))
    exact_wall = time.time() - t0
    launches.update(counts)
    got = lines_of(out)

    def offline():
        s = DemodSession(mode, RT_FS, quirks=False, device="cuda")
        return s, s.run(iq, t)
    t0 = time.time()
    (sess, res), counts = drive("exact", offline)
    offline_s = time.time() - t0
    launches.update(counts)
    if got != frame_lines(res.frames):
        raise AssertionError(f"demod_realtime (exact): {len(got)} lines "
                             f"against the session's {len(res.frames)}")
    decoded = sum(bytes(f.data) in want for f in res.frames)
    emit("realtime", source="stdin", chain="exact",
         seconds_of_signal=n / RT_FS,
         pace=RT_PACE["exact"], wall_s=exact_wall, lines=len(got),
         payloads_decoded=decoded, of=len(want), offline_session_s=offline_s,
         equal_offline_session=True, launches=counts,
         status_line=re.sub(r"\x1b\[[0-9;]*m", "", se.rsplit("\r", 1)[-1])
         .strip()[:120], card=card_line())
    if decoded < len(want) - 2:
        raise AssertionError(f"demod_realtime (exact): {decoded} of "
                             f"{len(want)} payloads")

    # a checkpoint halfway through the same samples
    half = n // 2 // mode.chunk_size * mode.chunk_size
    ck = os.path.join(workdir, "session.npz")

    def resumed():
        ts = np.float32(1.0) / np.float32(RT_FS)
        t_ext = np.concatenate([t, [np.float32(t[-1] + ts)]])
        a = DemodSession(mode, RT_FS, quirks=False, device="cuda")
        got = []
        for lo in range(0, half, mode.chunk_size):
            got += a.process(iq[lo:lo + mode.chunk_size],
                             t[lo:lo + mode.chunk_size],
                             t_ext[lo + 1:lo + mode.chunk_size + 1])
        checkpoint.save_session(a, ck)
        b = checkpoint.load_session(ck, device="cuda")
        for lo in range(half, n, mode.chunk_size):
            got += b.process(iq[lo:lo + mode.chunk_size],
                             t[lo:lo + mode.chunk_size],
                             t_ext[lo + 1:lo + mode.chunk_size + 1])
        tail = b.framer.flush()
        return got + ([tail] if tail is not None else [])
    t0 = time.time()
    got_ck, counts = drive("exact", resumed)
    launches.update(counts)
    if frame_lines(got_ck) != frame_lines(res.frames):
        raise AssertionError("checkpoint: the resumed session's lines differ "
                             "from the run without the stop")
    emit("checkpoint", mode=mode.name, stopped_at_sample=half,
         lines=len(got_ck), equal_continuous=True,
         npz_bytes=os.path.getsize(ck), wall_s=time.time() - t0,
         launches=counts, card=card_line())

    out = os.path.join(workdir, "rt_fast.txt")
    t0 = time.time()
    (so, se), counts = drive(False, lambda: realtime_cli(
        ["--fast", "--out", out],
        PacedStdin(stdin_bytes, RT_FS, RT_PACE["fast"])))
    fast_wall = time.time() - t0
    launches.update(counts)
    fast = lines_of(out)
    many, counts = drive(False, lambda: blocked.demodulate_many(
        iq[None], t, RT_FS, mode, batch_blocks=16, device="cuda"))
    launches.update(counts)
    if fast != frame_lines(many[0]):
        raise AssertionError(f"demod_realtime --fast: {len(fast)} lines "
                             f"against demodulate_many's {len(many[0])}")
    emit("realtime", source="stdin", chain="fast",
         seconds_of_signal=n / RT_FS,
         pace=RT_PACE["fast"], wall_s=fast_wall, lines=len(fast),
         payloads_decoded=sum(bytes.fromhex(ln.split(" ", 1)[1]) in want
                              for ln in fast),
         equal_demodulate_many=True, launches=counts, card=card_line())

    # --source follow:PATH on a RAW file written while the CLI runs; SIGINT
    # once the follower has pushed every sample
    raw = os.path.join(workdir, "live.raw")
    open(raw, "wb").close()
    pushed = [0]
    real_follow = streaming.follow_raw_file

    class CountingRing:
        def __init__(self, ring):
            self.ring = ring

        def push(self, a, b):
            pushed[0] += len(a)
            return self.ring.push(a, b)

    def follow(ring, path, stop, **kw):
        return real_follow(CountingRing(ring), path, stop, **kw)

    def writer():
        second = int(RT_FS) * 8                # bytes of 1 s of signal
        with open(raw, "ab") as f:
            for lo in range(0, len(stdin_bytes), second):
                f.write(stdin_bytes[lo:lo + second])
                f.flush()
                time.sleep(1.0 / RT_PACE["fast"])
        while pushed[0] < n:
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGINT)
    out = os.path.join(workdir, "rt_follow.txt")
    th = threading.Thread(target=writer, daemon=True)
    t0 = time.time()
    with patched(streaming, "follow_raw_file", follow):
        th.start()
        (so, se), counts = drive(False, lambda: realtime_cli(
            ["--fast", "--source", f"follow:{raw}", "--out", out]))
    th.join(timeout=30)
    launches.update(counts)
    if lines_of(out) != fast:
        raise AssertionError("demod_realtime --source follow: lines differ "
                             "from --fast from stdin")
    emit("realtime", source="follow", chain="fast", wall_s=time.time() - t0,
         lines=len(fast), samples_followed=pushed[0], stopped_by="SIGINT",
         equal_stdin=True, launches=counts, card=card_line())
    return launches


# --- the exact chain's other clocks and the flat whole-file path

# operations a slot, timing and Manchester (for the operations bound)
CLOCK_SLOT_OPS = {"mm": 35, "upsampling_gardner": 45, "upsampling_mm": 40}
# The redesigned clock kernels' chains (the whole-image kernel's
# chain_segment overloads for MmScan, UpGardnerScan and UpMmScan,
# csrc/scan_kernels.cu), a slot as (floating-point, integer, floor)
# dependent operations besides its one shared-memory load.  "mm",
# float32, 12 + 4 + 0: the rounding add, the integer subtract, two clamps
# and the address; the load; sign (compare, select, subtract), multiply,
# subtract, multiply, add, two clamps, add, select.  float64 12 + 3 (the
# rounding add's low word is the integer: no subtract).
# "upsampling_gardner" 14 + 3 + 2: compare, select, add, float->int, two
# clamps, the address; the load; subtract, two multiplies, two clamps,
# subtract, floor, subtract, add, floor, subtract, select.
# "upsampling_mm" 17 + 3 + 2: compare, select, add, float->int, two
# clamps, the address; the load; sign (compare, select, subtract),
# multiply, subtract, multiply, two clamps, add, floor, subtract, add,
# floor, subtract, select.  Each
# floating-point operation at the float add's latency (float32) or
# chain_cycles_f64() (float64), each integer one at the float add's, a
# float floor at its own (the measured floor-and-add less the add; in
# float64 a floating-point operation), the load at the dependent
# ld.shared latency, each as phase_fp64_latency measures it
# (whole_image_chain_cycles).
WHOLE_IMAGE_CHAIN_OPS = {("mm", False): (12, 4, 0), ("mm", True): (12, 3, 0),
                         ("upsampling_gardner", False): (14, 3, 2),
                         ("upsampling_gardner", True): (14, 3, 2),
                         ("upsampling_mm", False): (17, 3, 2),
                         ("upsampling_mm", True): (17, 3, 2)}


def whole_image_chain_cycles(clock: str, f64: bool) -> float:
    """Cycles a slot on a redesigned clock kernel's chain, at the measured
    latencies (phase_fp64_latency must have run)."""
    fp, n_int, floors = WHOLE_IMAGE_CHAIN_OPS[clock, f64]
    f32 = LATENCY_CYCLES["f32_add"]
    floor = (chain_cycles_f64() if f64
             else LATENCY_CYCLES["f32_add_floor"] - f32)
    return (fp * (chain_cycles_f64() if f64 else f32) + n_int * f32
            + floors * floor + LATENCY_CYCLES["ld_shared"])


def clock_cfg(cfg_mod, clock: str, dtype: str = "float32", level: int = 4,
              kind: str = "cubic"):
    """POES_TIP of `cfg_mod` (either package's utils/config.py) with the
    exact chain's `clock` in the JAX tests' settings: "mm" with
    error_limit 3 and gain 0.15 (tests/test_clock.py:118-121); the
    upsampling clocks at `level` (4), `kind` (cubic), gain 1, error_limit
    2 behind a plain low-pass at the input rate
    (tests/test_upsampling_clock.py:18-27, and the study's
    configuration); in `dtype`."""
    import dataclasses
    P = dataclasses.replace(cfg_mod.POES_TIP, dtype=dtype)
    if clock == "mm":
        return dataclasses.replace(P, gardner=dataclasses.replace(
            P.gardner, algorithm="mm", error_limit=3.0, gain=0.15))
    return dataclasses.replace(
        P, fir=cfg_mod.FIRConfig(cutoff_hz=11000.0, base_order=26,
                                 target_rate_hz=None, interp=1),
        gardner=dataclasses.replace(
            P.gardner, algorithm=clock, upsample_level=level,
            upsample_kind=kind, gain=1.0, error_limit=2.0))


def clock_recording(workdir: str):
    """The 60-s POES recording of clocks_exact as a WAV: CLOCK_FRAMES
    frames after an acquisition lead-in frame, 50 kHz.  Returns (path, the
    payloads to recover, the lead-in's payload)."""
    from project_desert_tortoise_tpu_torch.utils import synth, wav as W
    iq, frames = synth.make_poes_recording(n_frames=CLOCK_FRAMES + 1,
                                           fs=POES_FS)
    wav = os.path.join(workdir, "clock_recording.wav")
    W.write_iq_wav(wav, iq / (np.abs(iq).max() * 1.2), int(POES_FS))
    return wav, [bytes(f) for f in frames[1:]], bytes(frames[0])


def clock_images(clock: str, dtype, dev, ragged: bool, carried: bool,
                 level: int = 4, kind: str = "cubic"):
    """A clock kernel's arguments at one POES chunk: the chunk-invariant
    image (TAIL_MARGIN + 10,000 samples at the mode's interpolation, for
    the upsampling clocks at interp 1 upsampled `level` x by `kind`), a
    fresh or a carried state, the valid length the whole image or a ragged
    final chunk's (7,409 samples), the parameters and max_syms."""
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops import resample
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    from project_desert_tortoise_tpu_torch.utils import config as C
    params = chain.make_params(clock_cfg(C, clock, level=level, kind=kind),
                               POES_FS)
    m, L = chain.TAIL_MARGIN, C.POES_TIP.chunk_size
    cap0 = m + L * params.interp
    msyms = chain.max_symbols(cap0, params.step_size)
    x = torch.tensor(sym_image(cap0, params.step_size, 3), dtype=dtype,
                     device=dev)
    n_in = m + (L - 2591) * params.interp if ragged else cap0
    if clock == "mm":
        p = sk.mm_params(params.fs_interp, params.baud,
                         params.gardner_err_limit, params.gardner_gain,
                         params.resync_threshold)
        rows = ([3.4 + m, params.step_size * 1.0007, 0.8] if carried
                else [m, params.step_size, 0.0])
        n_valid = n_in
    else:
        up = params.upsample_level
        x = resample.upsample(x, up, params.upsample_kind).contiguous()
        p = sk.upsampling_params(params.step_size * up,
                                 params.gardner_err_limit,
                                 params.gardner_gain, params.resync_threshold)
        n_valid = (n_in - chain.EDGE) * up
        # split pointers shifted by the margin, as chunk_step shifts them
        rows = [m * up - 3.0, 0.37] if carried else [m * up, 0.0]
        if clock == "upsampling_gardner":       # the mid-bit pointer
            rows += [m * up - 40.0, 0.86] if carried else [m * up, 0.0]
        rows += [-0.6 if carried else 0.0]
    cap = x.shape[1]
    t = (torch.arange(1, cap + 1, device=dev, dtype=dtype)
         / POES_FS)[None].contiguous()
    man = [0.9, -0.8, 0.7] if carried else [0.0, 0.0, 0.0]
    fstate = tuple(torch.full((1,), float(v), dtype=dtype, device=dev)
                   for v in rows + man)
    istate = (torch.zeros(1, dtype=torch.int32, device=dev),
              torch.full((1,), int(carried), dtype=torch.int32, device=dev))
    n = torch.full((1,), n_valid, dtype=torch.int32, device=dev)
    return (fstate, istate, x, t, n, p, msyms)


def phase_clock_kernels(stats: dict):
    """The exact chain's three other clock kernels (mm_manchester_scan,
    upsampling_gardner_manchester_scan, upsampling_mm_manchester_scan)
    against their plain versions on the card, bit for bit, in float32 and
    in float64 (the _f64 instances), at one lane over one POES chunk's
    image (clock_images): from a fresh state over the whole image and from
    a carried one over a ragged final chunk (tests/test_torch_clocks_cuda.py
    has the other combinations and more lanes).  Each (on the whole-image
    kernel) also against its serial twin in both cases, both timed in this
    run (`whole_chunk_vs_serial` lines), and on a forced small ring
    (SMALL_RING, SMALL_RING_F64); one `design` line each: the launch
    configuration the card reports, the times and the chain bound at the
    measured latencies (whole_image_chain_cycles, a slot up to the first
    inactive one).  One `clock_kernel` line each kernel: ms a launch (CUDA
    events, fresh state, whole image), the bytes bound of those inputs
    (each value the chain reads, and the outputs, once), the chain bound,
    the plain version's ms; the launches on the main paths are the
    clocks_exact lines' and the kernels line's."""
    import torch
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk

    dev = torch.device("cuda")
    cases = ((False, False), (True, True))
    case_of = lambda carried, ragged: (
        f"{'carried' if carried else 'fresh'} state, "
        f"{'ragged final chunk' if ragged else 'whole image'}")
    for clock in WHOLE_IMAGE_CLOCKS:
        for dtype in (torch.float32, torch.float64):
            f64 = dtype == torch.float64
            name = f"{clock}_manchester_scan" + ("_f64" if f64 else "")
            kern = getattr(sk, f"{clock}_manchester_scan")  # routes float64
            plain = getattr(sk, f"{clock}_manchester_scan_ref")
            times = {}
            for carried, ragged in cases:
                args = clock_images(clock, dtype, dev, ragged, carried)
                case = case_of(carried, ragged)
                times[case] = time_pair(
                    name, f"exact chain, 1 lane, {case}",
                    lambda: kern(*args), lambda: plain(*args),
                    list(args[2].shape), stats)
            args = clock_images(clock, dtype, dev, False, False)
            ms, plain_ms, _ = times[case_of(False, False)]
            out = kern(*args)
            count, msyms = int(out[-1][0]), args[-1]
            shape = list(args[2].shape)
            computed = min(count + 1, msyms)   # up to the first inactive
            w = 8.0 if f64 else 4.0
            reads = 3.0 if clock == "upsampling_gardner" else 2.0
            n_bytes = count * reads * w + msyms * (2 * w + 3)
            chain = dict(
                chain_ops_a_slot=dict(zip(
                    ("floating_point", "integer", "floor"),
                    WHOLE_IMAGE_CHAIN_OPS[clock, f64]), ld_shared=1),
                chain_cycles_a_slot=whole_image_chain_cycles(clock, f64))
            chain["chain_bound_ms"] = chain_bound_ms(
                computed, 1, chain["chain_cycles_a_slot"])
            clock_vs_serial(clock, name, dtype, cases, case_of, chain,
                            stats)
            b = bound(n_bytes, msyms * CLOCK_SLOT_OPS[clock],
                      FP64_FLOP_S if f64 else FP32_FLOP_S)
            # the chain bound is computed: on this line, not in the table
            stats[name].update(ms=ms, shape=shape, max_syms=msyms,
                               active_slots=count, **b)
            emit("clock_kernel", kernel=name, shape=shape, max_syms=msyms,
                 active_slots=count, ms=ms, plain_ms=plain_ms, **chain,
                 bit_exact=True, card=card_line(), **b)


def clock_vs_serial(clock: str, name: str, dtype, cases, case_of,
                    chain: dict, stats: dict):
    """A redesigned clock kernel against its serial twin on the
    clock_images cases, bit for bit, both timed in this run (old, new,
    new, old), and on the forced small ring; one `whole_chunk_vs_serial`
    line a case, one `design` line (the launch configurations, the fresh
    whole-image case's times, `chain`)."""
    import torch
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk

    dev = torch.device("cuda")
    f64 = dtype == torch.float64
    kern = getattr(sk, f"{clock}_manchester_scan")
    twin = getattr(sk, name + "_serial")
    small = SMALL_RING_F64 if f64 else SMALL_RING
    times = {}
    for carried, ragged in cases:
        args = clock_images(clock, dtype, dev, ragged, carried)
        case = case_of(carried, ragged)
        ms, ms_old, got, want = old_new_ms(lambda: kern(*args),
                                           lambda: twin(*args), reps=10)
        check_equal(got, want, f"{name} vs serial ({case})")
        check_equal(kern(*args, ring_floats=small), want,
                    f"{name}, small ring, vs serial ({case})")
        times[case] = ms, ms_old
        emit("whole_chunk_vs_serial", kernel=name, case=case,
             shape=list(args[2].shape), bit_exact=True,
             small_ring_bit_exact=True, ms=ms, serial_ms=ms_old,
             speedup=ms_old / ms, card=card_line())
    args = clock_images(clock, dtype, dev, False, False)
    B, cap = args[2].shape
    ms, ms_old = times[case_of(False, False)]
    emit("design", mode=f"exact chain, {clock} clock"
         + (" (float64)" if f64 else ""), card=card_line(),
         **{name: dict(sk.clock_scan_launch_config(clock, B, cap,
                                                   dtype=dtype),
                       shape=[B, cap], max_syms=args[-1], ms=ms,
                       serial_ms=ms_old, **chain,
                       latency_cycles=dict(LATENCY_CYCLES),
                       small_ring=sk.clock_scan_launch_config(
                           clock, B, cap, small, dtype=dtype))})
    stats[name + "_serial"] = dict(ms=ms_old, shape=[B, cap],
                                   redesigned_ms=ms, max_abs_err=0.0)
    stats.setdefault(name, {})["isolated"] = dict(ms=ms, serial_ms=ms_old,
                                                  shape=[B, cap])


def clock_payloads(frames, want, lead_in, key) -> dict:
    """The run's payloads against CLOCK_REFERENCE[key]: raises unless the
    missed, the extra and the repeated payloads are the reference's."""
    got = [bytes(f.data) for f in frames]
    missed, extra, repeated = payload_diff(got, want, lead_in)
    ref = CLOCK_REFERENCE[key]
    if (tuple(missed), tuple(extra), tuple(repeated)) != ref:
        raise AssertionError(f"{key}: missed {missed[:20]}, extra "
                             f"{extra[:10]}, repeated {repeated[:20]}; "
                             f"the reference's {ref}")
    return dict(frames=len(got), recovered_once=len(want) - len(missed)
                - len(repeated), of=len(want), missed=missed, extra=extra,
                repeated=repeated, as_reference=True)


def phase_clocks_exact(workdir: str) -> collections.Counter:
    """DemodSession on the card with each of the exact chain's other clocks
    (clock_cfg, CLOCK_RUNS), float32 and float64, on the 60-s recording
    (clock_recording) at the mode's chunk, one lane: each a main path
    (exact_<clock>[_f64]) whose payloads must be the JAX exact chain's
    (CLOCK_REFERENCE); the upsampling clocks (float32) also at
    CLOCK_SECOND_CHUNK with the norm of the first run, their lines the
    same as at 10,000.  Each kernel
    launch is bracketed by CUDA events in the run (launch_events).
    Returns the launches."""
    import torch
    from project_desert_tortoise_tpu_torch.models.demodulator import (
        DemodSession)
    from project_desert_tortoise_tpu_torch.ops.kernels import common
    from project_desert_tortoise_tpu_torch.utils import config as C
    from project_desert_tortoise_tpu_torch.utils import wav as W

    wav, want, lead_in = clock_recording(workdir)
    launches = collections.Counter()
    lines, norms = {}, {}
    for dtype in ("float32", "float64"):
        iq, t, fs, _ = W.load_iq_wav(wav, np.dtype(dtype))
        for clock, quirks in CLOCK_RUNS:
            cfg = clock_cfg(C, clock, dtype)
            chunks = (cfg.chunk_size,)
            if clock.startswith("upsampling") and dtype == "float32":
                chunks += (CLOCK_SECOND_CHUNK,)
            for chunk in chunks:
                path = f"exact_{clock}" + ("_f64" if dtype == "float64"
                                           else "")
                # the second chunk size takes the first's norm: the
                # first-chunk probe depends on the chunk by definition
                sess = DemodSession(cfg, fs, chunk_size=chunk, quirks=quirks,
                                    norm_factor=norms.get((clock, dtype)),
                                    device="cuda")
                events = {}
                with patched(common, "launch_events", events):
                    t0 = time.time()
                    res, counts = drive(path, lambda: sess.run(iq, t))
                    wall = time.time() - t0
                norms[clock, dtype] = sess.norm_factor
                torch.cuda.synchronize()
                ms = {k: sum(a.elapsed_time(b) for a, b in v) / len(v)
                      for k, v in events.items()}
                got = [f.hex_line() for f in res.frames]
                same = None
                if chunk != cfg.chunk_size:
                    same = got == lines[clock, dtype]
                    if not same:
                        raise AssertionError(
                            f"{clock}: the lines at {chunk}-sample chunks "
                            f"differ from those at {cfg.chunk_size}")
                else:
                    lines[clock, dtype] = got
                launches.update(counts)
                emit("clocks_exact", clock=clock, quirks=quirks, dtype=dtype,
                     chunk=chunk, samples=len(iq), wall_s=wall,
                     launches={k: counts[k] for k in PATH_KERNELS[path]},
                     kernel_event_ms_a_launch=ms,
                     lines_as_at_mode_chunk=same, card=card_line(),
                     **clock_payloads(res.frames, want, lead_in,
                                      (clock, quirks, dtype)))
        del iq, t
    os.remove(wav)
    return launches


def phase_study(workdir: str, stats: dict) -> collections.Counter:
    """The port's upsampling-level study on the card (main path "study") at
    the committed study's settings (STUDY_SNR_DB, STUDY_FRAMES,
    STUDY_LEVELS): each row's frames_ok must be STUDY_REFERENCE's.  For
    each clock and level, whether the float32 whole-image kernel holds a
    chunk's image (TAIL_MARGIN + the mode's chunk, upsampled) resident in
    shared memory or recycles its tiles, as the card reports its launch
    geometry.  Then the two clock kernels against their plain versions at
    the study's images (study_clock_checks).  Returns the launches."""
    from project_desert_tortoise_tpu_torch.chain import TAIL_MARGIN
    from project_desert_tortoise_tpu_torch.ops.kernels.scan_kernels import (
        clock_scan_launch_config)
    from project_desert_tortoise_tpu_torch.tools import study_upsampling as S
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

    out = os.path.join(workdir, "study")
    argv = ["--frames", str(STUDY_FRAMES), "--snr", str(STUDY_SNR_DB),
            "--levels", ",".join(map(str, STUDY_LEVELS)), "--out-dir", out,
            "--device", "cuda"]
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):     # the rows, as JSON
        rc, counts = drive("study", lambda: S.main(argv))
    wall = time.time() - t0
    with open(os.path.join(out, "upsampling_levels.json")) as f:
        rows = json.load(f)["rows"]
    got = {(r["algorithm"], r["kind"], r["level"]): r["frames_ok"]
           for r in rows}
    differ = {"%s/%s/%d" % k: [got.get(k), v]
              for k, v in STUDY_REFERENCE.items() if got.get(k) != v}
    geometry = {}
    for alg in S.ALGORITHMS:
        for lv in STUDY_LEVELS:
            cap = (TAIL_MARGIN + POES_TIP.chunk_size) * lv
            g = clock_scan_launch_config(alg, 1, cap)
            geometry["%s/%d" % (alg, lv)] = dict(
                image=cap, tiles="resident" if g["resident"] else "recycled",
                ring_floats=g["ring_floats"],
                dynamic_smem_bytes=g["dynamic_smem_bytes"])
    emit("study", rows=len(rows), wall_s=wall,
         launches={k: counts[k] for k in PATH_KERNELS["study"]},
         frames_ok={"%s/%s/%d" % k: v for k, v in got.items()},
         unlike_reference=differ, float32_geometry=geometry,
         card=card_line())
    if rc != 0 or len(rows) != len(STUDY_REFERENCE) or differ:
        raise AssertionError(f"study: rc {rc}, {len(rows)} rows, unlike "
                             f"the reference {differ}")
    study_clock_checks(stats)
    return counts


def study_clock_checks(stats: dict):
    """Each upsampling clock kernel (float32) against its plain version on
    the card, bit for bit, at STUDY_CHECK_LEVELS and both kinds, one lane
    over one chunk's image at the study's configuration (clock_images:
    fresh state, the whole image), both timed in this run (time_pair);
    raises unless the levels from STUDY_RECYCLED_FROM take the recycled
    tiles and the others stay resident.  One `study_clock_kernel` line
    each: the launch geometry the card reports, ms, the plain version's
    ms, the bound of those inputs counted as in phase_clock_kernels, and
    the chain bound at the measured latencies.  The numbers go under
    "study" in the kernel's stats (the kernels line), apart from its
    level-4 row."""
    import torch
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk

    dev = torch.device("cuda")
    for clock in ("upsampling_gardner", "upsampling_mm"):
        name = f"{clock}_manchester_scan"
        kern, plain = getattr(sk, name), getattr(sk, name + "_ref")
        st = stats[name]
        for lv in STUDY_CHECK_LEVELS:
            for kind in ("cubic", "linear"):
                args = clock_images(clock, torch.float32, dev, False, False,
                                    lv, kind)
                B, cap = args[2].shape
                g = sk.clock_scan_launch_config(clock, B, cap)
                tiles = "resident" if g["resident"] else "recycled"
                if (tiles == "recycled") != (lv >= STUDY_RECYCLED_FROM):
                    raise AssertionError(f"{name}, level {lv}: the image of "
                                         f"{cap} floats is {tiles}")
                case = f"study, level {lv}, {kind}, {tiles}"
                ms, plain_ms, err = time_pair(
                    name, case, lambda: kern(*args), lambda: plain(*args),
                    [B, cap], {})
                count, msyms = int(kern(*args)[-1][0]), args[-1]
                reads = 3.0 if clock == "upsampling_gardner" else 2.0
                b = bound(count * reads * 4.0 + msyms * 11.0,
                          msyms * CLOCK_SLOT_OPS[clock])
                chain_ms = chain_bound_ms(min(count + 1, msyms), 1,
                                          whole_image_chain_cycles(clock,
                                                                   False))
                row = dict(ms=ms, plain_ms=plain_ms, shape=[B, cap],
                           max_syms=msyms, active_slots=count,
                           chain_bound_ms=chain_ms, **b)
                st["max_abs_err"] = max(st["max_abs_err"], err)
                st.setdefault("study", {})[f"level {lv}, {kind}"] = dict(
                    tiles=tiles, **row)
                emit("study_clock_kernel", kernel=name, level=lv, kind=kind,
                     tiles=tiles, ring_floats=g["ring_floats"],
                     dynamic_smem_bytes=g["dynamic_smem_bytes"],
                     bit_exact=True, card=card_line(), **row)


def phase_sharded(wav: str, scan_lines, fused_out: str, want,
                  lead_in) -> collections.Counter:
    """The POES pass through ``demodulate_sharded`` on meshes (1, 1) and
    (1, 4) whose entries are all the one card (the halos CUDA tensors), on
    branch False and on the fused branch: every payload once
    (payload_check) and the frame set ``demodulate_blocked``'s on that
    branch (the fast CLI's lines, the fused branch's file).  Every entry
    is the same card, so the walls are no scaling measurement.  Returns
    the launches."""
    import torch
    from project_desert_tortoise_tpu_torch.parallel.sharding import (
        demodulate_sharded, make_mesh)
    from project_desert_tortoise_tpu_torch.utils import wav as W
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP
    from project_desert_tortoise_tpu_torch.utils.output import (
        parse_frames_file)

    iq, t, fs, _ = W.load_iq_wav(wav, np.dtype(np.float32))
    blocked = {False: sorted(scan_lines),
               "fused": sorted((f"{tt:.5f}", bytes(b)) for tt, _, b in
                               parse_frames_file(fused_out))}
    card = torch.device("cuda", 0)
    launches = collections.Counter()
    for br in (False, "fused"):
        for shape in ((1, 1), (1, 4)):
            mesh = make_mesh(*shape, [card] * (shape[0] * shape[1]))
            t0 = time.time()
            res, counts = drive(br, lambda: demodulate_sharded(
                iq[None], t, fs, POES_TIP, mesh, use_pallas=br))
            wall = time.time() - t0
            launches.update(counts)
            got = sorted((f"{f.time:.5f}", bytes(f.data)) for f in res[0])
            same = got == blocked[br]
            emit("multichip_sharded", mesh="%dx%d" % shape, use_pallas=br,
                 wall_s=wall,
                 launches={k: counts[k] for k in PATH_KERNELS[br]},
                 frame_set_as_blocked=same, blocked_frames=len(blocked[br]),
                 card=card_line(),
                 **payload_check("poes", [b for _, b in got], want, lead_in))
            if not same:
                raise AssertionError(f"mesh {shape}, branch {br}: the frame "
                                     "set differs from demodulate_blocked's")
    return launches


def multihost_rank(port: int, rec: str):
    """One NCCL rank, world size 1, in a process of its own:
    ``demodulate_multihost`` of the recording `rec` (npz: iq, t, fs) on a
    global mesh of two entries of the card.  Returns the backend, the
    mesh's shape, the frames as (time, inverted, payload hex) and the
    launches."""
    import torch.distributed as dist
    from project_desert_tortoise_tpu_torch.parallel import multihost as MH
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

    dev = MH.init(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        mesh = MH.global_mesh(1, [dev, dev])
        z = np.load(rec)
        res, counts = drive(False, lambda: MH.demodulate_multihost(
            z["iq"], z["t"], float(z["fs"]), POES_TIP, mesh))
        frames = [(f.time, f.inverted, bytes(f.data).hex()) for f in res[0]]
        return (dist.get_backend(), mesh.shape, frames,
                {k: counts[k] for k in PATH_KERNELS[False]})
    finally:
        dist.destroy_process_group()


def phase_multihost(workdir: str):
    """``demodulate_multihost`` in one spawned NCCL rank (multihost_rank) on
    a short recording (MULTIHOST_FRAMES frames): its frames must be
    ``demodulate_sharded``'s in this process on the same mesh shape (1, 2)
    of the card, time, polarity and payload."""
    import concurrent.futures
    import multiprocessing
    import socket
    import torch
    from project_desert_tortoise_tpu_torch.parallel.sharding import (
        demodulate_sharded, make_mesh)
    from project_desert_tortoise_tpu_torch.utils import synth, wav as W
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

    iq, sent = synth.make_poes_recording(n_frames=MULTIHOST_FRAMES,
                                         fs=POES_FS)
    t = W.time_axis(len(iq), POES_FS, np.float32)
    rec = os.path.join(workdir, "multihost.npz")
    np.savez(rec, iq=iq[None], t=t, fs=POES_FS)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.time()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        backend, shape, frames, counts = ex.submit(
            multihost_rank, port, rec).result(timeout=600)
    wall = time.time() - t0
    card = torch.device("cuda", 0)
    ref = demodulate_sharded(iq[None], t, POES_FS, POES_TIP,
                             make_mesh(1, 2, [card, card]))
    want = [(f.time, f.inverted, bytes(f.data).hex()) for f in ref[0]]
    sset = {bytes(f).hex() for f in sent}
    emit("multichip_multihost", backend=backend, world_size=1, mesh=shape,
         wall_s=wall, launches=counts, frames=len(frames),
         payloads_sent=sum(f[2] in sset for f in frames), of=len(sent),
         as_sharded=frames == want, card=card_line())
    if backend != "nccl" or frames != want:
        raise AssertionError(f"multihost on {backend}: {len(frames)} "
                             f"frames, demodulate_sharded {len(want)}; "
                             "they differ")
    return counts


class ArgsKept:
    """A kernel wrapper that keeps a copy of each call's arguments and then
    makes the call; its ``launches`` are the wrapper's own."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    launches = property(lambda self: self.fn.launches,
                        lambda self, v: setattr(self.fn, "launches", v))

    @staticmethod
    def copy(a):
        import torch
        if isinstance(a, torch.Tensor):
            return a.clone()
        if isinstance(a, tuple) and not hasattr(a, "_fields"):
            return tuple(ArgsKept.copy(x) for x in a)
        return a

    def __call__(self, *args, **kw):
        self.calls.append(self.copy(args))
        return self.fn(*args, **kw)


def phase_dryrun(stats: dict) -> collections.Counter:
    """``multichip_dryrun_torch.dryrun_multichip`` over DRYRUN_DEVICES
    entries of the one card (main path "dryrun"): frame sets equal across
    the mesh shapes and between the scan and the fused branch.  The scan
    branch's gardner_manchester_scan launch on its first mesh (1 x n, the
    halos crossing between shards), whose blocks take the window=0 layout
    (one scan over each whole block), is kept (ArgsKept) and held against
    its plain version on those arguments, bit for bit, both timed
    (time_pair); one `dryrun_clock_kernel` line with the bound counted as
    the exact CLI's (12 bytes and ~30 operations an active slot, 11 bytes
    a slot) and the chain bound; under "dryrun" in the kernel's stats."""
    import multichip_dryrun_torch
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    t0 = time.time()
    kept = ArgsKept(sk.gardner_manchester_scan)
    with contextlib.redirect_stdout(io.StringIO()), \
            patched(sk, "gardner_manchester_scan", kept):
        out, counts = drive("dryrun", lambda:
                            multichip_dryrun_torch.dryrun_multichip(
                                DRYRUN_DEVICES, device="cuda"))
    wall = time.time() - t0
    args = kept.calls[0]
    B, L = args[2].shape
    ms, plain_ms, err = time_pair(
        "gardner_manchester_scan", f"dry run, window=0 layout, {B} lanes",
        lambda: sk.gardner_manchester_scan(*args),
        lambda: sk.gardner_manchester_scan_ref(*args), [B, L], {})
    active = sk.gardner_manchester_scan(*args)[-1]
    n_syms, max_syms = int(active.sum()), args[-1]
    row = dict(ms=ms, plain_ms=plain_ms, shape=[B, L], max_syms=max_syms,
               active_slots=n_syms,
               chain_bound_ms=chain_bound_ms(
                   min(int(active.max()) + 1, max_syms), GM_SLOT_CHAIN_OPS),
               **bound(n_syms * 12.0 + B * max_syms * 11.0, n_syms * 30.0))
    st = stats["gardner_manchester_scan"]
    st["max_abs_err"] = max(st["max_abs_err"], err)
    st["dryrun"] = row
    emit("dryrun_clock_kernel", kernel="gardner_manchester_scan",
         layout="window=0", mesh="1x%d" % DRYRUN_DEVICES, bit_exact=True,
         card=card_line(), **row)
    emit("multichip_dryrun", devices=DRYRUN_DEVICES,
         shapes=["%dx%d" % s for s in out["shapes"]], frames=out["frames"],
         balanced="%dx%d" % out["balanced"], relabelled=out["relabelled"],
         wall_s=wall,
         launches={k: counts[k] for k in PATH_KERNELS["dryrun"]},
         card=card_line())
    return counts


def phase_flat_path(wav: str, workdir: str, scan_out: str, fused_out: str,
                    want, lead_in) -> collections.Counter:
    """The flat whole-file path on the 12-minute POES pass (parallel/
    blocked.py): ``demod_frames_flat`` one-shot on branch False and on the
    fused branch, from the WAV's int16 planes uploaded whole (the windows
    cut on the card), each frames file byte for byte the one
    ``demodulate_blocked`` wrote on the same branch (the CLI's for False,
    phase_branch_path's for "fused"); ``demod_frames_flat_pipelined`` in
    bench.py's end-to-end configuration (bench.py:221-245: "fused",
    tgen=True, pack=-1, 4 slices), whose frames must be the fused
    one-shot's; then the planes scaled to 13 signed bits, pipelined with
    pack=-1, which must choose width 13, their frames those of the same
    scaled planes shipped as int16 (pack=0).  Every run must recover every
    payload once.  Walls on the host clock; the upload seconds (the
    planes' host-to-device copies, timed apart, synchronised) and bytes;
    the pack width.  Returns the launches."""
    import filecmp
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops import agc
    from project_desert_tortoise_tpu_torch.parallel import blocked
    from project_desert_tortoise_tpu_torch.utils import wav as W
    from project_desert_tortoise_tpu_torch.utils.output import FrameWriter

    mode, _ = modes()["poes"]
    dev = torch.device("cuda")
    dt = np.dtype(np.float32)
    iq, t, fs, _ = W.load_iq_wav(wav, mode.np_dtype())
    n = len(iq)
    params, plan = chain.make_params(mode, fs), blocked.default_plan(mode, fs)
    B = -(-n // plan.core)
    # the PCM samples: the loader's values are int16 / 32768, exactly
    r16 = (iq.real * 32768.0).astype(np.int16)
    i16 = (iq.imag * 32768.0).astype(np.int16)
    norm = float(agc.static_gain(iq[:mode.chunk_size],
                                 mode.static_gain_level, dt))
    t_ext = np.concatenate([np.asarray(t, dt), [dt.type(
        t[-1] + dt.type(1.0) / dt.type(fs))]])
    del iq, t
    launches = collections.Counter()

    def write(frames, name):
        path = os.path.join(workdir, name)
        with FrameWriter(path, inverted_mark=mode.framer.inverted_mark) as w:
            w.write_all(frames)
        return path

    def check(frames, what):
        return payload_check("poes", [bytes(f.data) for f in frames], want,
                             lead_in)
    one_shot = {}
    for br, ref in ((False, scan_out), ("fused", fused_out)):
        def run():
            t0 = time.perf_counter()
            zre, zim = (torch.from_numpy(a).to(dev) for a in (r16, i16))
            torch.cuda.synchronize()
            up = time.perf_counter() - t0
            frames = blocked._fetch_frames(blocked.demod_frames_flat(
                params, mode.framer, plan, B, fs, 4096, br, zre, zim, norm),
                t_ext)
            return frames, up, time.perf_counter() - t0
        (frames, up, wall), counts = drive(
            "flat_fused" if br else "flat_scan", run)
        launches.update(counts)
        out = write(frames, f"flat_{br}.txt")
        if not filecmp.cmp(out, ref, shallow=False):
            raise AssertionError(f"demod_frames_flat ({br}) did not write "
                                 "demodulate_blocked's frames")
        one_shot[br] = frames
        emit("flat_path", entry="demod_frames_flat", use_pallas=br, B=B,
             samples=n, wall_s=wall, upload_s=up, upload_bytes=2 * r16.nbytes,
             launches=counts, lines_as_demodulate_blocked=True,
             card=card_line(), **check(frames, br))

    def upload_s(re_, im_, pack):
        """The pipelined slices' pinned host-to-device copies alone."""
        _, slice_np, width = blocked.stage_flat_slices(plan, B, 4, re_, im_,
                                                        pack)
        total, n_bytes = 0.0, 0
        for k in range(4):
            planes = slice_np(k)[:2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for a in planes:
                torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                n_bytes += a.nbytes
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
        return total, n_bytes, width

    def pipelined(re_, im_, pack, norm_gain, what, ref_frames):
        t0 = time.perf_counter()
        frames, counts = drive("flat_fused", lambda: (
            blocked.demod_frames_flat_pipelined(
                params, mode.framer, plan, B, fs, 4096, "fused", re_, im_,
                t_ext, norm_gain, n_slices=4, tgen=True, pack=pack)))
        wall = time.perf_counter() - t0
        launches.update(counts)
        up, n_bytes, width = upload_s(re_, im_, pack)
        same = ([(f.time, f.inverted, bytes(f.data)) for f in frames]
                == [(f.time, f.inverted, bytes(f.data)) for f in ref_frames]
                if ref_frames is not None else None)
        if same is False:
            raise AssertionError(f"pipelined ({what}): frames differ")
        emit("flat_path", entry="demod_frames_flat_pipelined", case=what,
             use_pallas="fused", tgen=True, pack=pack, pack_width=width,
             n_slices=4, B=B, wall_s=wall, upload_s=up, upload_bytes=n_bytes,
             launches=counts, frames_as_reference=same, card=card_line(),
             **check(frames, what))
        return frames, width
    _, width = pipelined(r16, i16, -1, norm, "full-scale int16 planes",
                         one_shot["fused"])
    if width != 0:
        raise AssertionError(f"full-scale planes packed to {width} bits")
    # the golden clip's level: 13 signed bits
    scale = 4095.0 / max(int(np.abs(r16).max()), int(np.abs(i16).max()))
    r13 = np.round(r16 * scale).astype(np.int16)
    i13 = np.round(i16 * scale).astype(np.int16)
    z13 = (r13[:mode.chunk_size] + 1j * i13[:mode.chunk_size]) / 32768.0
    norm13 = float(agc.static_gain(z13, mode.static_gain_level, dt))
    as_int16, _ = pipelined(r13, i13, 0, norm13, "13-bit planes as int16",
                            None)
    _, width = pipelined(r13, i13, -1, norm13, "13-bit planes packed",
                         as_int16)
    if width != 13:
        raise AssertionError(f"13-bit planes packed to {width} bits")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    phase_toolchain()
    phase_build()
    with cpu_worker() as worker:
        return drive_all(worker.submit(cpu_exact_small),
                         worker.submit(cpu_slice))


@contextlib.contextmanager
def cpu_worker():
    """One worker process (spawned: it touches no card) for the plain
    versions' runs on the CPU, so that they go on beside the card phases;
    shut down, its process ended, on the way out."""
    import concurrent.futures
    import multiprocessing
    ex = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    try:
        yield ex
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def drive_all(exact_cpu, slice_cpu) -> int:
    """Every phase after the build; exact_cpu and slice_cpu are the CPU
    worker's futures of cpu_exact_small and cpu_slice."""
    import torch
    stats = {"poes": {}, "argos": {}}
    phase_kernel()
    phase_tgen_small(stats)
    phase_new_kernels(stats["poes"])
    phase_exact_kernels(stats["poes"])
    phase_argos_kernels(stats["argos"])
    phase_fp64_latency()
    phase_argos_exact_kernels(stats["argos"])
    phase_clock_kernels(stats["poes"])
    phase_exact_small(exact_cpu.result())
    launches = {"poes": collections.Counter(), "argos": collections.Counter()}
    staged = {}
    walls, fused_walls = {}, {}
    with tempfile.TemporaryDirectory() as workdir:
        for mode_name in ("poes", "argos"):
            wav, want, lead_in = synth_pass(mode_name, workdir)
            out, walls[mode_name], counts, lines = phase_cli_path(
                mode_name, workdir, wav, want, lead_in)
            launches[mode_name].update(counts)
            launches[mode_name].update(phase_exact_cli(
                mode_name, workdir, wav, want, lead_in, lines,
                stats[mode_name]))
            if mode_name == "poes":
                phase_products(workdir, out)
            for br in ("fused", "front"):
                counts, wall, br_out = phase_branch_path(
                    mode_name, workdir, wav, br, want, lead_in, lines)
                launches[mode_name].update(counts)
                if br == "fused":
                    fused_out, fused_walls[mode_name] = br_out, wall
            if mode_name == "poes":
                launches["poes"].update(phase_flat_path(
                    wav, workdir, out, fused_out, want, lead_in))
                launches["poes"].update(phase_sharded(
                    wav, lines, fused_out, want, lead_in))
            staged[mode_name], t_ext = phase_stages(mode_name, wav, workdir,
                                                    walls[mode_name])
            if mode_name == "poes":
                phase_plane_lines(mode_name, staged[mode_name], t_ext,
                                  fused_out, workdir)
                phase_exact_fallback(staged[mode_name], stats["poes"])
            os.remove(wav)
    with tempfile.TemporaryDirectory() as workdir:
        counts, planes, api_lines = phase_serving(stats["poes"])
        launches["poes"].update(counts)
        launches["poes"].update(phase_demod_serve(workdir, planes,
                                                  api_lines))
        del planes
        launches["poes"].update(phase_realtime(workdir))
        launches["poes"].update(phase_clocks_exact(workdir))
        launches["poes"].update(phase_study(workdir, stats["poes"]))
        launches["poes"].update(phase_multihost(workdir))
        launches["poes"].update(phase_dryrun(stats["poes"]))
    ablation_launches = phase_ablation(stats["poes"])
    slice_frames = slice_cpu.result()
    phase_slice("poes", slice_frames)
    phase_slice("argos", slice_frames)
    for mode_name in ("poes", "argos"):
        st = stats[mode_name]
        phase_fused_at_main_shape(mode_name, staged[mode_name],
                                  fused_walls[mode_name], st)
        phase_new_kernels_at_main_shape(mode_name, staged[mode_name], st)
        phase_decoupled_at_main_shape(mode_name, staged[mode_name], st)
        phase_scan_at_main_shape(mode_name, staged[mode_name], st)
        phase_gardner_at_main_shape(mode_name, staged[mode_name], st)
        for br in ("front", False):
            for k, v in phase_branch_stages(mode_name, staged[mode_name],
                                            br).items():
                st.setdefault(k, {}).update(v)

    # the serial twins compute the same function as the redesigned kernels:
    # the same bound and plain version
    for mode_name, st in stats.items():
        exact = (("gardner_manchester_scan", *(
            t[:-len("_serial")] for t in CLOCK_TWINS))
                 if mode_name == "poes" else
                 ("pll_scan_f64", "gardner_manchester_scan_f64"))
        for k in ("fused_demod", "pll_fir_agc", "pll_scan", "agc_scan",
                  "gardner_manchester", *exact):
            for f in ("bound_ms", "bound_by", "plain_ms", "plain_shape"):
                st[k + "_serial"][f] = st[k][f]

    jax_pkg = "project_desert_tortoise_tpu"
    if any(m in ("jax", jax_pkg) or m.startswith(("jax.", jax_pkg + "."))
           for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    emit("total", seconds=time.time() - T0)
    # POES's numbers (and the ablation tools') at the top of each entry,
    # ARGOS's in "argos"; launches summed over every main path run
    table = []
    for name, (src, rep) in KERNELS.items():
        st = stats["poes"].get(name)
        argos = stats["argos"].get(name)
        if st is None:          # the float64 kernels: the argos mode only
            st, argos = argos, None
        entry = dict(name=name, route="cuda", source=src, replaces=rep,
                     launches=(launches["poes"][name]
                               + launches["argos"][name]
                               + ablation_launches[name]),
                     library_ms=None, **st)
        if argos:
            entry["max_abs_err"] = max(st["max_abs_err"],
                                       argos.get("max_abs_err", 0.0))
            entry["argos"] = dict(launches=launches["argos"][name], **argos)
        table.append(entry)
    print(json.dumps({"kernels": table}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one CUDA card).

Builds the kernels from the sources of this checkout (one library, one
nvcc per source in parallel), holds each against its plain PyTorch version
on the card, checks the block-parallel slice on the CPU against the card
on each of its three branches (``use_pallas`` "fused", "front", False),
and decodes a synthetic 12-minute NOAA POES pass (50 kHz, 36 M samples)
through the port's CLI, ``demod_poes --fast`` (the fused branch), and
through ``demodulate_blocked`` on the front and scan branches.  It then
times the steps of each path one by one (``stages`` lines), and times each
kernel on the main path's blocks and holds it there against its plain
version bit for bit (the fused kernel on the whole blocks, the others on
their first 32,768 samples).  Each phase prints one JSON line; any
failure raises and the script exits non-zero.  The last lines are the
kernel table, the card's name and power limit as nvidia-smi reports them,
and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FS = 50000.0
SMALL_PLAN = (8192, 12288, 8192, 8)      # core, head, tail, max_frames
PASS_FRAMES = 7200                       # 12 minutes of 0.1 s minor frames
# samples per lane of the unfused branches' kernels' plain-version checks
# on the main path's blocks: 8 of its 4,096-sample Gardner windows (the
# plain versions are per-sample loops of ~0.1-1.7 ms a step on the card)
MAIN_CHECK_L = 32768
CSRC = "project_desert_tortoise_tpu_torch/csrc/"
JAX = "project_desert_tortoise_tpu/"
# name: (source, the TPU kernel or XLA scan it replaces)
KERNELS = {
    "fused_demod": (CSRC + "fused_demod.cu",
                    JAX + "ops/pallas/fused_kernel.py:291"),
    "pll_fir_agc": (CSRC + "chain_kernel.cu",
                    JAX + "ops/pallas/chain_kernel.py:100"),
    "pll_scan": (CSRC + "pll_kernel.cu", JAX + "ops/pallas/pll_kernel.py:60"),
    "agc_scan": (CSRC + "scan_kernels.cu", JAX + "ops/agc.py:65"),
    "gardner_manchester": (CSRC + "scan_kernels.cu", JAX + "ops/clock.py:151"),
}
# the kernels each branch of the main path launches
BRANCH_KERNELS = {"fused": ("fused_demod",),
                  "front": ("pll_fir_agc", "gardner_manchester"),
                  False: ("pll_scan", "agc_scan", "gardner_manchester")}
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, fp32 flop/s
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12


def emit(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def kernel_fns() -> dict:
    """Each kernel's wrapper (whose ``.launches`` counts its launches)."""
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels
    from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
        pll_fir_agc)
    from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
        fused_demod)
    from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
        pll_scan_kernel)
    return {"fused_demod": fused_demod, "pll_fir_agc": pll_fir_agc,
            "pll_scan": pll_scan_kernel, "agc_scan": scan_kernels.agc_scan,
            "gardner_manchester": scan_kernels.gardner_manchester}


def drive(path: str, fn):
    """Run one main path: every kernel count set to 0 just before fn(),
    read just after; fails unless each kernel of the path launched.
    Returns (fn's result, {kernel: launches})."""
    import torch
    fns = kernel_fns()
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in fns.items()}
    missing = [k for k in BRANCH_KERNELS[path] if counts[k] <= 0]
    if missing:
        raise AssertionError(f"path {path!r} did not launch {missing}")
    return out, counts


def bound(n_bytes: float, flops: float) -> dict:
    """Least time the card could take: the larger of bytes over the HBM
    rate and fp32 operations over the fp32 peak."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / FP32_FLOP_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a, b) -> float:
    """Largest absolute difference over matching outputs (nested tuples of
    tensors)."""
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
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


def cuda_ms(fn, reps: int = 1):
    """Mean device milliseconds of fn() over reps runs (CUDA events), and
    the last result."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
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
    tn = np.tile(np.arange(1, L + 1, dtype=np.float32) / FS, (B, 1))
    return re, im, tn


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
         seconds=round(time.time() - t0, 3), ptxas=ptxas)


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
    params = chain.make_params(POES_TIP, FS)
    B, L = 256, 4096
    re, im, tn = test_input(B, L)
    r16 = np.clip(np.round(re * 32768.0), -32768, 32767).astype(np.int16)
    i16 = np.clip(np.round(im * 32768.0), -32768, 32767).astype(np.int16)
    st = pll.init_state(params.pll, (B,), device=dev)
    gain = torch.full((B,), 17.58, device=dev)
    t_next = torch.from_numpy(tn).to(dev)
    for name, (a, b) in (("f32", (re, im)), ("int16", (r16, i16))):
        z = (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
        plain_ms, ref = cuda_ms(
            lambda: fused_demod_ref(params, st, gain, z, t_next))
        fused_demod(params, st, gain, z, t_next)          # warm-up
        ms, kern = cuda_ms(lambda: fused_demod(params, st, gain, z, t_next),
                           reps=5)
        c = compare(kern, ref, FS)
        check_parity(c, f"kernel vs plain ({name})")
        emit("kernel_vs_plain", input=name, B=B, L=L, ms=ms,
             plain_ms=plain_ms, card=card_line(), **c)

    # the capture-latch guard refuses geometries the latch cannot serve
    bad = params._replace(step_size=4.0, baud=FS * 3 / 4.0)
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
    runs).  Keeps the worst error and the slowest plain time per kernel."""
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
    params = chain.make_params(POES_TIP, FS)
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


def frame_parity(a, b, fs: float) -> dict:
    """Frame-level parity: counts, payloads, timestamp shifts."""
    if len(a) != len(b):
        raise AssertionError(f"frame counts differ: {len(a)} vs {len(b)}")
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


def phase_slice():
    """The slice on the CPU (plain versions) against the card (kernels),
    on each branch."""
    from project_desert_tortoise_tpu_torch.parallel.blocked import (
        BlockPlan, demodulate_blocked)
    from project_desert_tortoise_tpu_torch.utils import synth, wav as W
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

    iq, _ = synth.make_poes_recording(n_frames=40, fs=FS)
    t = W.time_axis(len(iq), FS, np.float32)
    plan = BlockPlan(*SMALL_PLAN)
    for br in ("fused", "front", False):
        t0 = time.time()
        cpu = demodulate_blocked(iq, t, FS, POES_TIP, plan=plan,
                                 use_pallas=br, device="cpu")
        t1 = time.time()
        gpu = demodulate_blocked(iq, t, FS, POES_TIP, plan=plan,
                                 use_pallas=br, device="cuda")
        t2 = time.time()
        emit("slice_cpu_vs_card", use_pallas=br, cpu_s=t1 - t0,
             card_s=t2 - t1, **frame_parity(cpu, gpu, FS))


def phase_main_path(workdir: str):
    """A 12-minute pass through demod_poes --fast on the card.  Returns
    the WAV's path, the CLI's wall seconds, the kernels' launches, the
    synthesized payloads and the (timestamp, payload) lines written."""
    from project_desert_tortoise_tpu_torch.apps import demod_poes
    from project_desert_tortoise_tpu_torch.utils import synth, wav as W
    from project_desert_tortoise_tpu_torch.utils.output import (
        parse_frames_file)

    # frame 0 is the acquisition lead-in (the receiver locks during it, as
    # on a real pass that is entered mid-stream); frames 1..7200 are checked
    t0 = time.time()
    iq, frames = synth.make_poes_recording(n_frames=PASS_FRAMES + 1, fs=FS)
    wav = os.path.join(workdir, "pass.wav")
    W.write_iq_wav(wav, iq / (np.abs(iq).max() * 1.2), int(FS))
    emit("synth", samples=len(iq), frames=PASS_FRAMES + 1,
         seconds=time.time() - t0)
    del iq

    out = os.path.join(workdir, "frames.txt")
    t0 = time.time()
    rc, counts = drive("fused", lambda: demod_poes.run(
        [wav, "--fast", "--out", out]))
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"demod_poes exited {rc}")
    lines = [(f"{t:.5f}", bytes(b)) for t, _, b in parse_frames_file(out)]
    emit("main_path", use_pallas="fused", launches=counts, wall_s=wall,
         card=card_line(), **payload_check([b for _, b in lines], frames))
    return wav, wall, counts, frames, lines


def payload_check(got, frames) -> dict:
    """Every payload of frames 1..7200 exactly once (frame 0 is the
    acquisition lead-in)."""
    counts = {}
    for g in got:
        counts[g] = counts.get(g, 0) + 1
    want = [bytes(f) for f in frames[1:]]
    missing = sum(counts.get(w, 0) == 0 for w in want)
    dup = sum(counts.get(w, 0) > 1 for w in want)
    if missing or dup:
        raise AssertionError(f"{missing} payloads missing, {dup} repeated "
                             f"of {len(want)}")
    return dict(frames_written=len(got), recovered=len(want) - missing,
                of=len(want), lead_in_recovered=counts.get(bytes(frames[0]), 0))


def phase_branch_path(wav: str, br, frames, fused_lines):
    """The 12-minute pass through ``demodulate_blocked(use_pallas=br)`` on
    the card with the default plan, from the WAV: every payload once, the
    branch's kernels launched, wall seconds, peak device memory, and how
    many frames match the fused path's in payload and timestamp."""
    import torch
    from project_desert_tortoise_tpu_torch.parallel.blocked import (
        demodulate_blocked)
    from project_desert_tortoise_tpu_torch.utils import wav as W
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()

    def run():
        iq, t, fs, _ = W.load_iq_wav(wav)
        return demodulate_blocked(iq, t, fs, POES_TIP, use_pallas=br,
                                  device="cuda")
    got, counts = drive(br, run)
    wall = time.time() - t0
    fused = set(fused_lines)
    same = sum((f"{f.time:.5f}", bytes(f.data)) in fused for f in got)
    emit("main_path", use_pallas=br, launches=counts, wall_s=wall,
         peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
         frames_as_fused=same, fused_frames=len(fused_lines),
         card=card_line(),
         **payload_check([bytes(f.data) for f in got], frames))
    return counts


def timed(stages: dict, name: str, fn):
    """fn(), then a device synchronise; its host seconds go to stages."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    stages[name] = time.perf_counter() - t0
    return out


def phase_stages(wav: str, workdir: str, cli_wall: float, reps: int = 2):
    """Where the main path's time goes: the steps of demod_poes --fast
    (parallel/blocked.py::demodulate_blocked and the frame writer) once
    more, one by one, on the host clock with a device synchronise after
    each.  Returns the last run's staged blocks for the kernel phase."""
    import torch
    from project_desert_tortoise_tpu_torch import chain
    from project_desert_tortoise_tpu_torch.ops import agc
    from project_desert_tortoise_tpu_torch.parallel import blocked
    from project_desert_tortoise_tpu_torch.utils import wav as W
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP
    from project_desert_tortoise_tpu_torch.utils.output import FrameWriter

    dev = torch.device("cuda")
    dt = np.dtype(np.float32)
    for rep in range(reps):
        st = {}
        iq, t, fs, _ = timed(st, "load_wav", lambda: W.load_iq_wav(wav))
        params = chain.make_params(POES_TIP, fs)
        plan = blocked.default_plan(POES_TIP, fs)
        n = len(iq)

        def planes():
            norm = agc.static_gain(iq[:POES_TIP.chunk_size],
                                   POES_TIP.static_gain_level, dt)
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
            zre, zim, fs, POES_TIP.gardner.baud / 2.0))
        stitched = timed(st, "demod_frames", lambda: blocked.demod_frames(
            params, plan, POES_TIP.framer, fs, zre, zim, lo, n, fest, norm))
        frames = timed(st, "fetch",
                       lambda: blocked._fetch_frames(stitched, t_ext))

        def write():
            with FrameWriter(os.path.join(workdir, "stages.txt"),
                             inverted_mark=POES_TIP.framer.inverted_mark) as w:
                w.write_all(frames)
        timed(st, "write", write)
        emit("stages", rep=rep, frames=len(frames), total_s=sum(st.values()),
             cli_wall_s=cli_wall, card=card_line(),
             **{k + "_s": v for k, v in st.items()})
    return params, plan, fs, n, norm, zre, zim, lo, fest


def phase_kernel_at_main_shape(params, plan, fs, n, norm, zre, zim, lo, fest,
                               cli_wall: float) -> dict:
    """The fused kernel on the blocks the main path stages, timed (CUDA
    events) and held against its plain version on the same inputs."""
    from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
        fused_demod, fused_demod_ref)
    from project_desert_tortoise_tpu_torch.parallel import blocked

    t_next = blocked.sample_positions(lo, n, plan.total, 1)
    st, gain = blocked.warm_state(params, fest, fs, norm)
    ms, kern = cuda_ms(lambda: fused_demod(params, st, gain, (zre, zim),
                                           t_next))
    plain_ms, ref = cuda_ms(
        lambda: fused_demod_ref(params, st, gain, (zre, zim), t_next))
    c = compare(kern, ref, 1.0)       # bit times are sample positions here
    check_parity(c, "kernel vs plain at the main path's shape")
    B, L = zre.shape
    emit("main_path_kernel", kernel="fused_demod", B=B, L=L, kernel_ms=ms,
         plain_ms=plain_ms, kernel_share_of_cli_wall=ms / 1e3 / cli_wall,
         card=card_line(), **c)
    # f32 re, im and time in; merged bit plane and bit time out; ~240 flops
    # a sample (PLL ~40 counting sinf/cosf as one each, FIR 156, AGC 24,
    # Gardner and Manchester ~20)
    return dict(max_abs_err=c["max_abs_err"], ms=ms, plain_ms=plain_ms,
                shape=[B, L], plain_shape=[B, L],
                **bound(B * L * 20.0, B * L * 240.0))


def phase_new_kernels_at_main_shape(params, plan, fs, n, norm, zre, zim, lo,
                                    fest, stats: dict, window: int = 4096):
    """The kernels of the front and scan branches against their plain
    versions on the inputs demod_blocks gives them on the main path: its
    lanes, warm PLL state and gains, cut to the first MAIN_CHECK_L samples,
    and its Gardner layout (windows of window * interp), each bit-exact.
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

    B, L, interp = zre.shape[0], MAIN_CHECK_L, params.interp
    z = tuple(x[:, :L].contiguous() for x in (zre, zim))
    pos = blocked.sample_positions(lo, n, plan.total, 1 if interp > 1 else 0)
    pos = pos[:, :L].contiguous()
    pst, gain0 = blocked.warm_state(params, fest, fs, norm)
    case = "main path blocks"
    time_pair("pll_fir_agc", case,
              lambda: pll_fir_agc(params, pst, gain0, z),
              lambda: pll_fir_agc_ref(params, pst, gain0, z), [B, L], stats)
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
    emit("fir_interp_vs_float64", shape=list(x.shape), max_abs_err=err,
         tolerance=1e-5 * scale, tf32_max_abs_err=tf32_fir_err(
             soft, params.taps, interp, exact), card=card_line())
    if err > 1e-5 * scale:
        raise AssertionError(f"fir_interp on the card is {err} from the "
                             "float64 sum: not full float32")
    ap = sk.AGCParams(params.agc_attack, params.agc_decay)
    time_pair("agc_scan", case, lambda: sk.agc_scan(gain0, x, ap),
              lambda: sk.agc_scan_ref(gain0, x, ap), list(x.shape), stats)
    _, y_scan = sk.agc_scan(gain0, x, ap)
    _, _, y_front, _ = pll_fir_agc(params, pst, gain0, z)

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
    for br, y in (("front", y_front), ("scan", y_scan)):
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


def phase_branch_stages(params, plan, fs, n, norm, zre, zim, lo, fest, br,
                        window: int = 4096) -> dict:
    """The steps of demod_blocks(use_pallas=br) on the blocks the main path
    stages, one by one, each timed by CUDA events, then the whole of
    demod_frames on the host clock.  Returns each kernel's ms and bound at
    this shape."""
    from project_desert_tortoise_tpu_torch.ops import clock, fir
    from project_desert_tortoise_tpu_torch.ops import manchester as man
    from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
    from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
        pll_fir_agc)
    from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
        pll_scan_kernel)
    from project_desert_tortoise_tpu_torch.parallel import blocked
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

    B, L = zre.shape
    interp = params.interp
    pos = blocked.sample_positions(lo, n, plan.total, 1)
    pst, gain0 = blocked.warm_state(params, fest, fs, norm)
    ms = {}

    def step(name, fn):
        ms[name], out = cuda_ms(fn)
        return out
    if br == "front":
        _, _, y, _ = step("pll_fir_agc", lambda: pll_fir_agc(
            params, pst, gain0, (zre, zim)))
    else:
        _, soft, _ = step("pll_scan", lambda: pll_scan_kernel(
            params.pll, pst, (zre, zim)))
        x = step("fir_interp", lambda: fir.fir_interp(soft, params.taps,
                                                      interp))
        _, y = step("agc_scan", lambda: sk.agc_scan(
            gain0, x, sk.AGCParams(params.agc_attack, params.agc_decay)))
    t_out = step("fir_out_times", lambda: fir.fir_out_times(pos, interp))
    _, _, bits, btimes, mask = step(
        "gardner_manchester", lambda: clock.gardner_manchester_windowed(
            clock.gardner_init((B,), device=zre.device),
            man.manchester_init((B,), device=zre.device), y, t_out,
            L * interp, params.step_size, params.gardner_err_limit,
            params.gardner_gain, params.resync_threshold,
            window=window * interp))
    step("compress_sorted", lambda: man.compress_sorted(
        bits, btimes, mask, bits.shape[-1] // 2 + 8))
    t0 = time.perf_counter()
    blocked.demod_frames(params, plan, POES_TIP.framer, fs, zre, zim, lo, n,
                         fest, norm, window, br)
    import torch
    torch.cuda.synchronize()
    emit("stages", use_pallas=br, B=B, L=L, card=card_line(),
         demod_frames_s=time.perf_counter() - t0,
         **{k + "_ms": v for k, v in ms.items()})
    # bytes each input read once, each output written once; operations
    # counted from the sources (sinf/cosf one each): PLL ~40 a sample, FIR
    # 2*78 and AGC 8 per output, Gardner+Manchester ~30 per symbol
    n_sym = 2.0 * float(mask.sum())          # two symbols per emitted bit
    out = {"gardner_manchester": dict(
        ms=ms["gardner_manchester"], shape=list(y.shape), **bound(
            n_sym * 12.0 + bits.numel() * 6.0, n_sym * 30.0))}
    if br == "front":
        out["pll_fir_agc"] = dict(ms=ms["pll_fir_agc"], shape=[B, L], **bound(
            B * L * (8.0 + 4 * interp + 4),
            B * L * (40.0 + 8 * interp + 2 * 78)))
    else:
        out["pll_scan"] = dict(ms=ms["pll_scan"], shape=[B, L],
                               **bound(B * L * 16.0, B * L * 40.0))
        out["agc_scan"] = dict(ms=ms["agc_scan"], shape=[B, L * interp],
                               **bound(B * L * interp * 8.0,
                                       B * L * interp * 8.0))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.time()
    phase_toolchain()
    phase_build()
    phase_kernel()
    stats = {}
    phase_new_kernels(stats)
    phase_slice()
    launches = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory() as workdir:
        wav, wall, counts, frames, lines = phase_main_path(workdir)
        paths = [counts]
        for br in ("front", False):
            paths.append(phase_branch_path(wav, br, frames, lines))
        staged = phase_stages(wav, workdir, wall)
    for counts in paths:
        for k, v in counts.items():
            launches[k] += v
    stats["fused_demod"] = phase_kernel_at_main_shape(*staged, cli_wall=wall)
    phase_new_kernels_at_main_shape(*staged, stats)
    for br in ("front", False):
        for k, v in phase_branch_stages(*staged, br).items():
            stats[k].update(v)
    jax_pkg = "project_desert_tortoise_tpu"
    if any(m in ("jax", jax_pkg) or m.startswith(("jax.", jax_pkg + "."))
           for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    emit("total", seconds=time.time() - t_start)
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=src, replaces=rep,
        launches=launches[name], library_ms=None, **stats[name])
        for name, (src, rep) in KERNELS.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

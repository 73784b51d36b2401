"""Block-parallel demodulation: the fast path of a whole recording.

Counterpart of ``project_desert_tortoise_tpu/parallel/blocked.py``.  The
recording is cut into overlapping ``[head | core | tail]`` blocks; each
block's PLL is warm-started from an FFT estimate of its own carrier, every
block is one lane of the chain, and the frames found in each block are kept
when their sync falls inside the block's core, which tiles the recording
exactly.

The chain runs on one of three branches, JAX's ``use_pallas`` values:
``"fused"`` (the whole chain in one kernel, ``ops/kernels/fused_kernel.py``),
``"front"`` (PLL + FIR + AGC in one kernel,
``ops/kernels/chain_kernel.py``, then the windowed Gardner/Manchester
kernel) and ``False`` (the PLL kernel, the FIR as a convolution, the AGC
kernel, then the same Gardner/Manchester kernel; the default, as in JAX,
and what both packages' ``--fast`` CLIs run).

Lanes are the only parallel axis on the card, so by default all blocks of a
recording go into one launch (capped by a memory budget); the JAX package's
TPU rules (64 blocks per dispatch, ``B % 128``) do not apply.

Stitching works on exact sample positions.  The chain's bit times are,
per lane, the block-local position of the sample whose time the chain
reports (exact in float32): the fused kernel generates them itself (time
generation with step 1 from per-block seeds), the unfused branches read a
staged position plane.  Frames are kept when their global sync position
lies in the block's core and are then labelled with the reference's
float32 accumulated time axis at that position.  The JAX package stitches
on that time axis itself, which gives the same frames while the axis
increases, but the axis stops advancing at 512 s (Ts = 20 us at 50 kHz is
below half its ulp there), so on a 12-minute pass its core intervals go
empty and a third of the frames are dropped.  Timestamps are the reference's
either way.
"""

from __future__ import annotations

import itertools
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from project_desert_tortoise_tpu_torch import chain as chain_lib
from project_desert_tortoise_tpu_torch.ops import agc as agc_ops
from project_desert_tortoise_tpu_torch.ops import bitpack
from project_desert_tortoise_tpu_torch.ops import clock as clock_ops
from project_desert_tortoise_tpu_torch.ops import fir as fir_ops
from project_desert_tortoise_tpu_torch.ops import framer as framer_ops
from project_desert_tortoise_tpu_torch.ops import manchester as man_ops
from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.ops.framer import Frame
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    pll_fir_agc)
from project_desert_tortoise_tpu_torch.ops.kernels.common import (
    resolve_device)
from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
    fused_demod)
from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
    pll_scan_kernel)

# device bytes one (lane, input sample) needs across each branch: input,
# time and output planes and the compaction temporaries; the two unfused
# branches also hold the interpolated stream (`interp` values per sample)
# and its time plane.  About 1.5x the peaks measured on a 12-minute POES
# pass, the larger of the two passes per sample: 51.9 bytes ("front") and
# 60.0 (False) above what was held before (PERF.md).
_LANE_SAMPLE_BYTES = {"fused": 64, "front": 78, False: 90}
_BATCH_BYTES = 8 << 30


class BlockPlan(NamedTuple):
    core: int          # samples per block core
    head: int          # warm-up halo samples
    tail: int          # frame-completion halo samples
    max_frames: int    # frame capacity per block

    @property
    def total(self) -> int:
        return self.head + self.core + self.tail


def default_plan(mode_cfg, fs: float, core: Optional[int] = None,
                 align: int = 4096) -> BlockPlan:
    fr = mode_cfg.framer
    bit_rate = mode_cfg.gardner.baud / 2.0
    frame_s = (fr.payload_bits + fr.sync_len + 8) / bit_rate
    up = lambda v: -(-int(v) // align) * align
    tail = up(np.ceil(frame_s * fs) + 256)
    head = up(0.25 * fs)               # PLL/AGC/timing settle (>= 0.25 s)
    core = up(core or 2.0 * fs)        # 2 s default
    max_frames = int(np.ceil((core + tail) / fs / (fr.payload_bits / bit_rate))) + 4
    return BlockPlan(core=core, head=head, tail=tail, max_frames=max_frames)


def branch(use_pallas):
    """The branch a JAX ``use_pallas`` value names: "fused", "front"
    (also True, as in JAX) or False."""
    if use_pallas is True:
        return "front"
    if use_pallas in ("fused", "front") or use_pallas is False:
        return use_pallas
    raise ValueError(f"use_pallas={use_pallas!r}: expected False, 'front' "
                     "(or True) or 'fused'")


def max_lanes(plan: BlockPlan, use_pallas=False) -> int:
    """Blocks per launch that fit the memory budget of the branch."""
    return max(1, _BATCH_BYTES // (plan.total
                                   * _LANE_SAMPLE_BYTES[branch(use_pallas)]))


def coarse_carrier_est(zre, zim, fs: float, line_spacing_hz: float = 8320.0,
                       nfft: int = 8192):
    """Per-block data-aided carrier estimate from the BPSK squared spectrum
    (JAX blocked.py:109-151).

    Squared Manchester BPSK carries spectral lines at 2*f0 + k*bitrate with
    magnitudes symmetric in k, so the circular power centroid of the
    noise-floor-subtracted squared spectrum estimates 2*f0, and the
    strongest line within half a line spacing of it is the k=0 line.
    Welch-averaged over up to 4 spread length-nfft segments.  Returns Hz.
    """
    if zre.dtype == torch.int16:      # int16-staged PCM planes (wave.c:117)
        zre = zre.to(torch.float32) * (1.0 / 32768.0)
        zim = zim.to(torch.float32) * (1.0 / 32768.0)
    lead = tuple(zre.shape[:-1])
    n = zre.shape[-1]
    k = max(n // nfft, 1)
    re = zre[..., :k * nfft].reshape(lead + (k, nfft))
    im = zim[..., :k * nfft].reshape(lead + (k, nfft))
    if k > 4:   # cap the Welch average at 4 spread segments
        stride = k // 4
        re = re[..., ::stride, :][..., :4, :]
        im = im[..., ::stride, :][..., :4, :]
    z = torch.complex(re, im)
    freqs = torch.fft.fftfreq(nfft, 1.0 / fs, dtype=torch.float32,
                              device=zre.device)

    sq = torch.abs(torch.fft.fft(z * z, dim=-1)).sum(-2)
    w = torch.clamp(sq - sq.mean(-1, keepdim=True), min=0.0) ** 2
    ph = torch.polar(torch.ones_like(freqs), (2 * np.pi / fs) * freqs)
    cen = torch.angle((w * ph).sum(-1)) * (fs / (2 * np.pi))

    d = torch.remainder(freqs - cen[..., None] + fs / 2, fs) - fs / 2
    masked = torch.where(torch.abs(d) < line_spacing_hz / 2.0, sq, 0.0)
    f0 = freqs[torch.argmax(masked, dim=-1)] / 2.0
    return f0.to(torch.float32)


def warm_state(params: chain_lib.ChainParams, freq_est, fs: float,
               norm_gain: float):
    """Per-block kernel state: the PLL in tracking mode at the coarse
    carrier estimate (no acquisition sweep), the AGC at the static gain.
    Returns (pll_state, agc_gain) lanes on freq_est's device."""
    B = freq_est.shape[0]
    dev = freq_est.device
    pll_state = pll_ops.init_state(params.pll, (B,), device=dev)
    pll_state = pll_state._replace(
        freq=float(np.float32(2.0 * np.pi / fs)) * freq_est,
        locked=torch.ones((B,), dtype=torch.bool, device=dev))
    gain0 = torch.full((B,), float(np.float32(norm_gain)),
                       dtype=torch.float32, device=dev)
    return pll_state, gain0


def demod_blocks(params: chain_lib.ChainParams, total: int, blocks_re,
                 blocks_im, fs: float, t_next, freq_est, norm_gain: float,
                 window: int = 4096, use_pallas=False, t_seed=None,
                 t_pad0=None, ts: float = 0.0):
    """Demodulate (B, total) sample blocks -> compressed per-block bits
    (JAX ``demod_blocks``, ``blocked.py:175-323``).

    t_next: (B, total) float32 time plane, the values the chain reports as
    bit times (here :func:`sample_positions`), or None for the fused
    kernel's time generation from ``t_seed`` and ``t_pad0`` (B,) with step
    ``ts`` (1 for sample positions, as :func:`demod_frames` uses); the
    unfused branches need the plane and raise ``ValueError`` without it,
    as in JAX.  freq_est: (B,)
    coarse carrier in Hz.  use_pallas picks the branch (:func:`branch`);
    window: input samples per Gardner window of the unfused branches (JAX's
    default), which fixes their slot layout; where it does not divide
    `total` (or is 0), Gardner/Manchester runs over the whole block in one
    scan instead, as JAX falls back (``gardner_manchester_scan``).
    Returns (bits (B, cap) uint8, bit_times, n_bits, avg_phase).
    """
    use_pallas = branch(use_pallas)
    if t_next is None and use_pallas != "fused":
        raise ValueError("t_next=None (in-kernel time generation) requires "
                         "the fused branch: use_pallas='fused'")
    pll_state, gain0 = warm_state(params, freq_est, fs, norm_gain)
    if use_pallas == "fused":
        bits_f, btimes_f, emit_f, avg_phase = fused_demod(
            params, pll_state, gain0, (blocks_re, blocks_im), t_next,
            t_seed, t_pad0, ts)
        # bit emissions are >= ~6 input samples apart (one per 2 Gardner
        # symbols), so a 4-sample chunk holds at most one
        max_bits = total // 4 + 8
        bits_c, times_c, n_bits = man_ops.compress_spaced(
            bits_f.to(torch.uint8), btimes_f, emit_f, max_bits,
            min_spacing=4)
        return bits_c, times_c, n_bits, avg_phase

    if window and total % window:
        window = 0          # JAX's fallback for odd sizes (blocked.py:210)
    interp = params.interp
    if params.squelch_position == "after_agc" and interp > 1:
        # JAX squelches y (B, total*interp) with |locksig| (B, total)
        # there, which only broadcasts for interp == 1
        raise ValueError("an after-AGC squelch needs interp == 1 on the "
                         f"unfused branches (interp = {interp})")
    if blocks_re.dtype == torch.int16:     # PCM planes: exact /32768
        blocks_re = blocks_re.to(torch.float32) * (1.0 / 32768.0)
        blocks_im = blocks_im.to(torch.float32) * (1.0 / 32768.0)
    # |locksig| in the squelches: warm-started blocks may settle at the
    # inverted BPSK lock point (JAX blocked.py:274-282)
    if use_pallas == "front":
        pll_state, _, y, locksig = pll_fir_agc(
            params, pll_state, gain0, (blocks_re, blocks_im))
    else:
        pll_state, soft, locksig = pll_scan_kernel(
            params.pll, pll_state, (blocks_re, blocks_im))
        if params.squelch_position == "after_pll":
            soft = agc_ops.squelch(soft, torch.abs(locksig),
                                   params.squelch_threshold)
        y = fir_ops.fir_interp(soft, params.taps, interp)
        _, y = agc_ops.agc_scan(agc_ops.AGCState(gain=gain0), y,
                                params.agc_attack, params.agc_decay)
    if params.squelch_position == "after_agc":
        y = agc_ops.squelch(y, torch.abs(locksig), params.squelch_threshold)
    t_out = fir_ops.fir_out_times(t_next, interp) if interp > 1 else t_next

    B, dev = blocks_re.shape[0], blocks_re.device
    g0 = clock_ops.gardner_init((B,), device=dev)
    m0 = man_ops.manchester_init((B,), device=dev)
    n_i = total * interp
    if window:
        _, _, bits, bit_times, bit_mask = \
            clock_ops.gardner_manchester_windowed(
                g0, m0, y, t_out, n_i, params.step_size,
                params.gardner_err_limit, params.gardner_gain,
                params.resync_threshold, window=window * interp)
        max_bits = bits.shape[-1] // 2 + 8
    else:
        # the whole block in one scan (JAX blocked.py:313-319)
        max_syms = int(n_i / params.step_size * 1.02) + 16
        max_bits = max_syms // 2 + 8
        *_, bits, bit_times, bit_mask = clock_ops.gardner_manchester_scan(
            g0, m0, y, t_out, n_i, params.step_size,
            params.gardner_err_limit, params.gardner_gain,
            params.resync_threshold, max_syms)
    bits_c, times_c, n_bits = man_ops.compress_sorted(
        bits, bit_times, bit_mask, max_bits)
    return bits_c, times_c, n_bits, pll_state.avg_phase


def sample_positions(lo, n, total: int, shift: int):
    """The kernel's time plane for blocks whose first samples have global
    indices `lo` (B,): at step i the block-local position i + shift of the
    sample whose time the chain reports (LowPassFilter.c:68 reports sample
    i+1 for interpolating modes), exact in float32; -1 where the window lies
    outside the recording's n samples (an int, or a (B,) tensor of each
    block's stream length where the blocks come from several streams)."""
    i = torch.arange(total, device=lo.device)
    g = lo[:, None] + i[None, :]
    if torch.is_tensor(n):
        n = n[:, None]
    local = (i + shift).to(torch.float32).expand(len(lo), total)
    return torch.where((g >= 0) & (g < n), local, -1.0)


def position_seeds(lo, shift: int):
    """Time generation's inputs that reproduce :func:`sample_positions`
    with step 1: each block's count of zero-padded head samples (only a
    block that starts before the recording has any) and the position of
    its first valid sample.  The generated values equal the plane wherever
    the window lies inside the recording; past its end they go on
    counting where the plane holds -1, at positions the stitcher drops
    either way (the core bound is clamped at n).  Returns (t_seed, t_pad0)
    float32 (B,)."""
    pad0 = torch.clamp(-lo, min=0).to(torch.float32)
    return pad0 + float(shift), pad0


def demod_frames(params: chain_lib.ChainParams, plan: BlockPlan, framer_cfg,
                 fs: float, blocks_re, blocks_im, lo, n, freq_est,
                 norm_gain: float, window: int = 4096, use_pallas=False,
                 chan=None):
    """demod_blocks + frame extraction + stitching on sample positions.

    lo: (B,) int64 global index of each block's first sample; n: samples in
    the recording, or a (B,) int64 tensor of each block's stream length
    (the blocks of several streams in one batch).  The fused branch
    generates the positions in its kernel (:func:`position_seeds`); the
    others read the staged plane.  Returns packed (positions float64,
    inverted, data, count) on the blocks' device: the global sample
    position of each kept frame's sync, in stream order
    (:func:`_fetch_frames` labels them).  With ``chan`` (B,) channel ids
    (JAX's ``extract_stitch_chan``) the blocks may mix channels: the
    frames come sorted by (channel, position), with a fifth array of
    channel ids."""
    shift = 1 if params.interp > 1 else 0
    if branch(use_pallas) == "fused":
        pos, (seed, pad0) = None, position_seeds(lo, shift)
    else:
        pos, seed, pad0 = sample_positions(lo, n, plan.total, shift), None, None
    bits_c, pos_c, n_bits, _ = demod_blocks(
        params, plan.total, blocks_re, blocks_im, fs, pos, freq_est,
        norm_gain, window, use_pallas, seed, pad0, ts=1.0)
    B = blocks_re.shape[0]
    fb = framer_ops.frame_extract(bits_c, pos_c, n_bits, framer_cfg,
                                  plan.max_frames)
    fb = fb._replace(times=fb.times.to(torch.float64) + lo[:, None])
    cs = lo + plan.head
    bounds = torch.stack([cs, torch.clamp(cs + plan.core, max=n)], 1)
    return framer_ops.stitch_frames(fb, bounds, B * plan.max_frames, chan)


def demod_frames_flat(params: chain_lib.ChainParams, framer_cfg,
                      plan: BlockPlan, B: int, fs: float, window: int,
                      use_pallas, re_flat, im_flat, norm_gain: float,
                      n: Optional[int] = None, lo0: Optional[int] = None,
                      pre_staged: bool = False, pack_bits: int = 0):
    """Whole-file demodulation from flat sample planes already on the
    device: the B overlapping block windows are cut there, then
    :func:`coarse_carrier_est` and :func:`demod_frames` (JAX
    ``demod_frames_flat``, ``blocked.py:364-455``).  Returns the stitched
    (positions, inverted, data, count) of :func:`demod_frames`;
    :func:`_fetch_frames` labels them with the time axis on the host (no
    time plane is uploaded: the kernels report sample positions).

    re_flat/im_flat: (n,) float32 or int16 (int16 stays int16 through the
    windowing, converted with the exact /32768 downstream), or, with
    ``pack_bits`` > 0, (ng, pack_bits) int32 words of ``ops/bitpack.py``
    covering ng*32 samples, unpacked on the device to int16.  Window k is
    ``[k*core, k*core + total)`` of the plane led by ``head`` zeros (the
    stream start), or, with ``pre_staged`` (the pipelined slices), of the
    plane as it is: it already starts with block 0's head region; samples
    past the plane read as zero.  n: samples in the recording (default:
    the plane's), which bounds the last core and marks positions past it;
    lo0: the global index of window 0's first sample (default -head, the
    whole file; a slice's is its first block's start less head).  The
    carrier estimate's line spacing is JAX's flat path's, fs * interp /
    (2 * step_size)."""
    total, core, head = plan.total, plan.core, plan.head
    if pack_bits:
        ns = re_flat.shape[0] * bitpack.GROUP
        # the unpacked values fit int16 by construction (pack_bits <= 16)
        re_flat = bitpack.unpack(re_flat, pack_bits, ns).to(torch.int16)
        im_flat = bitpack.unpack(im_flat, pack_bits, ns).to(torch.int16)
    if n is None:
        n = re_flat.shape[0]
    if lo0 is None:
        lo0 = -head
    plen = (B - 1) * core + total
    hn = 0 if pre_staged else head

    def windows(x):
        # the zero-led plane, cut or zero-extended to plen, then all B
        # windows as one strided view and one copy
        x = x[:plen - hn]
        p = torch.nn.functional.pad(x, (hn, plen - hn - x.shape[0]))
        return p.unfold(0, total, core).contiguous()

    brs, bis = windows(re_flat), windows(im_flat)
    dev = brs.device
    lo = lo0 + core * torch.arange(B, dtype=torch.int64, device=dev)
    line_spacing = fs * params.interp / (2.0 * params.step_size)
    fest = coarse_carrier_est(brs, bis, fs, line_spacing)
    return demod_frames(params, plan, framer_cfg, fs, brs, bis, lo, n, fest,
                        norm_gain, window, use_pallas)


def stage_flat_slices(plan: BlockPlan, B: int, n_slices: int, re16, im16,
                      pack: int = 0):
    """Host staging of :func:`demod_frames_flat_pipelined` (JAX
    ``stage_flat_slices``, ``blocked.py:511-573``): every slice ships the
    same ``[head | Bs*core + tail]`` layout for ``demod_frames_flat(
    pre_staged=True)``; the host leads the stream with head zeros, and
    slices overlap by head + tail samples.

    Returns (Bs, slice_np, pack_bits): ``slice_np(k)`` cuts slice k's
    (re, im, lo0), the planes as numpy arrays (int32 words where packed),
    lo0 the global index of its first sample.  pack: 0 ships the planes as
    they are, -1 the minimal lossless width of the data (integer planes
    only; a width of 16 ships int16), w > 0 that width; the returned
    pack_bits (0 when off or useless) is what ``demod_frames_flat`` takes.
    JAX's time plane, seeds and bounds have no counterpart: the port
    stitches on positions."""
    core, head, total = plan.core, plan.head, plan.total
    if n_slices < 1 or B % n_slices != 0:
        raise ValueError(f"B={B} must divide into n_slices={n_slices}")
    Bs = B // n_slices
    span = (Bs - 1) * core + total
    if pack and np.dtype(re16.dtype).kind != "i":
        pack = 0                      # packing is for PCM integer planes
    if pack == -1:
        pack = bitpack.pack_width(re16, im16)
    if pack >= 16:
        pack = 0                      # full-width data: ship int16 as-is
    zlead = np.zeros(head, re16.dtype)
    rr = np.concatenate([zlead, re16])
    ii = np.concatenate([zlead, im16])

    def cut_np(a, s0):
        seg = a[s0:s0 + span]
        if len(seg) < span:
            seg = np.concatenate([seg, np.zeros(span - len(seg), a.dtype)])
        return seg

    def slice_np(k):
        s0 = k * Bs * core
        re_k, im_k = cut_np(rr, s0), cut_np(ii, s0)
        if pack:
            re_k = bitpack.pack(re_k, pack).view(np.int32)
            im_k = bitpack.pack(im_k, pack).view(np.int32)
        return re_k, im_k, s0 - head

    return Bs, slice_np, pack


def demod_frames_flat_pipelined(params: chain_lib.ChainParams, framer_cfg,
                                plan: BlockPlan, B: int, fs: float,
                                window: int, use_pallas, re16, im16,
                                t_ext, norm_gain: float, n_slices: int = 4,
                                tgen: bool = False, pack: int = 0,
                                *, device="cuda") -> List[Frame]:
    """Sliced whole-file demodulation with the upload of slice k+1
    overlapping the compute of slice k (JAX
    ``demod_frames_flat_pipelined``, ``blocked.py:458-508``): the planes
    are cut into ``n_slices`` slices of B/n_slices blocks
    (:func:`stage_flat_slices`), each copied from pinned host memory with
    ``non_blocking`` copies on a copy stream while the compute stream runs
    the slice before (it waits on the copy's event before it reads them);
    slice k-1's frames are fetched after slice k is dispatched.  Returns
    the frames in stream order, labelled by `t_ext` (n+1,), the
    reference's float32 accumulated axis.

    re16/im16: (n,) int16 (or float32) host planes.  pack as
    :func:`stage_flat_slices`.  tgen: JAX's in-kernel time generation, for
    the fused branch only (``ValueError`` elsewhere, as JAX's
    ``demod_blocks``); the port generates positions on the fused branch
    either way and uploads no time plane on any.  A CUDA `device` runs the
    kernels, the CPU their plain versions (the planes then go unpinned,
    on one stream)."""
    dev = resolve_device(device)
    if tgen and branch(use_pallas) != "fused":
        raise ValueError("tgen=True (in-kernel time generation) requires "
                         "the fused branch: use_pallas='fused'")
    n = len(re16)
    Bs, slice_np, pack = stage_flat_slices(plan, B, n_slices, re16, im16,
                                           pack)
    cuda = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(dev) if cuda else None

    def upload(k):
        """Slice k's planes on the device, the pinned host copies they
        come from (alive until the copy is done) and the copy's event."""
        re_k, im_k, lo0 = slice_np(k)
        host = [torch.from_numpy(a) for a in (re_k, im_k)]
        if not cuda:
            return host, None, None, lo0
        host = [h.pin_memory() for h in host]
        with torch.cuda.stream(copy_stream):
            planes = [h.to(dev, non_blocking=True) for h in host]
            done = torch.cuda.Event()
            done.record(copy_stream)
        return planes, host, done, lo0

    frames: List[Frame] = []
    pending = None
    nxt = upload(0)
    for k in range(n_slices):
        planes, host, done, lo0 = nxt
        if cuda:
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(done)
            for p in planes:           # allocated on the copy stream
                p.record_stream(compute)
        out = demod_frames_flat(params, framer_cfg, plan, Bs, fs, window,
                                use_pallas, *planes, norm_gain, n=n,
                                lo0=lo0, pre_staged=True, pack_bits=pack)
        if k + 1 < n_slices:
            nxt = upload(k + 1)        # cut and copied during slice k
        # fetch slice k-1 only after dispatching slice k
        if pending is not None:
            frames.extend(_fetch_frames(pending[0], t_ext))
        pending = (out, host)          # the host copy lives to the fetch
    frames.extend(_fetch_frames(pending[0], t_ext))
    frames.sort(key=lambda f: f.time)
    return frames


def _fetch_frames(stitched, t_ext) -> List[Frame]:
    """Host frames from stitched positions, timed by `t_ext` (n+1,)."""
    pos, inv, data, n = (x.cpu().numpy() for x in stitched)
    n = int(n)
    times = t_ext[pos[:n].astype(np.int64)]
    return [Frame(float(times[j]), bool(inv[j]), data[j].copy())
            for j in range(n)]


def _cut_windows(src, n_valid: int, lo0: int, stride: int, bn: int,
                 total: int, dt):
    """Gather bn windows [lo0 + k*stride, +total) of src into a (bn, total)
    array, zero-padding out-of-range samples (a strided window view + one
    bulk copy).  Only the first `n_valid` samples of src are real data."""
    src = np.ascontiguousarray(src)
    hi1 = lo0 + (bn - 1) * stride + total
    if lo0 >= 0 and hi1 <= n_valid:
        base = src[lo0:hi1]
    else:
        pad_l = max(0, -lo0)
        pad_r = max(0, hi1 - n_valid)
        base = np.concatenate([
            np.zeros(pad_l, src.dtype),
            src[max(lo0, 0):min(hi1, n_valid)],
            np.zeros(pad_r, src.dtype)])
    view = np.lib.stride_tricks.as_strided(
        base, shape=(bn, total),
        strides=(stride * base.itemsize, base.itemsize))
    out = np.empty((bn, total), dt)
    out[:] = view                     # one bulk memcpy/convert
    return out


def stage_blocks(re, im, plan: BlockPlan, b0: int, bn: int, dt):
    """Host-side: cut bn overlapping blocks starting at core index b0,
    zero-padded outside the recording.  Returns (blocks_re, blocks_im, lo)
    with lo (bn,) the global index of each block's first sample."""
    n = len(re)
    lo0 = b0 * plan.core - plan.head
    blocks_re = _cut_windows(re, n, lo0, plan.core, bn, plan.total, dt)
    blocks_im = _cut_windows(im, n, lo0, plan.core, bn, plan.total, dt)
    return blocks_re, blocks_im, lo0 + plan.core * np.arange(bn)


def demodulate_blocked(iq, t, fs, mode_cfg, norm_factor: Optional[float] = None,
                       plan: Optional[BlockPlan] = None,
                       batch_blocks: Optional[int] = None,
                       window: int = 4096, use_pallas=False,
                       *, device="cuda") -> List[Frame]:
    """Demodulate a whole recording via parallel blocks on `device`;
    returns complete frames in stream order, timed by `t` (the
    reference's float32 accumulated axis as ``utils/wav.py`` builds it).

    Runs float32.  batch_blocks=None puts every block of the recording into
    one launch, as far as :func:`max_lanes` allows for the branch.  A CUDA
    device runs the kernels; a CPU device runs their plain PyTorch
    versions.

    use_pallas picks the branch ("fused", "front" or True, False; see
    :func:`demod_blocks`).  The default, False, is JAX's default, so the
    two packages' ``--fast`` CLIs run the same branch and compact bits the
    same way (``compress_sorted``).  The port runs the branch it is asked
    for at any block count; JAX silently falls back to its XLA branch
    when B % 128 != 0.
    """
    dev = resolve_device(device)
    dt = np.dtype(np.float32)
    params = chain_lib.make_params(mode_cfg, fs)
    plan = plan or default_plan(mode_cfg, fs)
    n = len(iq)
    if norm_factor is None:
        norm_factor = agc_ops.static_gain(iq[:min(n, mode_cfg.chunk_size)],
                                          mode_cfg.static_gain_level, dt)
    re = np.ascontiguousarray(np.real(iq), dt)
    im = np.ascontiguousarray(np.imag(iq), dt)
    ts = dt.type(1.0) / dt.type(fs)
    t_ext = np.concatenate([np.asarray(t, dt), [dt.type(t[-1] + ts)]]) if n \
        else np.zeros(1, dt)

    n_blocks = max(1, -(-n // plan.core))
    batch_blocks = batch_blocks or max_lanes(plan, use_pallas)
    frames: List[Frame] = []
    pending = None
    for b0 in range(0, n_blocks, batch_blocks):
        bn = min(batch_blocks, n_blocks - b0)
        brs, bis, lo = stage_blocks(re, im, plan, b0, bn, dt)
        jre = torch.from_numpy(brs).to(dev)
        jim = torch.from_numpy(bis).to(dev)
        fest = coarse_carrier_est(jre, jim, float(fs),
                                  mode_cfg.gardner.baud / 2.0)
        stitched = demod_frames(params, plan, mode_cfg.framer, float(fs),
                                jre, jim, torch.from_numpy(lo).to(dev), n,
                                fest, float(norm_factor), window, use_pallas)
        # fetch batch k-1 only after dispatching batch k: host staging of
        # the next batch overlaps device compute of the current one
        if pending is not None:
            frames.extend(_fetch_frames(pending, t_ext))
        pending = stitched
    frames.extend(_fetch_frames(pending, t_ext))
    return frames                     # batches and stitching keep order


def fetch_channel_frames(stitched, label) -> List[tuple]:
    """Host (channel, sync position, Frame) triples from a channel-aware
    stitch, in (channel, position) order; ``label(ci, p)`` is the time of
    channel ci's sample p (its float32 accumulated axis)."""
    pos, inv, data, n, chan = (x.cpu().numpy() for x in stitched)
    n = int(n)
    pos = pos[:n].astype(np.int64)
    out = []
    for j in range(n):
        ci, p = int(chan[j]), int(pos[j])
        out.append((ci, p, Frame(float(label(ci, p)), bool(inv[j]),
                                 data[j].copy())))
    return out


def demodulate_many(iqs, t, fs, mode_cfg, norm_factor: Optional[float] = None,
                    plan: Optional[BlockPlan] = None,
                    batch_blocks: int = 64, dtype=np.float32,
                    *, device="cuda") -> List[List[Frame]]:
    """Multi-channel fast path: demodulate C recordings together (JAX
    ``demodulate_many``, ``blocked.py:712-789``).

    iqs: (C, N) complex (or a list of equal-length recordings) sharing the
    time axis `t`; all channels' blocks are staged into the same batches
    of `batch_blocks` lanes, channel-major, so small recordings still fill
    the lanes (the serving configuration: many satellites or frequencies
    on one card).  Runs JAX's defaults: the scan branch
    (``use_pallas=False``) with 4,096-sample Gardner windows, the norm
    probe on channel 0's first chunk.  Returns a list of per-channel frame
    lists in stream order.
    """
    dev = resolve_device(device)
    dt = np.dtype(dtype)
    if dt != np.float32:
        raise ValueError(f"dtype {dt}: the port's fast path runs float32")
    iqs = np.asarray(iqs)
    C, n = iqs.shape
    params = chain_lib.make_params(mode_cfg, fs)
    plan = plan or default_plan(mode_cfg, fs)
    if norm_factor is None:
        norm_factor = agc_ops.static_gain(iqs[0, :min(n, mode_cfg.chunk_size)],
                                          mode_cfg.static_gain_level, dt)
    ts = dt.type(1.0) / dt.type(fs)
    t_ext = np.concatenate([np.asarray(t, dt), [dt.type(t[-1] + ts)]])
    n_blocks = max(1, -(-n // plan.core))
    res_planes = [np.ascontiguousarray(np.real(ch), dt) for ch in iqs]
    ims_planes = [np.ascontiguousarray(np.imag(ch), dt) for ch in iqs]

    work = [(c, b) for c in range(C) for b in range(n_blocks)]
    res: List[List[Frame]] = [[] for _ in range(C)]
    pending = None

    def drain(stitched):
        for ci, _, fr in fetch_channel_frames(stitched,
                                              lambda ci, p: t_ext[p]):
            res[ci].append(fr)

    for w0 in range(0, len(work), batch_blocks):
        batch = work[w0:w0 + batch_blocks]
        bn = len(batch)
        brs = np.empty((bn, plan.total), dt)
        bis = np.empty((bn, plan.total), dt)
        lo = np.empty(bn, np.int64)
        chan = np.empty(bn, np.int32)
        k = 0
        # one vectorized stage_blocks call per contiguous channel run
        for c, grp in itertools.groupby(batch, key=lambda w: w[0]):
            bs = [b for _, b in grp]
            m = len(bs)
            brs[k:k + m], bis[k:k + m], lo[k:k + m] = stage_blocks(
                res_planes[c], ims_planes[c], plan, bs[0], m, dt)
            chan[k:k + m] = c
            k += m
        jre = torch.from_numpy(brs).to(dev)
        jim = torch.from_numpy(bis).to(dev)
        fest = coarse_carrier_est(jre, jim, float(fs),
                                  mode_cfg.gardner.baud / 2.0)
        stitched = demod_frames(params, plan, mode_cfg.framer, float(fs),
                                jre, jim, torch.from_numpy(lo).to(dev), n,
                                fest, float(norm_factor), 4096, False,
                                torch.from_numpy(chan).to(dev))
        if pending is not None:
            drain(pending)            # fetch batch k-1 after dispatching k
        pending = stitched
    drain(pending)
    return res

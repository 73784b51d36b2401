"""Device-mesh sharding for multi-device demodulation.

Counterpart of ``project_desert_tortoise_tpu/parallel/sharding.py``.  The
mesh has two axes:

- ``ch``: channel parallelism, independent recordings or satellites, each
  mesh row a contiguous group of channels;
- ``blk``: sequence parallelism over time.  A recording is padded to a
  whole number of block cores a shard (:func:`stage_global`) and cut into
  contiguous shards; each shard takes ``head`` samples from its left
  neighbour and ``tail`` from its right (:func:`_halo_exchange`, JAX's
  ``ppermute`` ring; zeros at the stream's edges) and runs the
  block-parallel demodulation of ``parallel/blocked.py`` on its blocks.

A mesh is a ``(n_channel, n_block)`` array of ``torch.device`` entries
(:class:`Mesh`).  An entry may repeat: shards on one device are cut into
blocks there and demodulated in one launch (as far as the branch's memory
budget, :func:`blocked.max_lanes`, allows), which is what a card should
do.  Within a process a halo is a slice copied to its neighbour's device;
between processes it travels through ``torch.distributed``
(``parallel/multihost.py``).

Frames are stitched on global sample positions, as
``blocked.demod_frames`` does: each block is cut with the global index of
its first sample and the recording's true length, so a frame is kept by
the one block whose core holds its sync, wherever the shard edges fall.
JAX stitches on float32 time bounds, which stop advancing at 512 s at
50 kHz.  The JAX package's TPU geometry (lanes padded to 128, a 256-sample
window on the fused branch) does not carry over: the port's defaults hold.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from project_desert_tortoise_tpu_torch import chain as chain_lib
from project_desert_tortoise_tpu_torch.ops import agc as agc_ops
from project_desert_tortoise_tpu_torch.ops.framer import Frame
from project_desert_tortoise_tpu_torch.parallel import blocked as blocked_lib


def _grid(items, n_channel: int, n_block: int) -> np.ndarray:
    """The first n_channel * n_block of `items` as an object array of that
    shape, row-major."""
    out = np.empty((n_channel, n_block), dtype=object)
    for i in range(n_channel * n_block):
        out.flat[i] = items[i]
    return out


class Mesh:
    """A ``(ch, blk)`` grid of mesh entries: ``devices`` holds each entry's
    ``torch.device`` and ``ranks`` the process that owns it (all 0 within
    one process)."""

    def __init__(self, devices: np.ndarray, ranks: Optional[np.ndarray] = None):
        self.devices = devices
        self.ranks = (np.zeros(devices.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64))
        if self.devices.ndim != 2 or self.ranks.shape != self.devices.shape:
            raise ValueError(f"mesh devices {self.devices.shape} and ranks "
                             f"{self.ranks.shape} must be one 2-D shape")

    @property
    def shape(self) -> Dict[str, int]:
        return {"ch": self.devices.shape[0], "blk": self.devices.shape[1]}


def make_mesh(n_channel: int, n_block: int, devices=None) -> Mesh:
    """A (n_channel, n_block) mesh over `devices` (default: every visible
    CUDA device); raises if there are fewer than the mesh needs.  An entry
    may repeat a device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_channel * n_block:
        raise ValueError(f"need {n_channel * n_block} devices, "
                         f"have {len(devices)}")
    return Mesh(_grid(devices, n_channel, n_block))


def _check_halo(loc: int, head: int, tail: int) -> None:
    if head > loc or tail > loc:
        raise ValueError(f"halo (head {head}, tail {tail}) longer than a "
                         f"shard's {loc} local samples: use fewer shards "
                         "or a longer recording")


def _halo_exchange(xs: List[torch.Tensor], head: int, tail: int,
                   left: Optional[torch.Tensor] = None,
                   right: Optional[torch.Tensor] = None
                   ) -> List[torch.Tensor]:
    """``[left halo | local | right halo]`` along the last axis for each
    shard of one mesh row: `xs` the row's shards in ``blk`` order, each on
    its device, all of one shape.  Shard k's left halo is the last `head`
    samples of shard k-1, its right halo the first `tail` of shard k+1,
    copied to shard k's device.  `left` and `right` are the halos of the
    first and the last shard from outside `xs` (another process's
    neighbours); None at the stream's edges, where the halo is zeros."""
    loc = xs[0].shape[-1]
    _check_halo(loc, head, tail)
    lead = tuple(xs[0].shape[:-1])
    out = []
    for k, x in enumerate(xs):
        lh = xs[k - 1][..., loc - head:] if k > 0 else left
        rh = xs[k + 1][..., :tail] if k + 1 < len(xs) else right
        lh = (torch.zeros(lead + (head,), dtype=x.dtype, device=x.device)
              if lh is None else lh.to(x.device))
        rh = (torch.zeros(lead + (tail,), dtype=x.dtype, device=x.device)
              if rh is None else rh.to(x.device))
        out.append(torch.cat([lh, x, rh], -1))
    return out


def _row_columns(keys, row: int) -> List[int]:
    """The ``blk`` columns of mesh row `row` among `keys` ((row, col)
    pairs), sorted; raises unless they are contiguous."""
    cols = sorted(k for r, k in keys if r == row)
    if cols != list(range(cols[0], cols[-1] + 1)):
        raise ValueError(f"mesh row {row}: columns {cols} are not "
                         "contiguous")
    return cols


def sharded_demod_step(params: chain_lib.ChainParams, plan, framer_cfg,
                       fs: float, use_pallas=False):
    """Returns step(shards, norm, n, halos=None) -> a list of channel-aware
    stitched outputs (positions, inverted, data, count, channel) of
    ``blocked.demod_frames``, one a launch.

    shards: {(row, col): (2, C_loc, loc) float32 tensor on that mesh
    entry's device}, the real and imaginary planes of the
    shard's C_loc channels over its loc samples (a multiple of plan.core),
    for the entries this process owns, contiguous columns in each row.
    norm: the norm factor of every channel.  n: the recording's true
    length.  halos: {row: (left, right)}, the halos of the row's first and
    last local shard that come from other processes (see
    :func:`_halo_exchange`).  The carrier estimate's line spacing is
    JAX's, fs * interp / step_size / 2."""
    head, tail, core, total = plan.head, plan.tail, plan.core, plan.total
    line_spacing = fs * params.interp / params.step_size / 2.0
    cap = blocked_lib.max_lanes(plan, use_pallas)

    def step(shards, norm: float, n: int, halos=None):
        halos = halos or {}
        per_device: Dict[torch.device, list] = {}
        for r in sorted({r for r, _ in shards}):
            cols = _row_columns(shards, r)
            hs = _halo_exchange([shards[r, k] for k in cols], head, tail,
                                *halos.get(r, (None, None)))
            for k, h in zip(cols, hs):
                c_loc, loc = h.shape[1], h.shape[2] - head - tail
                # block j covers [j*core, j*core + total) of the haloed
                # shard, global samples from k*loc - head + j*core
                blocks = h.unfold(-1, total, core)
                b_loc = blocks.shape[2]
                lo = (k * loc - head + core * torch.arange(
                    b_loc, dtype=torch.int64, device=h.device))
                chan = r * c_loc + torch.arange(c_loc, dtype=torch.int32,
                                                device=h.device)
                per_device.setdefault(h.device, []).append((
                    blocks.reshape(2, c_loc * b_loc, total),
                    lo.repeat(c_loc), chan.repeat_interleave(b_loc)))
        outs = []
        for parts in per_device.values():
            blocks = torch.cat([p[0] for p in parts], 1)
            lo = torch.cat([p[1] for p in parts])
            chan = torch.cat([p[2] for p in parts])
            for b0 in range(0, len(lo), cap):
                bre = blocks[0, b0:b0 + cap].contiguous()
                bim = blocks[1, b0:b0 + cap].contiguous()
                fest = blocked_lib.coarse_carrier_est(bre, bim, fs,
                                                      line_spacing)
                outs.append(blocked_lib.demod_frames(
                    params, plan, framer_cfg, fs, bre, bim,
                    lo[b0:b0 + cap], n, fest, norm, use_pallas=use_pallas,
                    chan=chan[b0:b0 + cap]))
        return outs
    return step


def stage_global(iq, t, fs, mode_cfg, mesh: Mesh, plan=None,
                 norm_factor: Optional[float] = None):
    """Host staging shared by the single- and multi-process sharded paths
    (JAX ``stage_global``): pad the (C, N) recordings with zeros to a
    global length of n_blk shards of a whole number of block cores each,
    build the reference's float32 accumulated time axis extended by one
    sample, and take the norm factor from channel 0's first chunk for
    every channel, as JAX does.  Runs float32, as ``demodulate_blocked``.

    Returns (params, plan, re, im, t_ext, norm): re and im (C, Np) float32
    numpy planes, t_ext (N+1,) the time of each global sample position,
    norm a float.  Raises if a halo is longer than a shard."""
    dt = np.dtype(np.float32)
    params = chain_lib.make_params(mode_cfg, fs, quirks=False)
    C, N = iq.shape
    n_blk = mesh.shape["blk"]
    plan = plan or blocked_lib.default_plan(mode_cfg, fs)
    loc = -(-N // n_blk)
    loc = -(-loc // plan.core) * plan.core
    _check_halo(loc, plan.head, plan.tail)
    Np = loc * n_blk
    re = np.zeros((C, Np), dt)
    im = np.zeros((C, Np), dt)
    re[:, :N] = np.real(iq)
    im[:, :N] = np.imag(iq)
    ts = dt.type(1.0) / dt.type(fs)
    t_ext = np.concatenate([np.asarray(t, dt), [dt.type(t[-1] + ts)]])
    if norm_factor is None:
        norm_factor = agc_ops.static_gain(
            iq[0, :min(N, mode_cfg.chunk_size)], mode_cfg.static_gain_level,
            dt)
    return params, plan, re, im, t_ext, float(dt.type(norm_factor))


def shard_planes(re, im, mesh: Mesh, row: int, col: int) -> torch.Tensor:
    """Mesh entry (row, col)'s (2, C_loc, loc) planes from the staged (C,
    Np) planes, on its device."""
    n_ch, n_blk = mesh.devices.shape
    C, Np = re.shape
    if C % n_ch:
        raise ValueError(f"{C} channels do not divide into {n_ch} mesh rows")
    c_loc, loc = C // n_ch, Np // n_blk
    rows = slice(row * c_loc, (row + 1) * c_loc)
    cols = slice(col * loc, (col + 1) * loc)
    x = np.stack([re[rows, cols], im[rows, cols]])
    return torch.from_numpy(x).to(mesh.devices[row, col])


def tagged_frames(outs, t_ext) -> List[Tuple[int, int, Frame]]:
    """(channel, global sync position, Frame) of every frame in the
    stitched outputs `outs`, each labelled by the time axis `t_ext`."""
    return [x for stitched in outs for x in blocked_lib.fetch_channel_frames(
        stitched, lambda ci, p: t_ext[p])]


def channel_frames(tagged, C: int) -> List[List[Frame]]:
    """Per-channel frame lists in stream (sync position) order."""
    out: List[list] = [[] for _ in range(C)]
    for c, p, f in sorted(tagged, key=lambda x: (x[0], x[1])):
        out[c].append(f)
    return out


def demodulate_sharded(iq, t, fs, mode_cfg, mesh: Mesh,
                       norm_factor: Optional[float] = None,
                       plan=None, use_pallas=False) -> List[List[Frame]]:
    """Multi-channel, multi-shard demodulation of (C, N) recordings in one
    process.

    iq: (C, N) complex; t: (N,) the time axis every channel shares; C a
    multiple of the mesh's rows.  use_pallas picks the branch of
    ``blocked.demod_blocks`` (False, the default, "front" or "fused").
    Returns a list of per-channel frame lists in stream order."""
    C, N = iq.shape
    params, plan, re, im, t_ext, norm = stage_global(
        iq, t, fs, mode_cfg, mesh, plan, norm_factor)
    n_ch, n_blk = mesh.devices.shape
    shards = {(r, k): shard_planes(re, im, mesh, r, k)
              for r in range(n_ch) for k in range(n_blk)}
    step = sharded_demod_step(params, plan, mode_cfg.framer, float(fs),
                              use_pallas)
    return channel_frames(tagged_frames(step(shards, norm, N), t_ext), C)

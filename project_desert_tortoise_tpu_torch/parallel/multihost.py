"""Multi-process orchestration of the sharded demodulation.

Counterpart of ``project_desert_tortoise_tpu/parallel/multihost.py``.  The
demodulation has no state shared across processes: processes cooperate
only through the ``blk`` halo ring, so a multi-process run is
``torch.distributed`` plus a global mesh whose entries each belong to one
rank.  Typical use, one process per card:

    from project_desert_tortoise_tpu_torch.parallel import multihost as MH
    MH.init()                       # MASTER_ADDR/PORT, WORLD_SIZE, RANK
    mesh = MH.global_mesh(n_channel=1)
    lo, hi = MH.local_time_slice(n_total_samples, mesh)
    frames = MH.demodulate_multihost(iq, t, fs, mode, mesh)

A halo that crosses a process boundary goes through
``dist.batch_isend_irecv`` (every pair's sends and receives in one batch,
so the ring cannot deadlock); one between entries of one process is a
local copy.  Frames are all-gathered as Python objects (they are small),
so every rank returns the same per-channel lists.  NCCL carries the ranks
of CUDA devices, gloo those of the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from project_desert_tortoise_tpu_torch.ops.kernels.common import (
    resolve_device)
from project_desert_tortoise_tpu_torch.parallel import sharding as SH


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None, device="cuda") -> torch.device:
    """Join the process group (JAX ``init``): from the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) by
    default, or from an explicit ``host:port`` coordinator, process count
    and process id.  A CUDA `device` (its index from ``LOCAL_RANK`` when it
    has none) becomes this process's current device and the group runs
    NCCL; a CPU device runs gloo.  Returns the device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            **kwargs)
    return dev


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(n_channel: int = 1, devices=None) -> SH.Mesh:
    """(ch, blk) mesh over every process's entries, rank-major, so that
    each rank owns contiguous ``blk`` columns and the halo ring crosses a
    process boundary once a boundary.  `devices`: this process's entries
    (default: its current CUDA device).  Collective: every rank calls it."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", torch.cuda.current_device())]
    local = [str(torch.device(d)) for d in devices]
    parts = [local]
    if dist.is_initialized():
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, local)
    ranks = [r for r, p in enumerate(parts) for _ in p]
    devs = [torch.device(d) for p in parts for d in p]
    if len(devs) % n_channel:
        raise ValueError(f"{len(devs)} devices not divisible by "
                         f"{n_channel} channels")
    n_blk = len(devs) // n_channel
    return SH.Mesh(SH._grid(devs, n_channel, n_blk),
                   SH._grid(ranks, n_channel, n_blk))


def local_time_slice(n_samples: int, mesh: SH.Mesh) -> Tuple[int, int]:
    """[lo, hi) sample range this process's shards cover; raises unless
    its mesh columns are contiguous (the layout of :func:`global_mesh`),
    rather than return a range that spans other processes' data."""
    n_blk = mesh.shape["blk"]
    per = -(-n_samples // n_blk)
    me = _rank()
    cols = sorted(set(np.nonzero(mesh.ranks == me)[1].tolist()))
    if not cols:
        raise ValueError(f"process {me} owns no mesh entry")
    if cols != list(range(cols[0], cols[-1] + 1)):
        raise ValueError(
            f"process {me} owns non-contiguous mesh columns {cols}; "
            "local_time_slice needs a contiguous blk layout (use "
            "multihost.global_mesh)")
    return cols[0] * per, min((cols[-1] + 1) * per, n_samples)


def _remote_halos(shards, mesh: SH.Mesh, head: int, tail: int) -> dict:
    """The halos this process's rows take from other processes, {row:
    (left, right)}: for each mesh edge (row, k) - (row, k+1) whose two
    entries belong to different ranks, the left one sends its last `head`
    samples and receives the right one's first `tail`, in one
    ``batch_isend_irecv`` over every edge of this process (edges in one
    order on every rank, so each pair's operations match)."""
    me = _rank()
    n_ch, n_blk = mesh.devices.shape
    ops, halos = [], {}
    for r in range(n_ch):
        for k in range(n_blk - 1):
            a, b = int(mesh.ranks[r, k]), int(mesh.ranks[r, k + 1])
            if a == b or me not in (a, b):
                continue
            tag = 2 * (r * n_blk + k)
            x = shards[r, k] if me == a else shards[r, k + 1]
            loc = x.shape[-1]
            lead = tuple(x.shape[:-1])
            if me == a:
                buf = torch.empty(lead + (tail,), dtype=x.dtype,
                                  device=x.device)
                ops += [dist.P2POp(dist.isend,
                                   x[..., loc - head:].contiguous(), b,
                                   tag=tag),
                        dist.P2POp(dist.irecv, buf, b, tag=tag + 1)]
                halos.setdefault(r, [None, None])[1] = buf
            else:
                buf = torch.empty(lead + (head,), dtype=x.dtype,
                                  device=x.device)
                ops += [dist.P2POp(dist.irecv, buf, a, tag=tag),
                        dist.P2POp(dist.isend, x[..., :tail].contiguous(),
                                   a, tag=tag + 1)]
                halos.setdefault(r, [None, None])[0] = buf
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return {r: tuple(v) for r, v in halos.items()}


def demodulate_multihost(iq, t, fs, mode_cfg, mesh: SH.Mesh,
                         norm_factor=None, plan=None, use_pallas=False):
    """Multi-process twin of ``sharding.demodulate_sharded``.

    Every process calls it with the same (C, N) recording view (a memory
    map will do): only this process's shards are cut from it and placed
    on its devices.  Returns the per-channel frame lists, the same on
    every process."""
    C, N = iq.shape
    params, plan, re, im, t_ext, norm = SH.stage_global(
        iq, t, fs, mode_cfg, mesh, plan, norm_factor)
    local_time_slice(re.shape[1], mesh)       # a contiguous layout
    n_ch, n_blk = mesh.devices.shape
    me = _rank()
    shards = {(r, k): SH.shard_planes(re, im, mesh, r, k)
              for r in range(n_ch) for k in range(n_blk)
              if mesh.ranks[r, k] == me}
    halos = _remote_halos(shards, mesh, plan.head, plan.tail)
    step = SH.sharded_demod_step(params, plan, mode_cfg.framer, float(fs),
                                 use_pallas)
    tagged = SH.tagged_frames(step(shards, norm, N, halos), t_ext)
    return SH.channel_frames(gather_frames(tagged), C)


def gather_frames(frames) -> list:
    """Every process's list of (picklable) frames, concatenated in rank
    order, on every process; the list itself outside a process group."""
    if not dist.is_initialized():
        return list(frames)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, list(frames))
    return [f for p in parts for f in p]

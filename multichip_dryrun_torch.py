#!/usr/bin/env python3
"""Multi-device dry run of the PyTorch port: the mesh-shape sweep.

Twin of ``__graft_entry__.py::dryrun_multichip``.  It demodulates
``n_devices`` copies of a short synthetic POES recording (3 frames,
25 dB) with ``parallel/sharding.py::demodulate_sharded`` on every (ch,
blk) factorization of ``n_devices`` among 1 x n, 2 x n/2, n/2 x 2 and
n x 1, on the scan branch (``use_pallas=False``), and requires the
per-channel frame sets to be identical across shapes.  Then it runs the
fused branch (``use_pallas="fused"``) on the balanced mesh and requires
the same frame sets again: equal, not within ``2 * n_devices`` frames as
the JAX dry run allows.  A frame is its (sync time, payload); the time is
the recording's time axis at the sync's sample position, which increases
over this recording, so equal times are equal positions.  Should the
fused branch label a frame with another time (two bit emissions in one
4-sample chunk, which it sums), the payloads must still be equal, and the
relabelled frames are printed.

The mesh entries are the visible devices of `device`'s type, repeated
where there are fewer than ``n_devices`` (the CPU is one device; one card
stands in for several entries, with the shards that share it demodulated
in one launch).

    python3 multichip_dryrun_torch.py [--devices N] [--device cuda]
"""

from __future__ import annotations

import argparse
import collections
import sys

import numpy as np

FS = 50000.0
N_FRAMES = 3
PLAN = (16384, 8192, 6144, 8)          # core, head, tail, max_frames


def mesh_shapes(n_devices: int):
    """The (ch, blk) factorizations the JAX dry run sweeps."""
    return sorted({(c, n_devices // c)
                   for c in (1, 2, n_devices // 2, n_devices)
                   if 0 < c <= n_devices and n_devices % c == 0})


def frame_set(frames):
    return sorted((f.time, bytes(f.data)) for f in frames)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The sweep; raises if two shapes or the two branches disagree.
    Returns the shapes, the frames a shape found and the relabelled
    frames of the fused branch (none so far)."""
    import torch
    from project_desert_tortoise_tpu_torch.ops.kernels.common import (
        resolve_device)
    from project_desert_tortoise_tpu_torch.parallel.blocked import BlockPlan
    from project_desert_tortoise_tpu_torch.parallel.sharding import (
        demodulate_sharded, make_mesh)
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP
    from project_desert_tortoise_tpu_torch.utils import synth, wav as W

    dev = resolve_device(device)
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    devices = [visible[i % len(visible)] for i in range(n_devices)]

    iq1, sent = synth.make_poes_recording(n_frames=N_FRAMES, fs=FS,
                                          snr_db=25.0)
    # C = n_devices identical channels divides every mesh factorization
    iq = np.stack([iq1] * n_devices)
    t = W.time_axis(iq.shape[1], FS, np.float32)
    plan = BlockPlan(*PLAN)
    sset = {bytes(f) for f in sent}

    shapes = mesh_shapes(n_devices)
    results = {}
    for n_ch, n_blk in shapes:
        res = demodulate_sharded(iq, t, FS, POES_TIP,
                                 make_mesh(n_ch, n_blk, devices), plan=plan)
        if len(res) != n_devices:
            raise AssertionError(f"mesh {n_ch}x{n_blk}: {len(res)} channels")
        results[n_ch, n_blk] = [frame_set(r) for r in res]
    ref = results[shapes[0]]
    for shp in shapes[1:]:
        if results[shp] != ref:
            raise AssertionError(f"frame sets differ: mesh {shp} vs "
                                 f"{shapes[0]}")
    for c, frames in enumerate(ref):
        ok = sum(p in sset for _, p in frames)
        if ok < N_FRAMES - 1:          # the first frame may go to acquisition
            raise AssertionError(f"channel {c}: {ok} of {N_FRAMES} payloads")

    bal = shapes[len(shapes) // 2]
    res_f = demodulate_sharded(iq, t, FS, POES_TIP,
                               make_mesh(*bal, devices), plan=plan,
                               use_pallas="fused")
    fused = [frame_set(r) for r in res_f]
    relabelled = []
    for c, (a, b) in enumerate(zip(ref, fused)):
        if a == b:
            continue
        if (collections.Counter(p for _, p in a)
                != collections.Counter(p for _, p in b)):
            raise AssertionError(f"channel {c}: the fused branch's payloads "
                                 f"differ from the scan branch's on mesh "
                                 f"{bal}")
        relabelled += [(c, x, y) for x, y in zip(a, b) if x != y]
    total = sum(len(r) for r in ref)
    same = f"relabelled {relabelled}" if relabelled else "the same set"
    print(f"dryrun_multichip: shapes={['%dx%d' % s for s in shapes]} on "
          f"{len(set(devices))} {dev.type} device(s); frame sets identical "
          f"across shapes (total {total}); fused branch on "
          f"{bal[0]}x{bal[1]}: {same}", flush=True)
    return dict(shapes=shapes, frames=total, balanced=bal,
                relabelled=[(c, x[0], y[0], x[1].hex())
                            for c, x, y in relabelled])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="multichip_dryrun_torch")
    ap.add_argument("--devices", type=int, default=4,
                    help="mesh entries to sweep the shapes of")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

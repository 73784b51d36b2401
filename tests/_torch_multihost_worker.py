"""One process of a local gloo group of the port's multi-process path, for
tests/test_torch_multihost.py.

    _torch_multihost_worker.py <host:port> <nprocs> <rank> <recording.npz> <out.json>

Each process owns two CPU mesh entries.  It checks ``global_mesh``,
``local_time_slice`` (its error on a non-contiguous layout included) and
``gather_frames``, runs ``demodulate_multihost`` on the recording over the
global meshes (1, 2n) and (2, n) and writes the frames it returns, per
mesh and channel, as JSON.
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

PLAN = (8192, 8192, 6144, 8)


def main():
    coord, nprocs, pid, rec, out = sys.argv[1:6]
    nprocs, pid = int(nprocs), int(pid)
    torch.set_num_threads(1)

    from project_desert_tortoise_tpu_torch.ops.framer import Frame
    from project_desert_tortoise_tpu_torch.parallel import multihost as MH
    from project_desert_tortoise_tpu_torch.parallel import sharding as SH
    from project_desert_tortoise_tpu_torch.parallel.blocked import BlockPlan
    from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

    dev = MH.init(coordinator_address=coord, num_processes=nprocs,
                  process_id=pid, device="cpu")
    assert dev.type == "cpu" and dist.get_backend() == "gloo"
    assert dist.get_world_size() == nprocs and dist.get_rank() == pid

    # rank-major columns: rank r owns blk columns 2r and 2r + 1
    mesh = MH.global_mesh(1, ["cpu", "cpu"])
    assert mesh.shape == {"ch": 1, "blk": 2 * nprocs}
    assert mesh.ranks.tolist() == [[r for r in range(nprocs) for _ in "ab"]]
    n_samples = 800_000
    lo, hi = MH.local_time_slice(n_samples, mesh)
    per = -(-n_samples // (2 * nprocs))
    assert (lo, hi) == (2 * pid * per, min(2 * (pid + 1) * per, n_samples))
    print("LOCAL_SLICE_OK", lo, hi, flush=True)

    interleaved = np.array([[r % nprocs for r in range(2 * nprocs)]])
    try:
        MH.local_time_slice(n_samples, SH.Mesh(mesh.devices, interleaved))
        print("NONCONTIG_FAIL: no error raised", flush=True)
    except ValueError as e:
        assert "contiguous" in str(e), e
        print("NONCONTIG_OK", flush=True)

    local = [Frame(float(pid) + 0.25, False,
                   np.arange(8, dtype=np.uint8) + pid, True)]
    gathered = MH.gather_frames(local)
    assert [f.time for f in gathered] == [r + 0.25 for r in range(nprocs)]
    print("GATHERED_FRAMES_OK", flush=True)

    z = np.load(rec)
    iq, t = z["iq"], z["t"]
    result = {}
    for n_ch in (1, 2):
        mesh = MH.global_mesh(n_ch, ["cpu", "cpu"])
        frames = MH.demodulate_multihost(iq, t, float(z["fs"]), POES_TIP,
                                         mesh, plan=BlockPlan(*PLAN))
        key = "%dx%d" % (n_ch, 2 * nprocs // n_ch)
        result[key] = [[[f.time, f.inverted, bytes(f.data).hex()]
                        for f in ch] for ch in frames]
    with open(out, "w") as f:
        json.dump(result, f)
    print("E2E_DONE", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

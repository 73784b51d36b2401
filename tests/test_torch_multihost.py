"""The port's multi-process path (``parallel/multihost.py``) in a real
``torch.distributed`` group, and the mesh-shape dry run, on the CPU.

Two gloo processes on 127.0.0.1 (``_torch_multihost_worker.py``), each
with two CPU mesh entries, run ``demodulate_multihost`` on two channels of
3 frames over the global meshes (1, 4), where each rank owns two ``blk``
columns and the halos between columns 1 and 2 cross between the ranks,
and (2, 2), where each rank owns a channel row and its halos stay inside
it.  Both ranks must return the same frames, and those must be JAX's
``demodulate_sharded`` on the same mesh shape over 4 virtual CPU devices
(payloads and polarity identical, sync times within one sample period,
``docs/DESIGN.md`` §4b).  Each process has its own timeout.  The workers
also check ``global_mesh``, ``local_time_slice`` (with its error on a
non-contiguous layout) and ``gather_frames``.

``multichip_dryrun_torch.dryrun_multichip(2, device="cpu")`` sweeps the
meshes 1 x 2 and 2 x 1 and the fused branch on its own.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import pytest

from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.parallel import sharding as JS
from project_desert_tortoise_tpu.utils import config as JCFG
from project_desert_tortoise_tpu.utils import synth, wav as W

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_worker.py")
FS = 50000.0
PLAN = (8192, 8192, 6144, 8)
N_PROCS = 2


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.fixture(scope="module")
def recording():
    a, sa = synth.make_poes_recording(n_frames=3, fs=FS, snr_db=25.0)
    b, sb = synth.make_poes_recording(n_frames=3, fs=FS, snr_db=25.0,
                                      carrier_hz=-2200.0,
                                      rng=np.random.default_rng(7))
    iq = np.stack([a, b])
    return iq, W.time_axis(iq.shape[1], FS, np.float32), (sa, sb)


@pytest.fixture(scope="module")
def cluster(recording, tmp_path_factory):
    """Each worker's (exit code, output, frames by mesh)."""
    iq, t, _ = recording
    d = tmp_path_factory.mktemp("torch_multihost")
    rec = str(d / "recording.npz")
    np.savez(rec, iq=iq, t=t, fs=FS)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, f"127.0.0.1:{port}", str(N_PROCS), str(i),
         rec, str(d / f"frames{i}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(N_PROCS)]
    outs = []
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        path = d / f"frames{i}.json"
        frames = json.loads(path.read_text()) if path.exists() else None
        outs.append((p.returncode, out, frames))
    return outs


def test_workers_succeed(cluster):
    for rc, out, _ in cluster:
        assert rc == 0, out
        for mark in ("LOCAL_SLICE_OK", "NONCONTIG_OK", "GATHERED_FRAMES_OK",
                     "E2E_DONE"):
            assert mark in out, out


def test_frames_identical_on_both_ranks(cluster):
    frames = [f for _, _, f in cluster]
    assert frames[0] is not None and set(frames[0]) == {"1x4", "2x2"}
    assert all(f == frames[0] for f in frames[1:])


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_multihost_matches_jax_sharded(recording, cluster, shape):
    iq, t, sent = recording
    devs = jax.devices("cpu")
    if len(devs) < 4:
        pytest.skip("needs 4 virtual CPU devices")
    want = JS.demodulate_sharded(iq, t, FS, JCFG.POES_TIP,
                                 JS.make_mesh(*shape, devs[:4]),
                                 plan=JB.BlockPlan(*PLAN))
    got = cluster[0][2]["%dx%d" % shape]
    assert len(got) == len(want) == 2
    for c, (a, b) in enumerate(zip(want, got)):
        assert len(a) == len(b), c
        for x, (time, inverted, data) in zip(a, b):
            assert bytes(x.data).hex() == data
            assert x.inverted == inverted
            assert abs(x.time - time) <= 1.0001 / FS
        sset = {bytes(f).hex() for f in sent[c]}
        assert sum(d in sset for _, _, d in b) >= len(sent[c]) - 1


def test_dryrun_multichip_on_cpu():
    import multichip_dryrun_torch as D
    out = D.dryrun_multichip(2, device="cpu")
    assert out["shapes"] == [(1, 2), (2, 1)]
    assert out["balanced"] == (2, 1)
    assert out["frames"] >= 2 * (D.N_FRAMES - 1)
    assert out["relabelled"] == []

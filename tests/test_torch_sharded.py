"""The port's ``parallel/sharding.py`` against the JAX package's, on the
CPU (the kernels' plain versions; JAX on the tests' 8 virtual CPU
devices, the port on a mesh whose entries all name the CPU).

- ``stage_global``: the padded planes, the time axis and the norm factor
  bit for bit.
- ``_halo_exchange`` on random planes against JAX's under ``shard_map``,
  bit for bit, and its error where a halo is longer than a shard.
- ``demodulate_sharded`` on meshes (2, 2) and (1, 4) with two different
  channels of 3 frames on the scan branch, and on (1, 2) on the fused
  branch (JAX's Pallas kernel in interpret mode): per channel the same
  frames, payloads and polarity identical, sync times within one sample
  period (``docs/DESIGN.md`` §4b).
- ``make_mesh`` raises on too few devices.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.parallel import sharding as JS
from project_desert_tortoise_tpu.utils import config as JCFG
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu_torch.parallel import sharding as PS
from project_desert_tortoise_tpu_torch.parallel.blocked import BlockPlan
from project_desert_tortoise_tpu_torch.utils import config as TCFG

torch.set_num_threads(2)
FS = 50000.0
PLAN = (8192, 8192, 6144, 8)


@pytest.fixture(scope="module")
def cpu_devices():
    devs = jax.devices("cpu")
    if len(devs) < 4:
        pytest.skip("needs 4 virtual CPU devices")
    return devs


@pytest.fixture(scope="module")
def recording():
    """Two channels of 3 frames: different carriers, noise and payloads."""
    a, sa = synth.make_poes_recording(n_frames=3, fs=FS, snr_db=25.0)
    b, sb = synth.make_poes_recording(n_frames=3, fs=FS, snr_db=25.0,
                                      carrier_hz=-2200.0,
                                      rng=np.random.default_rng(7))
    iq = np.stack([a, b])
    return iq, W.time_axis(iq.shape[1], FS, np.float32), (sa, sb)


def port_mesh(n_ch, n_blk):
    return PS.make_mesh(n_ch, n_blk, ["cpu"] * (n_ch * n_blk))


def test_stage_global_matches_jax(recording, cpu_devices):
    iq, t, _ = recording
    N = iq.shape[1]
    jplan = JB.BlockPlan(*PLAN)
    _, jp, jre, jim, jtn, _, jnorm = JS.stage_global(
        iq, t, FS, JCFG.POES_TIP, JS.make_mesh(1, 4, cpu_devices), jplan)
    params, plan, re, im, t_ext, norm = PS.stage_global(
        iq, t, FS, TCFG.POES_TIP, port_mesh(1, 4), BlockPlan(*PLAN))
    assert tuple(plan) == tuple(jp)
    assert re.dtype == jre.dtype == np.float32
    assert np.array_equal(re, jre) and np.array_equal(im, jim)
    assert re.shape[1] % (4 * PLAN[0]) == 0 and re.shape[1] >= N
    assert params.interp == 3              # the chain reports sample i + 1
    assert np.array_equal(t_ext[1:N + 1], jtn[0, :N])
    assert norm == float(jnorm[0, 0])


def jax_halos(x, head, tail, devices):
    from jax import shard_map
    mesh = JS.make_mesh(1, 4, devices)
    fn = shard_map(functools.partial(JS._halo_exchange, head=head, tail=tail,
                                     axis_name="blk"),
                   mesh=mesh, in_specs=JP("ch", "blk"),
                   out_specs=JP("ch", "blk"), check_vma=False)
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


@pytest.mark.parametrize("head,tail", [(16, 8), (64, 64), (1, 63)])
def test_halo_exchange_matches_jax(cpu_devices, head, tail):
    x = np.random.default_rng(head).normal(size=(3, 4 * 64)).astype(
        np.float32)
    want = jax_halos(x, head, tail, cpu_devices)
    xs = [torch.from_numpy(s) for s in np.split(x, 4, axis=-1)]
    got = PS._halo_exchange(xs, head, tail)
    assert [tuple(g.shape) for g in got] == [(3, head + 64 + tail)] * 4
    assert np.array_equal(torch.cat(got, -1).numpy(), want)


def test_halo_longer_than_a_shard_raises(recording):
    xs = [torch.zeros(2, 64) for _ in range(4)]
    with pytest.raises(ValueError, match="halo"):
        PS._halo_exchange(xs, 65, 8)
    iq, t, _ = recording
    with pytest.raises(ValueError, match="halo"):
        PS.demodulate_sharded(iq, t, FS, TCFG.POES_TIP, port_mesh(1, 4),
                              plan=BlockPlan(4096, 16384, 6144, 8))


def test_make_mesh_needs_enough_devices():
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        PS.make_mesh(2, 2, ["cpu"] * 3)
    mesh = PS.make_mesh(2, 2, ["cpu"] * 5)
    assert mesh.shape == {"ch": 2, "blk": 2}
    assert {str(d) for d in mesh.devices.flat} == {"cpu"}
    if not torch.cuda.is_available():          # no card: no default entry
        with pytest.raises(ValueError, match="need 1 devices, have 0"):
            PS.make_mesh(1, 1)


def check_frames(want, got, sent):
    """JAX's per-channel frames against the port's (§4b)."""
    assert len(want) == len(got)
    for c, (a, b) in enumerate(zip(want, got)):
        assert len(a) == len(b), c
        for x, y in zip(a, b):
            assert np.array_equal(x.data, y.data)
            assert x.inverted == y.inverted
            assert abs(x.time - y.time) <= 1.0001 / FS
        sset = {bytes(f) for f in sent[c]}
        assert sum(bytes(f.data) in sset for f in b) >= len(sent[c]) - 1


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_matches_jax(recording, cpu_devices, shape):
    iq, t, sent = recording
    want = JS.demodulate_sharded(iq, t, FS, JCFG.POES_TIP,
                                 JS.make_mesh(*shape, cpu_devices),
                                 plan=JB.BlockPlan(*PLAN))
    got = PS.demodulate_sharded(iq, t, FS, TCFG.POES_TIP, port_mesh(*shape),
                                plan=BlockPlan(*PLAN))
    check_frames(want, got, sent)


def test_sharded_fused_matches_jax(recording, cpu_devices):
    iq, t, sent = recording
    want = JS.demodulate_sharded(iq[:1], t, FS, JCFG.POES_TIP,
                                 JS.make_mesh(1, 2, cpu_devices),
                                 plan=JB.BlockPlan(*PLAN), use_pallas="fused")
    got = PS.demodulate_sharded(iq[:1], t, FS, TCFG.POES_TIP, port_mesh(1, 2),
                                plan=BlockPlan(*PLAN), use_pallas="fused")
    check_frames(want, got, sent[:1])

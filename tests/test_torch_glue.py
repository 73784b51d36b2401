"""The torch glue of the fast path against the JAX package, on identical
inputs: bit compaction, frame extraction and stitching exact; the coarse
carrier estimate within one FFT bin (fs/8192)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu.ops import framer as JF
from project_desert_tortoise_tpu.ops import manchester as JM
from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu.utils.config import ARGOS, POES_TIP
from project_desert_tortoise_tpu_torch.ops import framer as TF
from project_desert_tortoise_tpu_torch.ops import manchester as TM
from project_desert_tortoise_tpu_torch.parallel import blocked as TB

torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(j, t):
    for a, b in zip(j, t):
        assert np.array_equal(_np(a), _np(b))


def _dense_stream(B, n, seed, spacing=6):
    """A fused-kernel-like output: emissions >= `spacing` samples apart."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, n), bool)
    for b in range(B):
        pos = np.cumsum(rng.integers(spacing, 3 * spacing, n // spacing))
        mask[b, pos[pos < n]] = True
    vals = rng.integers(0, 2, (B, n)).astype(np.uint8)
    times = rng.random((B, n)).astype(np.float32)
    return vals, times, mask


@pytest.mark.parametrize("capacity", [40, 4096])
def test_compress_sorted_exact(capacity):
    vals, times, mask = _dense_stream(5, 1024, 0)
    j = JM.compress_sorted(jnp.asarray(vals), jnp.asarray(times),
                           jnp.asarray(mask), capacity)
    t = TM.compress_sorted(torch.from_numpy(vals), torch.from_numpy(times),
                           torch.from_numpy(mask), capacity)
    _assert_same(j, t)


def test_compress_spaced_exact():
    vals, times, mask = _dense_stream(6, 2048, 1)
    j = JM.compress_spaced(jnp.asarray(vals), jnp.asarray(times),
                           jnp.asarray(mask), 2048 // 4 + 8)
    t = TM.compress_spaced(torch.from_numpy(vals), torch.from_numpy(times),
                           torch.from_numpy(mask), 2048 // 4 + 8)
    _assert_same(j, t)


def _bit_lanes(cfg, make_frame, B, nb, seed):
    """Bit blocks holding frames (some inverted, some overlapping a
    shifting frame, some running past the valid count) in random fill."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, nb)).astype(np.uint8)
    for b in range(B):
        pos = int(rng.integers(0, 60))
        while pos < nb:
            f = synth.bytes_to_bits(make_frame(rng))
            if rng.random() < 0.3:
                f = 1 - f
            bits[b, pos:pos + len(f)] = f[:nb - pos]
            pos += len(f) - int(rng.integers(0, 40)) * (rng.random() < 0.2)
            pos += int(rng.integers(0, 50))
    times = np.cumsum(rng.random((B, nb)), axis=1).astype(np.float32)
    n_bits = rng.integers(nb // 2, nb + 1, B).astype(np.int32)
    return bits, times, n_bits


@pytest.mark.parametrize("mode", ["poes", "argos"])
def test_frame_extract_and_stitch_exact(mode):
    if mode == "poes":
        cfg, B, nb, F = POES_TIP.framer, 6, 6000, 8
        make = lambda rng: synth.make_poes_frame(int(rng.integers(0, 512)),
                                                 rng=rng)
    else:
        cfg, B, nb, F = ARGOS.framer, 5, 2000, 20
        sync = np.array([0, 0, 0, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0], np.uint8)
        make = lambda rng: np.packbits(np.concatenate(
            [np.zeros(3, np.uint8), sync,
             synth.bytes_to_bits(rng.integers(0, 256, 7).astype(np.uint8))]))
    bits, times, n_bits = _bit_lanes(cfg, make, B, nb, 4)
    j = JF.frame_extract(jnp.asarray(bits), jnp.asarray(times),
                         jnp.asarray(n_bits), cfg, F)
    t = TF.frame_extract(torch.from_numpy(bits), torch.from_numpy(times),
                         torch.from_numpy(n_bits), cfg, F)
    _assert_same(j, t)
    assert int(np.sum(np.asarray(j.count))) > B

    # core intervals that cut some frames away
    lo = times[:, nb // 8]
    hi = times[:, 3 * nb // 4]
    bounds = np.stack([lo, hi], 1).astype(np.float32)
    js = JF.stitch_frames(j, jnp.asarray(bounds), B * F)
    ts = TF.stitch_frames(t, torch.from_numpy(bounds), B * F)
    n = int(np.asarray(js[3]))
    assert int(ts[3]) == n > 0
    for a, b in zip(js[:3], ts[:3]):
        assert np.array_equal(np.asarray(a)[:n], b.numpy()[:n])


def test_correlations_exact():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 2, (3, 500)).astype(np.uint8)
    w = 2 ** np.arange(7, -1, -1)
    assert np.array_equal(np.asarray(JF._corr_first(jnp.asarray(x), w)),
                          TF._corr_first(torch.from_numpy(x), w).numpy())
    bip = x.astype(np.int32) * 2 - 1
    pat = POES_TIP.framer.sync_bits().astype(np.int32) * 2 - 1
    assert np.array_equal(
        np.asarray(JF._corr_last(jnp.asarray(bip), jnp.asarray(pat))),
        TF._corr_last(torch.from_numpy(bip), pat).numpy())


@pytest.mark.parametrize("carrier", [-3000.0, 1250.0])
def test_coarse_carrier_est_within_one_bin(carrier):
    fs = 50000.0
    iq, _ = synth.make_poes_recording(n_frames=4, fs=fs, carrier_hz=carrier)
    n = 3 * 8192 + 100
    blocks = np.stack([iq[k * 4000:k * 4000 + n] for k in range(4)])
    re = np.ascontiguousarray(blocks.real, np.float32)
    im = np.ascontiguousarray(blocks.imag, np.float32)
    spacing = POES_TIP.gardner.baud / 2.0
    j = np.asarray(JB.coarse_carrier_est(jnp.asarray(re), jnp.asarray(im),
                                         fs, spacing))
    t = TB.coarse_carrier_est(torch.from_numpy(re), torch.from_numpy(im),
                              fs, spacing).numpy()
    assert np.all(np.abs(j - t) <= fs / 8192)
    assert np.all(np.abs(t - carrier) < 30.0)
    # int16 planes: exact /32768 on the way in
    r16 = np.round(re * 32768.0).astype(np.int16)
    i16 = np.round(im * 32768.0).astype(np.int16)
    t16 = TB.coarse_carrier_est(torch.from_numpy(r16), torch.from_numpy(i16),
                                fs, spacing).numpy()
    assert np.all(np.abs(t16 - carrier) < 30.0)


def test_demodulate_blocked_batches_give_the_same_frames():
    """A recording split over several launches (the memory cap) gives the
    frames of one launch, in stream order."""
    fs = 50000.0
    iq, _ = synth.make_poes_recording(n_frames=4, fs=fs)
    t = W.time_axis(len(iq), fs, np.float32)
    plan = TB.BlockPlan(4096, 4096, 8192, 8)       # short blocks: CPU time
    assert -(-len(iq) // plan.core) == 10
    one = TB.demodulate_blocked(iq, t, fs, POES_TIP, plan=plan,
                                use_pallas="fused", device="cpu")
    split = TB.demodulate_blocked(iq, t, fs, POES_TIP, plan=plan,
                                  batch_blocks=5, use_pallas="fused",
                                  device="cpu")
    key = lambda f: (f.time, f.inverted, bytes(f.data))
    assert [key(f) for f in split] == [key(f) for f in one]
    assert len(one) >= 3

"""The exact chain's Gardner/Manchester scan and its helpers against the
JAX package, on the same inputs made with numpy: the plain version of the
``gardner_manchester_scan`` kernel against JAX's ``gardner_scan`` followed
by ``manchester_scan``, ``compress_stream``, ``fir_history_update`` and
``fir_apply``, and the unwindowed fallback of the port's ``demod_blocks``
against JAX's on a plan whose block length is not a multiple of the
4,096-sample window.

Tolerance.  The scan is held exactly: it is comparisons, selects, gathers
and single float32 operations, none of which XLA contracts (the clamp sits
between the error's product and the subtraction), so equal inputs give
equal outputs.  ``compress_stream`` and the history update only move
values: exact.  ``fir_apply`` is a convolution summed in another order than
XLA's: 1e-6 at unit input.  The fallback's frames are held to the
``docs/DESIGN.md`` §4b contract, as ``tests/test_torch_blocked.py`` holds
the other branches.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu import chain as JC
from project_desert_tortoise_tpu.ops import clock as JK, fir as JF
from project_desert_tortoise_tpu.ops import manchester as JM
from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu.utils.config import ARGOS_REALTIME, POES_TIP
from project_desert_tortoise_tpu_torch import chain as TC
from project_desert_tortoise_tpu_torch.ops import clock as TK, fir as TF
from project_desert_tortoise_tpu_torch.ops import manchester as TM
from project_desert_tortoise_tpu_torch.parallel import blocked as TB
from test_torch_blocked import _parity
from test_torch_chain import _sym_stream

torch.set_num_threads(1)


def scan_case(cfg, fs, B, cap, n_valid, seed):
    """A (B, cap) image, its time plane and carried states in the ranges
    the exact chain carries: next_sample within a step of the start,
    half_raw a stale pointer inside the image, past `n_valid`, past the
    image, or negative; Manchester state mid-stream."""
    params = JC.make_params(cfg, fs)
    rng = np.random.default_rng(seed)
    x = _sym_stream(B, cap, seed, params.step_size)
    t = (np.arange(1, cap + 1, dtype=np.float32) / np.float32(fs)
         + rng.uniform(0, 1, (B, 1)).astype(np.float32))
    ns = rng.uniform(-0.6, params.step_size, B).astype(np.float32)
    half = np.array([rng.uniform(0, cap), n_valid + 3.5, cap + 7.25, -4.5,
                     n_valid - 0.5, 0.5][:B] + [2.0] * max(0, B - 6),
                    np.float32)
    g = JK.GardnerState(next_sample=jnp.asarray(ns),
                        half_raw=jnp.asarray(half),
                        prev_bit=jnp.asarray(x[:, 0] * 0.7))
    m = JM.ManchesterState(
        clockmod=jnp.asarray(rng.integers(0, 2, B), jnp.int32),
        evenodd=jnp.asarray(rng.integers(0, 2, B), jnp.int32),
        cur=jnp.asarray(x[:, 1]), prev=jnp.asarray(x[:, 2]),
        prevprev=jnp.asarray(x[:, 3]))
    return params, x, t, g, m


@pytest.mark.parametrize("cfg,fs,cap,n_valid", [
    (POES_TIP, 50000.0, 6000, 6000),           # a whole quirks image
    (POES_TIP, 50000.0, 6000, 4321),           # a short final chunk
    (ARGOS_REALTIME, 32000.0, 2416, 2416),     # interp 1, margin + chunk
])
def test_gardner_manchester_scan_matches_jax(cfg, fs, cap, n_valid):
    B = 6
    params, x, t, g, m = scan_case(cfg, fs, B, cap, n_valid, seed=cap)
    msyms = JC.max_symbols(cap, params.step_size)
    n = np.full(B, n_valid, np.int32)
    n[-1] = n_valid // 2                       # a lane whose slots end early
    args = (params.step_size, params.gardner_err_limit, params.gardner_gain)
    jg, jsyms, jtimes, jvalid, jcount = JK.gardner_scan(
        g, jnp.asarray(x), jnp.asarray(t), jnp.asarray(n), *args, msyms)
    jm, jbits, jbt, jemit = JM.manchester_scan(m, jsyms, jtimes, jvalid,
                                               params.resync_threshold)
    tg, tm, syms, times, valid, count, bits, bt, emit = \
        TK.gardner_manchester_scan(
            TC.from_jax(g), TC.from_jax(m), torch.from_numpy(x),
            torch.from_numpy(t), torch.from_numpy(n), *args,
            params.resync_threshold, msyms)
    assert bits.dtype == torch.uint8 and emit.dtype == torch.bool
    assert valid.dtype == torch.bool and count.dtype == torch.int32
    for a, b in ((jsyms, syms), (jtimes, times), (jvalid, valid),
                 (jcount, count), (jbits, bits), (jbt, bt), (jemit, emit),
                 *zip(jg, tg), *zip(jm, tm)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
    counts = np.asarray(jcount)
    assert (counts > 0).all() and (counts < msyms).all()
    assert int(np.asarray(jemit).sum()) > 10 * B


def test_compress_stream_matches_jax():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 2, (4, 300)).astype(np.uint8)
    times = rng.standard_normal((4, 300)).astype(np.float32)
    mask = rng.uniform(size=(4, 300)) < 0.4
    mask[3] = True                             # more entries than capacity
    for cap in (200, 400):
        j = JM.compress_stream(jnp.asarray(vals), jnp.asarray(times),
                               jnp.asarray(mask), cap)
        t = TM.compress_stream(torch.from_numpy(vals),
                               torch.from_numpy(times),
                               torch.from_numpy(mask), cap)
        for a, b in zip(j, t):
            assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("interp,n", [(3, 500), (1, 20)])
def test_fir_history_update_and_apply_match_jax(interp, n):
    rng = np.random.default_rng(interp)
    n_taps = 78 if interp == 3 else 50
    hist_len = -(-(n_taps - 1) // interp)
    x = rng.standard_normal(n).astype(np.float32)
    hist = rng.standard_normal(hist_len).astype(np.float32)
    j = JF.fir_history_update(jnp.asarray(x), jnp.asarray(hist), n_taps,
                              interp)
    t = TF.fir_history_update(torch.from_numpy(x), torch.from_numpy(hist),
                              n_taps, interp)
    assert np.array_equal(np.asarray(j), t.numpy())
    taps = TF.make_lpfir(n_taps, 2000.0, 32000.0, 1)
    hist = rng.standard_normal(n_taps - 1).astype(np.float32)
    j = JF.fir_apply(jnp.asarray(x), taps, jnp.asarray(hist))
    t = TF.fir_apply(torch.from_numpy(x), taps, torch.from_numpy(hist))
    assert np.abs(np.asarray(j, np.float64) - t.double().numpy()).max() < 1e-6


def test_unwindowed_fallback_matches_jax(monkeypatch):
    """A block length (28,000) that the 4,096-sample window does not
    divide: both packages run Gardner/Manchester over the whole block in
    one scan (the port on ``gardner_manchester_scan``)."""
    calls, whole_scan = [], TK.gardner_manchester_scan

    def scan(*args):
        calls.append(args[2].shape)
        return whole_scan(*args)
    monkeypatch.setattr(TB.clock_ops, "gardner_manchester_scan", scan)
    fs = 50000.0
    plan = (8000, 12000, 8000, 8)
    assert sum(plan[:3]) % 4096
    iq, sent = synth.make_poes_recording(n_frames=6, fs=fs)
    t = W.time_axis(len(iq), fs, np.float32)
    jf = JB.demodulate_blocked(iq, t, fs, POES_TIP, plan=JB.BlockPlan(*plan),
                               use_pallas=False)
    tf = TB.demodulate_blocked(iq, t, fs, POES_TIP, plan=TB.BlockPlan(*plan),
                               use_pallas=False, device="cpu")
    assert calls == [(-(-len(iq) // plan[0]), 3 * 28000)]   # B blocks
    _parity(jf, tf)
    sent = {bytes(s) for s in sent}
    assert sum(bytes(f.data) in sent for f in tf) >= len(sent) - 1

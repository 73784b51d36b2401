"""The port's ChannelBank: the norm probe's hold and backstop, the ARGOS
mode, and the fused branch, against ``demodulate_many`` and the JAX
package (same recordings, plan and tolerance as tests/test_torch_serving.py;
the CPU runs the kernels' plain versions)."""

import numpy as np
import torch

from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.utils import synth, wav as W
from project_desert_tortoise_tpu.utils.config import ARGOS_REALTIME, POES_TIP
from project_desert_tortoise_tpu_torch.ops import agc as agc_ops
from project_desert_tortoise_tpu_torch.parallel import blocked as TB
from project_desert_tortoise_tpu_torch.parallel import serving as TS
from test_torch_serving import (  # noqa: F401 (fixtures)
    FS, PLAN, _lines, _parity, port_many, recordings)

torch.set_num_threads(1)


def test_dispatch_waits_for_channel_0s_norm_probe(recordings, port_many):
    """A lagging channel 0 must not get early blocks demodulated at gain
    1.0: pump() holds ready blocks until the probe has run on channel 0's
    first chunk (the demodulate_many contract), then catches up."""
    iq, _, _ = recordings
    bank = TS.ChannelBank(POES_TIP, FS, 2, plan=TB.BlockPlan(*PLAN),
                          batch_blocks=16, device="cpu")
    bank.push(1, np.real(iq[1]), np.imag(iq[1]))   # three blocks ready
    assert bank.pump() == 0 and bank.norm is None
    assert not bank.frames[1] and bank.batches == 0
    bank.push(0, np.real(iq[0]), np.imag(iq[0]))
    assert bank.norm == agc_ops.static_gain(iq[0, :POES_TIP.chunk_size],
                                            POES_TIP.static_gain_level)
    assert bank.drain() == 10
    for c, want in enumerate(port_many):
        assert _lines(bank.frames[c]) == _lines(want)


def test_norm_backstop_on_a_dead_channel_0(recordings):
    """A silent channel 0 must not stall the bank: once another channel has
    banked total + 8 cores, the probe falls back to the first channel with
    a full chunk, and dispatch goes on with bounded history."""
    iq, _, _ = recordings
    P = TB.BlockPlan(*PLAN)
    bank = TS.ChannelBank(POES_TIP, FS, 2, plan=P, batch_blocks=16,
                          device="cpu")
    for k in range(3):                     # 3x the recording on channel 1
        bank.push(1, np.real(iq[1]), np.imag(iq[1]))
        n = bank.pump()
        assert (n == 0) == (k < 2)
        assert (bank.norm is None) == (k < 2)
    assert bank.norm == agc_ops.static_gain(iq[1, :POES_TIP.chunk_size],
                                            POES_TIP.static_gain_level)
    assert bank.pump() == 0               # collects the batch in flight
    assert len(bank.frames[1]) >= 20 and not bank.frames[0]
    c1 = bank.channels[1]
    assert c1.base > 0 and len(c1.re) <= P.total + 10 * P.core


def test_argos_mode(recordings):
    """ARGOS_REALTIME (interp 1, squelch after the AGC, 9-byte packets)
    streamed through the bank: demodulate_many's lines, JAX's frames, the
    synthesized packets."""
    fs = 32000.0
    iq, payloads = synth.make_argos_recording(n_packets=3, fs=fs,
                                              snr_db=30.0)
    plan = TB.BlockPlan(*PLAN)
    t = W.time_axis(len(iq), fs, np.float32)
    many = TB.demodulate_many(iq[None, :], t, fs, ARGOS_REALTIME, plan=plan,
                              batch_blocks=8, device="cpu")
    jax = JB.demodulate_many(iq[None, :], t, fs, ARGOS_REALTIME,
                             plan=JB.BlockPlan(*PLAN), batch_blocks=8)
    bank = TS.ChannelBank(ARGOS_REALTIME, fs, 1, plan=plan, batch_blocks=8,
                          device="cpu")
    for lo in range(0, len(iq), 60000):
        bank.push(0, np.real(iq[lo:lo + 60000]), np.imag(iq[lo:lo + 60000]))
        bank.pump()
    bank.drain()
    assert _lines(bank.frames[0]) == _lines(many[0])
    _parity(jax[0], many[0], fs)
    sent = {bytes(p) for p in payloads}
    got = {bytes(f.data[-7:]) for f in bank.frames[0]}
    assert len(got & sent) >= len(payloads) - 1


def test_fused_branch_lines_contain_the_scan_branch(recordings, port_many):
    """use_pallas="fused" in 128-row padded batches (position generation
    in the kernel, 118 silent rows): every line of the scan branch, and
    no frame twice."""
    iq, _, _ = recordings
    bank = TS.ChannelBank(POES_TIP, FS, 2, plan=TB.BlockPlan(*PLAN),
                          batch_blocks=128, window=256, use_pallas="fused",
                          device="cpu")
    for c in range(2):
        bank.push(c, np.real(iq[c]), np.imag(iq[c]))
    bank.drain()
    assert bank.batches == 1
    for c, want in enumerate(port_many):
        mine = _lines(bank.frames[c])
        assert len(set(mine)) == len(mine)
        assert set(mine) >= set(_lines(want))


def test_concurrent_pushes_lose_nothing():
    """16 producer threads, one a channel, push 40 pieces each while the
    interpreter switches threads every microsecond: every channel banks
    its samples in order, its count and its accumulated time axis whole
    (no pump: the history is not trimmed)."""
    import sys
    import threading

    from project_desert_tortoise_tpu_torch.utils import wav as TW
    C, pieces, size = 16, 40, 997
    bank = TS.ChannelBank(POES_TIP, FS, C, plan=TB.BlockPlan(*PLAN),
                          device="cpu")
    data = np.random.default_rng(0).standard_normal(
        (C, 2, pieces * size)).astype(np.float32)

    def produce(c):
        for k in range(pieces):
            sl = slice(k * size, (k + 1) * size)
            bank.push(c, data[c, 0, sl], data[c, 1, sl])
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=produce, args=(c,))
                   for c in range(C)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(th.is_alive() for th in threads)
    t = TW.time_axis(pieces * size + 1, FS, np.float32)
    for c, ch in enumerate(bank.channels):
        assert ch.count == pieces * size
        assert np.array_equal(ch.re, data[c, 0])
        assert np.array_equal(ch.im, data[c, 1])
        assert np.array_equal(ch.t_ext, t)

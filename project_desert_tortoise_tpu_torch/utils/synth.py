"""IQ test-signal synthesis: Manchester-BPSK telemetry generator.

Builds reference-compatible POES TIP / ARGOS style baseband recordings with a
known frame payload, carrier offset, and SNR — the framework's synthetic
golden fixtures (the reference repo ships only two short real recordings).

Encoding conventions derived from the decoder (``ManchesterDecode.c:57-83``):
bit '1' = (+,-) symbol pair, bit '0' = (-,+).  Modulation is phase modulation
with a +/-67-degree index (1.16937 rad — the reference's CONST_PERFECT,
``CarrierTrackPLL.h:8``), leaving the residual carrier the reference's lock
detector tracks (``CarrierTrackingPLL.c:220``); the data lands on the
imaginary arm after the PLL mixes the carrier down
(``CarrierTrackingPLL.c:113``).
"""

from __future__ import annotations

import numpy as np


def bytes_to_bits(data: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.asarray(data, np.uint8))


def make_poes_frame(frame_id: int, spacecraft: int = 15,
                    rng=None) -> np.ndarray:
    """A plausible 104-byte TIP minor frame with valid sync and parity."""
    rng = rng or np.random.default_rng(frame_id)
    f = rng.integers(0, 256, 104).astype(np.uint8)
    f[0], f[1] = 0xED, 0xE2
    # byte 3: top 3 bits are the sync-word tail '000'; low bits carry the
    # spacecraft id (daytimeDecode.m:73-84)
    f[2] = spacecraft & 0x1F
    f[4] = (f[4] & 0xFE) | ((frame_id >> 8) & 1)
    f[5] = frame_id & 0xFF
    # word-103 parity bits (checkParity.m groups)
    groups = [(3, 19), (20, 36), (37, 53), (54, 70), (71, 87)]
    last = 0
    pop = np.unpackbits(f[None, :], axis=1).reshape(104, 8).sum(1)
    for g, (lo, hi) in enumerate(groups):
        ones = int(pop[lo - 1:hi].sum())
        last |= (ones % 2) << (5 - g)
    f[103] = last
    return f


def manchester_bpsk_iq(bits: np.ndarray, fs: float, bit_rate: float,
                       carrier_hz: float, snr_db: float = 30.0,
                       amplitude: float = 0.01, phase0: float = 0.3,
                       lead_s: float = 0.3, tail_s: float = 0.1,
                       rx_bw_hz: float = 0.0, rng=None) -> np.ndarray:
    """Modulate a bit stream; returns complex64 IQ at `fs`.

    Leading/trailing noise-only padding gives the PLL/AGC something to chew
    during acquisition, like a real pass.  Pass `rx_bw_hz` to band-limit the
    modulated signal like an SDR front-end (introduces chip-rate ISI, so the
    default leaves chips crisp).
    """
    rng = rng or np.random.default_rng(0)
    sym_rate = 2.0 * bit_rate
    chips = np.empty(2 * len(bits), np.float64)
    chips[0::2] = np.where(bits, 1.0, -1.0)
    chips[1::2] = -chips[0::2]
    n_data = int(len(chips) * fs / sym_rate)
    tt = np.arange(n_data) / fs
    chip_idx = np.minimum((tt * sym_rate).astype(np.int64), len(chips) - 1)
    m = chips[chip_idx]
    # PM with residual carrier: phase deviation +/- mod_index around the
    # carrier; sin(mod_index)*m is the data arm, cos(mod_index) the carrier
    mod_index = 1.16937
    data = amplitude * np.exp(
        1j * (2 * np.pi * carrier_hz * tt + phase0 + mod_index * m))

    if rx_bw_hz:
        # receiver band-limiting (windowed-sinc lowpass, complex baseband)
        bw = min(rx_bw_hz, 0.45 * fs)
        ntaps = 101
        n = np.arange(ntaps) - (ntaps - 1) / 2
        h = np.sinc(2 * bw / fs * n) * np.blackman(ntaps)
        h /= h.sum()
        data = np.convolve(data, h, mode="same")

    n_lead, n_tail = int(lead_s * fs), int(tail_s * fs)
    sig = np.concatenate([np.zeros(n_lead, complex), data,
                          np.zeros(n_tail, complex)])
    noise_amp = amplitude / (10 ** (snr_db / 20.0))
    noise = noise_amp * (rng.standard_normal(len(sig))
                         + 1j * rng.standard_normal(len(sig))) / np.sqrt(2)
    return (sig + noise).astype(np.complex64)


def make_poes_recording(n_frames: int = 8, fs: float = 50000.0,
                        carrier_hz: float = -3000.0, snr_db: float = 25.0,
                        rng=None):
    """Synthesized POES TIP pass; returns (iq, frames list of 104-byte arrays)."""
    rng = rng or np.random.default_rng(42)
    frames = [make_poes_frame(i, rng=rng) for i in range(n_frames)]
    bits = np.concatenate([bytes_to_bits(f) for f in frames])
    iq = manchester_bpsk_iq(bits, fs, 8320.0, carrier_hz, snr_db, rng=rng)
    return iq, frames


def make_argos_recording(n_packets: int = 3, fs: float = 32000.0,
                         carrier_hz: float = 200.0, snr_db: float = 30.0,
                         gap_s: float = 0.5, invert_bits: bool = False,
                         rng=None):
    """Synthesized ARGOS pass: short 400 bit/s packets with the 13-bit sync.

    Returns (iq, payloads) where each payload is the 7 data bytes the
    reference framer emits (``ARGOSdemod/ByteSync.c:69``).

    ``invert_bits`` complements the transmitted bit stream — from the
    receiver this is indistinguishable from the Costas loop settling on the
    opposite BPSK lock point, so packets only decode through the framer's
    inverse-sync path (``ARGOSdemodPortAudio/ByteSync.c:112``)."""
    rng = rng or np.random.default_rng(7)
    sync = np.array([0, 0, 0, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0], np.uint8)
    pieces, payloads = [], []
    for k in range(n_packets):
        payload = rng.integers(0, 256, 7).astype(np.uint8)
        payloads.append(payload)
        bits = np.concatenate([
            np.tile([1, 0], 30).astype(np.uint8),   # CW/preamble-ish warmup
            sync, bytes_to_bits(payload)])
        if invert_bits:
            bits = (1 - bits).astype(np.uint8)
        pieces.append(manchester_bpsk_iq(
            bits, fs, 400.0, carrier_hz, snr_db, lead_s=0.4, tail_s=gap_s,
            rng=rng))
    return np.concatenate(pieces), payloads

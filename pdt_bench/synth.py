"""Synthetic recorded passes, made on the device from the seed.

A PyTorch copy of the test-signal formulas of the program's
``utils/synth.py`` and ``chip_smoke.py::synth_pass``, frozen here: Manchester
BPSK phase-modulated at +/-1.16937 rad on a residual carrier, noise-only
lead and tail, complex Gaussian noise at the configured SNR, then scaled to
1/1.2 of full scale and quantised to the int16 planes of a 16-bit IQ WAV.

Everything that sets how much work a pass is (its length, the count and
layout of frames or packets, SNR, carrier offset) comes from the
configuration file; the seed draws only the payload bytes, the noise
realisation and the starting phase of the carrier.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch


class Pass(NamedTuple):
    re16: np.ndarray                 # (n,) int16 host planes
    im16: np.ndarray
    payloads: List[bytes]            # what a decoder should recover


# bytes 3..87 of a TIP minor frame in five parity groups, each group's
# parity a bit of byte 103 (checkParity.m)
_PARITY_GROUPS = ((3, 19), (20, 36), (37, 53), (54, 70), (71, 87))


def tip_frames(raw: np.ndarray, spacecraft: int) -> np.ndarray:
    """104-byte TIP minor frames from (F, 104) random bytes: sync bytes
    ED E2, the spacecraft id, the frame counter in bytes 4-5 and the parity
    byte 103."""
    f = raw.copy()
    ids = np.arange(len(f))
    f[:, 0], f[:, 1] = 0xED, 0xE2
    f[:, 2] = spacecraft & 0x1F
    f[:, 4] = (f[:, 4] & 0xFE) | ((ids >> 8) & 1)
    f[:, 5] = ids & 0xFF
    pop = np.unpackbits(f, axis=1).reshape(len(f), 104, 8).sum(
        2, dtype=np.int64)
    last = np.zeros(len(f), np.int64)
    for g, (lo, hi) in enumerate(_PARITY_GROUPS):
        last |= (pop[:, lo - 1:hi].sum(1) % 2) << (5 - g)
    f[:, 103] = last
    return f


def bits_of(data: torch.Tensor) -> torch.Tensor:
    """(..., k) uint8 bytes -> (..., 8k) bits, most significant first."""
    shifts = torch.arange(7, -1, -1, device=data.device)
    return ((data[..., None].to(torch.int64) >> shifts) & 1).reshape(
        *data.shape[:-1], -1)


def modulate(bits: torch.Tensor, sig, fs: int, phase0: float) -> torch.Tensor:
    """Manchester BPSK of (..., nb) bits: chips (+,-) for 1, (-,+) for 0 at
    twice the bit rate, phase deviation mod_index around the carrier.
    Returns (..., n) complex128 with n = chips * fs / chip rate."""
    chip_rate = 2 * int(sig["bit_rate"])
    chips = torch.stack([bits, 1 - bits], -1).reshape(*bits.shape[:-1], -1)
    n_chips = chips.shape[-1]
    n = n_chips * fs // chip_rate
    i = torch.arange(n, device=bits.device)
    idx = torch.clamp(i * chip_rate // fs, max=n_chips - 1)
    m = chips[..., idx].to(torch.float64) * 2.0 - 1.0
    tt = i.to(torch.float64) / fs
    ph = (2 * math.pi * sig["carrier_hz"]) * tt + phase0 + sig["mod_index"] * m
    return sig["amplitude"] * torch.polar(torch.ones_like(ph), ph)


def add_noise_and_quantise(sig, clean: torch.Tensor, g: torch.Generator):
    """Complex Gaussian noise at the SNR, complex64, scaled so the largest
    magnitude sits at 1/full_scale of full scale, rounded to int16."""
    amp = sig["amplitude"] / 10 ** (sig["snr_db"] / 20.0)
    noise = torch.randn((2, clean.shape[0]), generator=g,
                        device=clean.device, dtype=torch.float64)
    iq = (clean + torch.complex(noise[0], noise[1]) * (amp / math.sqrt(2))
          ).to(torch.complex64)
    iq = iq / (torch.abs(iq).max() * sig["full_scale"])
    q = lambda x: torch.clamp(torch.round(x * 32767), -32768, 32767).to(
        torch.int16).cpu().numpy()
    return q(iq.real), q(iq.imag)


def poes_tip_pass(sig, fs: int, seed: int, device) -> Pass:
    """A POES TIP pass: `frames` consecutive minor frames (frame 0 the
    acquisition lead-in), noise-only lead and tail."""
    g = torch.Generator(device).manual_seed(seed)
    raw = torch.randint(0, 256, (sig["frames"], 104), generator=g,
                        device=device, dtype=torch.int64)
    phase0 = float(torch.rand((), generator=g, device=device)) * 2 * math.pi
    frames = tip_frames(raw.to(torch.uint8).cpu().numpy(), sig["spacecraft"])
    data = modulate(bits_of(torch.from_numpy(frames).to(device).reshape(-1)),
                    sig, fs, phase0)
    z = lambda s: torch.zeros(int(s * fs), dtype=data.dtype, device=device)
    clean = torch.cat([z(sig["lead_s"]), data, z(sig["tail_s"])])
    re16, im16 = add_noise_and_quantise(sig, clean, g)
    return Pass(re16, im16, [bytes(f) for f in frames[1:]])


def argos_pass(sig, fs: int, seed: int, device) -> Pass:
    """An ARGOS pass: `packets` packets, each a noise-only lead, 30 bit
    pairs of preamble, the 13-bit sync and 7 payload bytes, then a noise
    gap; each packet's carrier starts at the same phase."""
    g = torch.Generator(device).manual_seed(seed)
    P = sig["packets"]
    raw = torch.randint(0, 256, (P, 7), generator=g, device=device,
                        dtype=torch.int64)
    phase0 = float(torch.rand((), generator=g, device=device)) * 2 * math.pi
    head = torch.tensor([1, 0] * 30 + [int(c) for c in sig["sync_word"]],
                        device=device, dtype=torch.int64)
    bits = torch.cat([head.expand(P, -1), bits_of(raw)], -1)
    data = modulate(bits, sig, fs, phase0)
    lead = int(sig["lead_s"] * fs)
    gap = int(sig["gap_s"] * fs)
    clean = torch.zeros((P, lead + data.shape[-1] + gap), dtype=data.dtype,
                        device=device)
    clean[:, lead:lead + data.shape[-1]] = data
    re16, im16 = add_noise_and_quantise(sig, clean.reshape(-1), g)
    payloads = [bytes(p) for p in raw.to(torch.uint8).cpu().numpy()]
    return Pass(re16, im16, payloads)


KINDS = {"poes_tip": poes_tip_pass, "argos": argos_pass}


def pass_samples(cfg) -> int:
    """The samples of the configuration's pass, whatever the seed."""
    sig, fs = cfg["pass"], int(cfg["fs"])
    per_chip = lambda bits: 2 * bits * fs // (2 * int(sig["bit_rate"]))
    if sig["kind"] == "poes_tip":
        return (int(sig["lead_s"] * fs) + per_chip(sig["frames"] * 104 * 8)
                + int(sig["tail_s"] * fs))
    bits = 60 + len(sig["sync_word"]) + 56
    return sig["packets"] * (int(sig["lead_s"] * fs) + per_chip(bits)
                             + int(sig["gap_s"] * fs))


def make_pass(cfg, seed: int, device) -> Pass:
    sig = cfg["pass"]
    p = KINDS[sig["kind"]](sig, int(cfg["fs"]), seed, device)
    if len(p.re16) != pass_samples(cfg):
        raise AssertionError(f"{len(p.re16)} samples made, "
                             f"{pass_samples(cfg)} configured")
    return p

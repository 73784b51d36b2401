"""Costas carrier-tracking PLL, one sample at a time on (B,) lane tensors.

Twin of ``project_desert_tortoise_tpu/ops/pll.py`` (``_step``,
``pll.py:88-141``; reference ``common/CarrierTrackingPLL.c:54-278``):
second-order loop on the wrapped fast-atan2 phase error, BPSK data on the
imaginary arm, EWMA lock detector over the Q_rsqrt-normalised carrier
projection, triangle frequency sweep during acquisition and a one-shot
acquisition->track bandwidth switch.  Every operation is one op in the
stream's dtype (float32, or float64 for the ``argos`` mode's exact chain)
in the JAX order, so the kernels' step (``csrc/pdt_common.cuh::pll_step``)
matches it bit for bit on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from project_desert_tortoise_tpu_torch.ops.fastmath import arctan2_approx, q_rsqrt


class PLLParams(NamedTuple):
    """Static per-mode parameters (python floats)."""
    alpha_acq: float
    beta_acq: float
    alpha_track: float
    beta_track: float
    max_freq: float          # +/- 2*pi*freqRange/Fs
    lock_alpha: float
    lock_threshold: float
    sweep_step: float        # 0.2 * 2*pi/Fs (CarrierTrackingPLL.c:99)
    sweep_threshold: float
    avg_phase_alpha: float


def loop_coeffs(bw: float, damp: float = 0.999):
    """2nd-order loop alpha/beta from bandwidth (CarrierTrackingPLL.c:90)."""
    alpha = (4.0 * damp * bw) / (1.0 + 2.0 * damp * bw + bw * bw)
    beta = (4.0 * bw * bw) / (1.0 + 2.0 * damp * bw + bw * bw)
    return alpha, beta


def make_params(pll_cfg, fs: float) -> PLLParams:
    two_pi_fs = 2.0 * np.pi / fs
    aa, ba = loop_coeffs(pll_cfg.acq_gain_rad_s * two_pi_fs, pll_cfg.damping)
    at, bt = loop_coeffs(pll_cfg.track_gain_rad_s * two_pi_fs, pll_cfg.damping)
    return PLLParams(
        alpha_acq=aa, beta_acq=ba, alpha_track=at, beta_track=bt,
        max_freq=2.0 * np.pi * pll_cfg.max_carrier_deviation_hz / fs,
        lock_alpha=pll_cfg.lock_alpha_rad_s * two_pi_fs,
        lock_threshold=pll_cfg.lock_threshold,
        sweep_step=pll_cfg.sweep_rad_s2 * two_pi_fs,
        sweep_threshold=pll_cfg.sweep_threshold,
        avg_phase_alpha=pll_cfg.avg_phase_alpha,
    )


class PLLState(NamedTuple):
    phase: torch.Tensor      # d_phase
    freq: torch.Tensor       # d_freq
    locksig: torch.Tensor    # d_locksig
    avg_phase: torch.Tensor  # quality EWMA, init pi/2
    sweep: torch.Tensor      # signed sweep step
    locked: torch.Tensor     # bool: bandwidth switched to tracking


def init_state(params: PLLParams, batch_shape=(), *, device,
               dtype=torch.float32) -> PLLState:
    full = lambda v: torch.full(batch_shape, v, dtype=dtype, device=device)
    return PLLState(
        phase=full(0.1),                 # CarrierTrackingPLL.c:93
        freq=full(0.0),
        locksig=full(0.0),
        avg_phase=full(np.pi / 2.0),
        sweep=full(params.sweep_step),
        locked=torch.zeros(batch_shape, dtype=torch.bool, device=device),
    )


class LoopConsts(NamedTuple):
    """The loop's constants as (B,) lane tensors in the stream's dtype:
    tensor-tensor ops dispatch faster than ops with a python scalar, and the
    per-sample loops of this package run a few hundred ops per sample.  Each
    value is rounded as the JAX step rounds it (``1.0 - c(alpha)`` is a
    subtraction in the stream's dtype there)."""
    alpha_acq: torch.Tensor
    beta_acq: torch.Tensor
    alpha_track: torch.Tensor
    beta_track: torch.Tensor
    max_freq: torch.Tensor
    neg_max_freq: torch.Tensor
    lock_alpha: torch.Tensor
    one_minus_lock: torch.Tensor
    lock_threshold: torch.Tensor
    sweep_threshold: torch.Tensor
    avg_alpha: torch.Tensor
    one_minus_avg: torch.Tensor
    pi: torch.Tensor
    neg_pi: torch.Tensor
    two_pi: torch.Tensor
    neg_two_pi: torch.Tensor
    half_pi: torch.Tensor
    zero: torch.Tensor


def stream_dtype(like: torch.Tensor) -> torch.dtype:
    """The dtype of the stream that `like` belongs to: float64 for the
    ``argos`` mode's exact chain, float32 for everything else."""
    return torch.float64 if like.dtype == torch.float64 else torch.float32


def loop_consts(params: PLLParams, like: torch.Tensor) -> LoopConsts:
    """The constants of a step on lanes shaped like `like`, in its
    :func:`stream_dtype`."""
    dt = stream_dtype(like)
    c = (np.float64 if dt == torch.float64 else np.float32)
    vals = dict(
        alpha_acq=params.alpha_acq, beta_acq=params.beta_acq,
        alpha_track=params.alpha_track, beta_track=params.beta_track,
        max_freq=params.max_freq, neg_max_freq=-c(params.max_freq),
        lock_alpha=params.lock_alpha,
        one_minus_lock=c(1.0) - c(params.lock_alpha),
        lock_threshold=params.lock_threshold,
        sweep_threshold=params.sweep_threshold,
        avg_alpha=params.avg_phase_alpha,
        one_minus_avg=c(1.0) - c(params.avg_phase_alpha),
        pi=np.pi, neg_pi=-c(np.pi), two_pi=2.0 * np.pi,
        neg_two_pi=-c(2.0 * np.pi), half_pi=np.pi / 2.0, zero=0.0)
    return LoopConsts(**{k: torch.full(like.shape, float(c(v)), dtype=dt,
                                       device=like.device)
                         for k, v in vals.items()})


def input_terms(zre: torch.Tensor, zim: torch.Tensor):
    """The parts of a step that depend on the input sample alone: the raw
    sample phase and the Q_rsqrt-normalised sample.  Elementwise, so callers
    that own a whole block compute them for all samples at once."""
    sample_phase = arctan2_approx(zim, zre)
    inv = q_rsqrt(zre * zre + zim * zim)
    return sample_phase, zre * inv, zim * inv


def step_with_terms(k: LoopConsts, state: PLLState, zre, zim,
                    sample_phase, zre_n, zim_n):
    """One PLL step given the loop constants and :func:`input_terms` of the
    sample."""
    t_im = torch.sin(state.phase)
    t_re = torch.cos(state.phase)

    # mix by conjugate carrier; data rides the imaginary arm
    out = zim * t_re - zre * t_im
    pll_re = zre * t_re + zim * t_im

    out_phase = arctan2_approx(out, pll_re)
    avg_phase = (state.avg_phase * k.one_minus_avg
                 + k.avg_alpha * torch.abs(out_phase))

    # wrapped phase error against the NCO
    err = sample_phase - state.phase
    err = torch.where(err > k.pi, err - k.two_pi,
                      torch.where(err < k.neg_pi, err + k.two_pi, err))

    alpha = torch.where(state.locked, k.alpha_track, k.alpha_acq)
    beta = torch.where(state.locked, k.beta_track, k.beta_acq)

    freq = state.freq + beta * err
    phase = state.phase + freq + alpha * err
    phase = torch.where(phase > k.two_pi, phase - k.two_pi, phase)
    phase = torch.where(phase < k.neg_two_pi, phase + k.two_pi, phase)
    freq = torch.minimum(torch.maximum(freq, k.neg_max_freq), k.max_freq)

    # lock detector over the Q_rsqrt-normalized carrier projection
    locksig = (state.locksig * k.one_minus_lock
               + k.lock_alpha * (zre_n * t_re + zim_n * t_im))

    # acquisition frequency sweep (CarrierTrackingPLL.c:231-263)
    sweeping = ((torch.abs(k.half_pi - avg_phase) < k.sweep_threshold)
                & ~state.locked)
    freq_swept = freq + state.sweep
    at_edge = (freq_swept >= k.max_freq) | (freq_swept <= k.neg_max_freq)
    mag = torch.abs(state.sweep)
    sweep_new = torch.where(
        at_edge, -state.sweep,
        torch.where(freq_swept >= k.zero, mag, -mag))
    freq = torch.where(sweeping, freq_swept, freq)
    sweep = torch.where(sweeping, sweep_new, state.sweep)

    locked = state.locked | (locksig > k.lock_threshold)

    new_state = PLLState(phase=phase, freq=freq, locksig=locksig,
                         avg_phase=avg_phase, sweep=sweep, locked=locked)
    return new_state, (out, locksig)


def step(params: PLLParams, state: PLLState, zre, zim):
    """One PLL step on (B,) lanes; returns (state, (out, locksig))."""
    return step_with_terms(loop_consts(params, state.phase), state, zre, zim,
                           *input_terms(zre, zim))


def pll_scan_ref(params: PLLParams, state: PLLState, zre, zim):
    """The PLL over the last axis of (..., n) planes (JAX ``pll_scan``) as
    a plain loop, on any device; returns (state, out, locksig) with the
    outputs shaped like the input.  It is the plain version of the kernel
    ``ops/kernels/pll_kernel.py::pll_scan_kernel``, the entry point that
    runs it on CPU tensors."""
    k = loop_consts(params, state.phase)
    cols = [x.unbind(-1) for x in (zre, zim, *input_terms(zre, zim))]
    outs, locks = [], []
    for x in zip(*cols):
        state, (o, lk) = step_with_terms(k, state, *x)
        outs.append(o)
        locks.append(lk)
    return state, torch.stack(outs, -1), torch.stack(locks, -1)

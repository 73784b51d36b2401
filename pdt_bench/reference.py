"""Plain reference of the block-parallel whole-file demodulator.

Computes, from a pass's int16 planes and the configuration file alone, the
frames that the block-parallel fast path should return: the recording cut
into overlapping ``[head | core | tail]`` blocks, each block's carrier
estimated from its squared spectrum, then per block the Costas PLL
warm-started at that estimate (tracking bandwidth, no acquisition sweep),
the zero-stuffing FIR interpolator, the attack/decay AGC, the squelch where
the configuration has one, Gardner timing with the Manchester decision in
fixed windows, the sync-word framer, and the frames kept whose sync lies in
their block's core.  It follows the reference program's equations
(nebarnix/Project-Desert-Tortoise ``common/CarrierTrackingPLL.c``,
``LowPassFilter.c``, ``AGC.c``, ``GardenerClockRecovery.c``,
``ManchesterDecode.c``, ``ByteSync.c``) with the block-parallel layout of
the port's fast path, and imports nothing of the program.

The recurrences step all blocks at once, one sample (or symbol slot) at a
time, in an arithmetic given by ``Arith``: float32 in NumPy for the
benchmark's check, or a torch dtype (bfloat16 for the control that the
limits were set against).  The FIR runs as one torch convolution over all
blocks, the carrier estimate as torch FFTs in float32 (torch has no
bfloat16 FFT).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Arith:
    """Elementwise arithmetic of the recurrences on (B,) lane arrays:
    NumPy float32 (``Arith()``) or torch tensors of `dtype`
    (``Arith(torch.bfloat16)``).  Integer indices stay int64 either way."""

    def __init__(self, dtype=None):
        self.torch = dtype is not None
        self.dtype = dtype if self.torch else np.float32

    def c(self, v):
        """The constant v rounded to the arithmetic's dtype."""
        if self.torch:
            return torch.tensor(float(np.float32(v)), dtype=self.dtype)
        return np.float32(v)

    def arr(self, a):
        """A float32 NumPy array in the arithmetic's dtype."""
        if self.torch:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.dtype)
        return np.asarray(a, np.float32)

    def zeros(self, shape):
        if self.torch:
            return torch.zeros(shape, dtype=self.dtype)
        return np.zeros(shape, np.float32)

    def where(self, cond, a, b):
        return (torch.where if self.torch else np.where)(cond, a, b)

    def sin(self, x):
        return (torch.sin if self.torch else np.sin)(x)

    def cos(self, x):
        return (torch.cos if self.torch else np.cos)(x)

    def rint(self, x):
        """Round half to even."""
        return (torch.round if self.torch else np.rint)(x)

    def minimum(self, a, b):
        return (torch.minimum if self.torch else np.minimum)(a, b)

    def maximum(self, a, b):
        return (torch.maximum if self.torch else np.maximum)(a, b)

    def to_index(self, x):
        """Whole-valued floats as an int64 NumPy array."""
        return (x.to(torch.float32).numpy() if self.torch
                else np.asarray(x)).astype(np.int64)

    def take(self, plane, rows, lanes):
        """plane[rows[b], b] for each lane b of a time-major plane."""
        return plane[torch.from_numpy(rows), torch.from_numpy(lanes)] \
            if self.torch else plane[rows, lanes]


class Plan(NamedTuple):
    core: int
    head: int
    tail: int
    max_frames: int

    @property
    def total(self) -> int:
        return self.head + self.core + self.tail


def plan_of(cfg) -> Plan:
    p = cfg["plan"]
    return Plan(p["core"], p["head"], p["tail"], p["max_frames"])


class Chain(NamedTuple):
    """The chain's constants, as the reference program derives them from
    its macros (rates in rad/s scaled by 2*pi/Fs at the call sites)."""
    fs: float
    interp: int
    taps: np.ndarray            # float32
    alpha: float
    beta: float
    max_freq: float
    lock_alpha: float
    agc_attack: float
    agc_decay: float
    agc_reference: float
    agc_max: float
    agc_min: float
    squelch: float              # NaN: none
    step_size: float
    err_limit: float
    kp: float
    resync: float


def loop_coeffs(bw: float, damp: float):
    """Second-order loop gains from the bandwidth
    (CarrierTrackingPLL.c:90)."""
    alpha = (4.0 * damp * bw) / (1.0 + 2.0 * damp * bw + bw * bw)
    beta = (4.0 * bw * bw) / (1.0 + 2.0 * damp * bw + bw * bw)
    return alpha, beta


def lowpass_taps(order: int, cutoff_hz: float, fs_hz: float, interp: int,
                 design_dtype) -> np.ndarray:
    """Blackman windowed-sinc lowpass gained by `interp`
    (LowPassFilter.c:127-175), designed in the mode's precision."""
    dt = np.dtype(design_dtype)
    n = np.arange(order, dtype=np.float64)
    wc = np.float64(dt.type(2.0 * np.pi * cutoff_hz / fs_hz))
    tou = np.float64(dt.type((order - 1.0) / 2.0))
    with np.errstate(invalid="ignore", divide="ignore"):
        hd = np.sin(wc * (n - tou)) / (np.pi * (n - tou))
    if order % 2 == 1:
        hd[(order - 1) // 2] = wc / np.pi
    wn = (0.42 - 0.5 * np.cos(2 * np.pi * n / (order - 1))
          + 0.08 * np.cos(4 * np.pi * n / (order - 1)))
    return (hd * wn * float(interp)).astype(dt).astype(np.float32)


def chain_of(cfg) -> Chain:
    fs = float(cfg["fs"])
    pll, fir, agc = cfg["pll"], cfg["fir"], cfg["agc"]
    gar, sq = cfg["gardner"], cfg["squelch"]
    design = cfg["design_dtype"]
    interp = int(fir["interp"])
    fs_i = fs * interp
    two_pi_fs = 2.0 * math.pi / fs
    alpha, beta = loop_coeffs(pll["track_gain_rad_s"] * two_pi_fs,
                              pll["damping"])
    return Chain(
        fs=fs, interp=interp,
        taps=lowpass_taps(fir["base_order"] * interp, fir["cutoff_hz"],
                          fs_i, interp, design),
        alpha=alpha, beta=beta,
        max_freq=2.0 * math.pi * pll["max_carrier_deviation_hz"] / fs,
        lock_alpha=pll["lock_alpha_rad_s"] * two_pi_fs,
        agc_attack=agc["attack_rate_rad_s"] * (2.0 * math.pi / fs_i),
        agc_decay=agc["decay_rate_rad_s"] * (2.0 * math.pi / fs_i),
        agc_reference=agc["reference_level"], agc_max=agc["max_gain"],
        agc_min=agc["min_gain"],
        squelch=float(sq["threshold"]) if sq else float("nan"),
        step_size=float(np.dtype(design).type(
            np.float64(fs_i) / np.float64(gar["baud"]))),
        err_limit=gar["error_limit"], kp=gar["gain"],
        resync=cfg["manchester"]["resync_threshold"])


def static_gain(re16, im16, n: int, level: float) -> float:
    """The normalisation probe over the first `n` samples (AGC.c:48-75):
    avg = |z0|, then avg = (avg + |z_i|) / 2 for every sample, in float32
    with a double intermediate; the gain is level / avg."""
    z = np.empty(min(n, len(re16)), np.complex64)
    z.real = re16[:len(z)].astype(np.float32) / np.float32(32768)
    z.imag = im16[:len(z)].astype(np.float32) / np.float32(32768)
    mags = np.abs(z)
    avg = mags[0]
    for m in mags.tolist():
        avg = np.float32((float(avg) + m) / 2.0)
    return float(np.float32(np.float64(level) / np.float64(avg)))


def time_axis(n: int, fs: float) -> np.ndarray:
    """The recording's float32 time axis with one sample past its end:
    t[i] = t[i-1] + Ts accumulated in float32 from t[-1] = 0 (wave.c:167)."""
    ts = np.float32(1.0) / np.float32(fs)
    return np.add.accumulate(np.full(n + 1, ts, np.float32), dtype=np.float32)


def block_windows(x16, plan: Plan, n_blocks: int) -> np.ndarray:
    """(B, total) int16 windows [k*core - head, +total) of the stream,
    zero outside it."""
    lead = np.zeros(plan.head, np.int16)
    span = (n_blocks - 1) * plan.core + plan.total
    s = np.concatenate([lead, x16])[:span]
    s = np.concatenate([s, np.zeros(span - len(s), np.int16)])
    view = np.lib.stride_tricks.sliding_window_view(s, plan.total)
    return np.ascontiguousarray(view[::plan.core][:n_blocks])


def carrier_estimate(re, im, fs: float, spacing: float,
                     nfft: int = 8192) -> np.ndarray:
    """Each block's carrier in Hz from the squared BPSK spectrum: the
    circular power centroid of the noise-subtracted squared spectrum over
    up to 4 spread length-nfft segments locates 2*f0, the strongest line
    within half a line spacing of it is the carrier's."""
    B, n = re.shape
    k = max(n // nfft, 1)
    zr = torch.from_numpy(re[:, :k * nfft].reshape(B, k, nfft))
    zi = torch.from_numpy(im[:, :k * nfft].reshape(B, k, nfft))
    if k > 4:
        stride = k // 4
        zr, zi = zr[:, ::stride][:, :4], zi[:, ::stride][:, :4]
    z = torch.complex(zr, zi)
    freqs = torch.fft.fftfreq(nfft, 1.0 / fs, dtype=torch.float32)
    sq = torch.abs(torch.fft.fft(z * z, dim=-1)).sum(-2)
    w = torch.clamp(sq - sq.mean(-1, keepdim=True), min=0.0) ** 2
    ph = torch.polar(torch.ones_like(freqs), (2 * np.pi / fs) * freqs)
    cen = torch.angle((w * ph).sum(-1)) * (fs / (2 * np.pi))
    d = torch.remainder(freqs - cen[:, None] + fs / 2, fs) - fs / 2
    masked = torch.where(torch.abs(d) < spacing / 2.0, sq, 0.0)
    return (freqs[torch.argmax(masked, dim=-1)] / 2.0).numpy()


def arctan2_approx(A: Arith, y, x):
    """The reference's quarter-circle atan2 (CarrierTrackingPLL.c:15)."""
    c1, c3 = A.c(0.78539816339744825), A.c(2.35619449019234475)
    abs_y = abs(y) + A.c(1e-10)
    with np.errstate(divide="ignore", invalid="ignore"):
        r_pos = (x - abs_y) / (x + abs_y)
        r_neg = (x + abs_y) / (abs_y - x)
    angle = A.where(x >= 0, c1 - c1 * r_pos, c3 - c1 * r_neg)
    return A.where(y < 0, -angle, angle)


def q_rsqrt(x: np.ndarray) -> np.ndarray:
    """Fast inverse square root with two Newton rounds, float32 bit trick
    (CarrierTrackingPLL.c:43)."""
    x = np.asarray(x, np.float32)
    i = np.int32(0x5F3759DF) - (x.view(np.int32) >> 1)
    g = i.view(np.float32)
    half = np.float32(0.5) * x
    g = g * (np.float32(1.5) - half * g * g)
    return g * (np.float32(1.5) - half * g * g)


def pll(A: Arith, ch: Chain, zre, zim, freq0):
    """The Costas loop over time-major (L, B) float32 planes from the
    warm start (phase 0.1, frequency freq0 rad/sample, tracking gains: a
    warm-started loop is locked from its first sample, so the acquisition
    sweep never runs).  Returns the data arm and the lock signal, (L, B)."""
    L, B = zre.shape
    sample_phase = A.arr(arctan2_approx(Arith(), zim, zre))
    inv = q_rsqrt(zre * zre + zim * zim)
    re_n, im_n = A.arr(zre * inv), A.arr(zim * inv)
    zre, zim = A.arr(zre), A.arr(zim)
    pi, two_pi = A.c(np.pi), A.c(2.0 * np.pi)
    neg_pi, neg_two_pi = -pi, -two_pi
    alpha, beta = A.c(ch.alpha), A.c(ch.beta)
    max_f = A.c(ch.max_freq)
    lock_a = A.c(ch.lock_alpha)
    keep = A.c(1.0) - lock_a
    phase = A.c(0.1) + A.zeros(B)
    freq = A.c(2.0 * np.pi / ch.fs) * A.arr(freq0)
    lock = A.zeros(B)
    out, locksig = A.zeros((L, B)), A.zeros((L, B))
    for i in range(L):
        s, c = A.sin(phase), A.cos(phase)
        out[i] = zim[i] * c - zre[i] * s
        err = sample_phase[i] - phase
        err = A.where(err > pi, err - two_pi,
                      A.where(err < neg_pi, err + two_pi, err))
        freq = freq + beta * err
        phase = phase + freq + alpha * err
        phase = A.where(phase > two_pi, phase - two_pi, phase)
        phase = A.where(phase < neg_two_pi, phase + two_pi, phase)
        freq = A.minimum(A.maximum(freq, -max_f), max_f)
        lock = lock * keep + lock_a * (re_n[i] * c + im_n[i] * s)
        locksig[i] = lock
    return out, locksig


def fir_interp(A: Arith, x, taps: np.ndarray, interp: int):
    """Zero-stuff (L, B) x by `interp` and filter with `taps` from a zero
    history: y[j] = sum_k taps[k] * s[j + k] over the stuffed stream s led
    by the history's zeros.  Returns (L * interp, B)."""
    L, B = x.shape
    n_taps = len(taps)
    hist = -(-(n_taps - 1) // interp)
    excess = hist * interp - (n_taps - 1)
    dt = A.dtype if A.torch else torch.float32
    xt = x.T if A.torch else torch.from_numpy(np.ascontiguousarray(x.T))
    s = torch.zeros((B, 1, (hist + L) * interp), dtype=dt)
    s[:, 0, hist * interp::interp] = xt
    w = torch.from_numpy(taps).to(dt).reshape(1, 1, n_taps)
    y = torch.nn.functional.conv1d(s[..., excess:], w)[:, 0]
    y = y.T.contiguous()
    return y if A.torch else y.numpy()


def agc(A: Arith, ch: Chain, x, gain0: float):
    """Attack/decay AGC (AGC.c:98-130) over time-major (L, B) x."""
    attack, decay = A.c(ch.agc_attack), A.c(ch.agc_decay)
    ref, zero = A.c(ch.agc_reference), A.c(0.0)
    g_max, g_min = A.c(ch.agc_max), A.c(ch.agc_min)
    gain = A.c(gain0) + A.zeros(x.shape[1])
    y = A.zeros(x.shape)
    for i in range(x.shape[0]):
        yi = x[i] * gain
        y[i] = yi
        e = abs(yi) - ref
        gain = gain - e * A.where(abs(e) > gain, attack, decay)
        gain = A.where(gain < zero, g_min, gain)
        gain = A.where(gain > g_max, g_max, gain)
    return y


def _np(x):
    """A lane array as NumPy (floats as float32)."""
    if isinstance(x, torch.Tensor):
        return (x.to(torch.float32) if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def _sign(x):
    return (x > 0).astype(np.int8) - (x < 0).astype(np.int8)


def gardner_manchester(A: Arith, ch: Chain, x, t, window: int):
    """Gardner timing and the Manchester decision over time-major (N, B)
    x in windows of `window` samples: each window's symbol slots (window /
    step * 1.08 + 4 of them) read the on-time sample, clamped into the
    window and `margin` samples of left context, and the mid-bit sample,
    0 outside it (GardenerClockRecovery.c:40-108, ManchesterDecode.c:27-97).
    Returns each lane's decided bits (uint8) and their times (float32, the
    on-time sample's entry of t), in order."""
    N, B = x.shape
    if N % window:
        raise ValueError(f"{N} samples is not a whole number of "
                         f"{window}-sample windows")
    mask = (lambda m: torch.from_numpy(m)) if A.torch else (lambda m: m)
    step = A.c(ch.step_size)
    half_step = step / A.c(2.0)
    kp, lim, thr = A.c(ch.kp), A.c(ch.err_limit), A.c(ch.resync)
    zero = A.c(0.0)
    margin = max(16, int(np.ceil(ch.step_size / 2.0 + ch.err_limit)) + 2)
    spw = int(window / ch.step_size * 1.08) + 4
    span = window + margin
    xp = A.zeros((N + margin, B))
    xp[margin:] = x
    tp = np.zeros((N + margin, B), np.float32)
    tp[margin:] = t
    lanes = np.arange(B)
    ns, half_raw, prev_bit = A.zeros(B), A.zeros(B), A.zeros(B)
    m_cur, m_prev, m_pprev = A.zeros(B), A.zeros(B), A.zeros(B)
    clockmod = np.zeros(B, np.int64)
    evenodd = np.zeros(B, np.int64)
    bits, times, emits = [], [], []
    for w in range(N // window):
        base = w * window - margin
        for _ in range(spw):
            idx = A.to_index(A.rint(ns))
            active = idx < (w + 1) * window
            at = np.clip(idx - base, 0, span - 1) + w * window
            cur = A.take(xp, at, lanes)
            hidx = A.to_index(A.rint(half_raw))
            hl = hidx - base
            h_ok = (hl >= 0) & (hl < span) & (hidx >= 0)
            hat = np.clip(hl, 0, span - 1) + w * window
            hval = A.where(mask(h_ok), A.take(xp, hat, lanes), zero)
            err = A.minimum(A.maximum(kp * (cur - prev_bit) * hval, -lim),
                            lim)
            ns_adj = ns - err
            # the decision on this symbol, from the two before it
            prev, pprev = m_cur, m_prev
            pv, ppv, cv = _np(prev), _np(pprev), _np(cur)
            resync = ((evenodd != clockmod) & (_sign(ppv) == _sign(pv))
                      & _np(abs(pprev) > thr) & _np(abs(prev) > thr))
            cm = np.where(resync, evenodd, clockmod)
            bit = np.where(_np(abs(prev) > abs(cur)), pv > 0, ~(cv > 0))
            act = mask(active)
            ns = A.where(act, ns_adj + step, ns)
            half_raw = A.where(act, ns_adj + half_step, half_raw)
            prev_bit = A.where(act, cur, prev_bit)
            m_cur = A.where(act, cur, m_cur)
            m_prev = A.where(act, prev, m_prev)
            m_pprev = A.where(act, pprev, m_pprev)
            emits.append(active & (evenodd == cm))
            clockmod = np.where(active, cm, clockmod)
            evenodd = np.where(active, (evenodd + 1) & 1, evenodd)
            bits.append(bit)
            times.append(tp[at, lanes])
    emit = np.stack(emits, 1)
    bits = np.stack(bits, 1).astype(np.uint8)
    times = np.stack(times, 1)
    return [(bits[b][emit[b]], times[b][emit[b]]) for b in range(B)]


class FrameFormat(NamedTuple):
    sync: np.ndarray           # uint8 0/1
    payload_bits: int          # bits after the sync's last bit
    first_bits: int            # bits that finish the first data byte
    n_data: int                # data bytes after the sync
    prefix: tuple
    inverted: bool             # also match the complemented sync word


def frame_format(cfg) -> FrameFormat:
    fr = cfg["framer"]
    first = 8 - fr["first_bit_index"]
    n_data = fr["frame_bytes"] - fr["data_start_byte"]
    return FrameFormat(
        sync=np.frombuffer(fr["sync_word"].encode(), np.uint8) - ord("0"),
        payload_bits=first + 8 * (n_data - 1), first_bits=first,
        n_data=n_data, prefix=tuple(fr["prefix_bytes"]),
        inverted=bool(fr["detect_inverted"]))


def frames_of_lane(bits, times, ff: FrameFormat, max_frames: int):
    """Sync-word framing of one lane's bit stream (ByteSync.c): a sync
    word (or, where the format allows, its complement) ending at bit p
    starts a frame unless p falls inside the previous frame's payload;
    frames whose payload runs past the stream are dropped, and at most
    `max_frames` are kept.  Returns [(time, inverted, payload bytes)]."""
    n = len(bits)
    m = len(ff.sync)
    if n < m:
        return []
    win = np.lib.stride_tricks.sliding_window_view(bits, m)
    normal = (win == ff.sync).all(1)
    inverse = (win == 1 - ff.sync).all(1) if ff.inverted \
        else np.zeros_like(normal)
    out, armed = [], 0
    for j in np.flatnonzero(normal | inverse):
        p = j + m - 1                          # the sync's last bit
        if p < armed:
            continue
        armed = p + ff.payload_bits
        if p + ff.payload_bits >= n:
            continue
        inv = bool(inverse[j])
        body = bits[p + 1:p + 1 + ff.payload_bits]
        if inv:
            body = 1 - body
        first = int(np.dot(body[:ff.first_bits],
                           1 << np.arange(ff.first_bits - 1, -1, -1)))
        rest = np.packbits(body[ff.first_bits:]).tolist()
        out.append((float(times[p]), inv,
                    bytes(list(ff.prefix) + [first] + rest)))
    return out[:max_frames]


def reference_frames(cfg, window: int, re16, im16, gain: float,
                     A: Arith = None):
    """The frames of one pass of (n,) int16 planes, with Gardner windows
    of `window` input samples and the AGC's starting gain `gain`:
    [(sync sample position, inverted, payload bytes)] in stream order."""
    A = A or Arith()
    plan = plan_of(cfg)
    ch = chain_of(cfg)
    ff = frame_format(cfg)
    n = len(re16)
    B = -(-n // plan.core)
    wr = block_windows(re16, plan, B)
    wi = block_windows(im16, plan, B)
    lo = np.arange(B, dtype=np.int64) * plan.core - plan.head
    zre = wr.astype(np.float32) * np.float32(1.0 / 32768.0)
    zim = wi.astype(np.float32) * np.float32(1.0 / 32768.0)
    spacing = ch.fs * ch.interp / (2.0 * ch.step_size)
    f0 = carrier_estimate(zre, zim, ch.fs, spacing)
    soft, locksig = pll(A, ch, zre.T.copy(), zim.T.copy(), f0)
    y = fir_interp(A, soft, ch.taps, ch.interp)
    y = agc(A, ch, y, gain)
    if not math.isnan(ch.squelch):
        if ch.interp != 1:
            raise ValueError("an after-AGC squelch needs interp 1")
        y = A.where(abs(locksig) < A.c(ch.squelch), A.c(0.0), y)
    # each block-local sample's position, the one whose time the chain
    # reports (the next sample where the FIR interpolates), -1 outside the
    # recording
    shift = 1 if ch.interp > 1 else 0
    g = lo[None, :] + np.arange(plan.total)[:, None]
    pos = np.where((g >= 0) & (g < n),
                   (np.arange(plan.total)[:, None] + shift).astype(np.float32),
                   np.float32(-1.0)) * np.ones((1, B), np.float32)
    t_out = np.repeat(pos, ch.interp, axis=0)
    lanes = gardner_manchester(A, ch, y, t_out, window * ch.interp)
    kept = []
    for b, (bits, times) in enumerate(lanes):
        cs = lo[b] + plan.head
        ce = min(cs + plan.core, n)
        for t, inv, data in frames_of_lane(bits, times, ff, plan.max_frames):
            p = float(np.float64(np.float32(t)) + lo[b])
            if cs <= p < ce:
                kept.append((int(p), inv, data))
    kept.sort(key=lambda f: f[0])
    return kept


"""The demodulation chain: parameters, explicit state and one chunk step.

Twin of ``project_desert_tortoise_tpu/chain.py``.  ``ChainParams`` has the
fields of the JAX package's record so the two compare field by field, and
``from_jax`` converts the JAX package's parameters, chain states and
stream states, the "weights" of this system, into the port's.

The exact chunked chain is the reference's ``while(!feof)`` driver loop
(``POESTIPdemod/main.c:373-492``): every C static local becomes a field of
`ChainState`, and one call to :func:`chunk_step` advances a chunk through

    PLL -> [squelch] -> FIR(1:N interp) -> AGC -> Gardner -> Manchester

on the card: the PLL, AGC and Gardner/Manchester kernels at one lane per
stream, the FIR a convolution.  With ``quirks=True`` it keeps the
reference's buffer-image semantics (see ops/clock.py); with
``quirks=False`` it is chunk-size invariant.  The state and the chunk run
in the mode's dtype: float32, or float64 for the ``argos`` mode (its
kernels' double instances, as JAX runs that mode under x64).  The clock
is the mode's ``clock_algorithm``: ``"gardner"`` (the reference's),
``"mm"`` (Mueller & Muller, in both quirks modes), or, with
``quirks=False`` only, ``"upsampling_gardner"`` and ``"upsampling_mm"``
(the MATLAB variants on a value-upsampled stream, ``ops/resample.py``),
each on its own kernel with the Manchester decision.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from project_desert_tortoise_tpu_torch.ops import agc as agc_ops
from project_desert_tortoise_tpu_torch.ops import clock as clock_ops
from project_desert_tortoise_tpu_torch.ops import fir as fir_ops
from project_desert_tortoise_tpu_torch.ops import manchester as man_ops
from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.ops import resample
from project_desert_tortoise_tpu_torch.ops.kernels import pll_kernel


class ChainParams(NamedTuple):
    """Static per-stream parameters (derived from ModeConfig + Fs)."""
    pll: pll_ops.PLLParams
    taps: tuple                 # FIR taps (stream-dtype values as python floats)
    interp: int
    agc_attack: float
    agc_decay: float
    squelch_threshold: Optional[float]
    squelch_position: Optional[str]   # "after_pll" | "after_agc"
    step_size: float
    fs_interp: float
    baud: float
    gardner_err_limit: float
    gardner_gain: float
    clock_algorithm: str
    upsample_level: int
    upsample_kind: str
    resync_threshold: float
    quirks: bool


class ChainState(NamedTuple):
    pll: pll_ops.PLLState
    fir_hist: torch.Tensor
    agc: agc_ops.AGCState
    gardner: clock_ops.GardnerState
    manchester: man_ops.ManchesterState
    x_img: torch.Tensor         # persistent interp-domain buffer image
    t_img: torch.Tensor


def make_params(mode_cfg, fs: float, quirks: bool = False) -> ChainParams:
    """Parameters of `mode_cfg` at sample rate `fs`.  ``quirks`` selects
    the exact chain's C buffer-image semantics; the fast path runs with
    the default, False.  (JAX's default is True, its exact chain's.)"""
    if mode_cfg.gardner.algorithm.startswith("upsampling") and quirks:
        raise ValueError(
            "the MATLAB upsampling clock-recovery variants are whole-"
            "stream formulations with no C chunk-quirk counterpart; use "
            "quirks=False (the chunk-invariant mode)")
    dtype = mode_cfg.np_dtype()
    interp = mode_cfg.fir.interp_factor(fs)
    order = mode_cfg.fir.order(fs)
    taps = fir_ops.make_lpfir(order, mode_cfg.fir.cutoff_hz, fs * interp,
                              interp, dtype)
    fs_i = fs * interp
    return ChainParams(
        pll=pll_ops.make_params(mode_cfg.pll, fs),
        taps=tuple(taps.tolist()),
        interp=interp,
        agc_attack=mode_cfg.scaled(mode_cfg.agc.attack_rate_rad_s, fs_i),
        agc_decay=mode_cfg.scaled(mode_cfg.agc.decay_rate_rad_s, fs_i),
        squelch_threshold=(mode_cfg.squelch.threshold
                           if mode_cfg.squelch else None),
        squelch_position=(mode_cfg.squelch.position
                          if mode_cfg.squelch else None),
        step_size=clock_ops.gardner_step_size(fs_i, mode_cfg.gardner.baud,
                                              dtype),
        fs_interp=fs_i,
        baud=mode_cfg.gardner.baud,
        gardner_err_limit=mode_cfg.gardner.error_limit,
        gardner_gain=mode_cfg.gardner.gain,
        clock_algorithm=mode_cfg.gardner.algorithm,
        upsample_level=mode_cfg.gardner.upsample_level,
        upsample_kind=mode_cfg.gardner.upsample_kind,
        resync_threshold=mode_cfg.manchester.resync_threshold,
        quirks=quirks,
    )


TAIL_MARGIN = 16  # carried interp-domain samples for chunk-invariant mode


def max_symbols(cap_interp: int, step_size: float) -> int:
    return int(cap_interp / step_size * 1.05) + 8


CLOCKS = ("gardner", "mm", "upsampling_gardner", "upsampling_mm")


def _check_clock(params: ChainParams) -> None:
    if params.clock_algorithm not in CLOCKS:
        raise ValueError(f"unknown clock algorithm "
                         f"{params.clock_algorithm!r}: expected one of "
                         f"{CLOCKS}")


def init_state(params: ChainParams, initial_gain: float, chunk_cap: int,
               batch_shape=(), *, device,
               dtype=torch.float32) -> ChainState:
    """The stream state at its start, `dtype` (the mode's: float32, or
    float64) on `device`; the upsampling clocks' pointers are split
    (integer part, fraction) pairs (JAX ``chain.py:119-121``)."""
    _check_clock(params)
    n_taps = len(params.taps)
    hist_len = -(-(n_taps - 1) // params.interp)
    cap_i = chunk_cap * params.interp
    zeros = lambda n: torch.zeros(tuple(batch_shape) + (n,), dtype=dtype,
                                  device=device)
    kw = dict(device=device, dtype=dtype)
    return ChainState(
        pll=pll_ops.init_state(params.pll, batch_shape, **kw),
        fir_hist=zeros(hist_len),
        agc=agc_ops.agc_init(initial_gain, batch_shape, **kw),
        gardner=(clock_ops.upsampling_init(batch_shape, **kw)
                 if params.clock_algorithm.startswith("upsampling")
                 else clock_ops.gardner_init(batch_shape, **kw)),
        manchester=man_ops.manchester_init(batch_shape, **kw),
        x_img=zeros(cap_i),
        t_img=zeros(cap_i),
    )


def _timing(params: ChainParams, g_state, m_state, x, t, n, msyms):
    """Timing recovery and the Manchester decision over buffer images
    (JAX ``_timing``, ``chain.py:128-147``, then ``manchester_scan``):
    Gardner, or Mueller & Muller, whose adaptive step rides in half_raw's
    slot (0 means not yet set: Fs/baud, as the C static starts,
    MMClockRecovery.c).  Returns what
    ``clock_ops.gardner_manchester_scan`` returns."""
    if params.clock_algorithm == "gardner":
        return clock_ops.gardner_manchester_scan(
            g_state, m_state, x, t, n, params.step_size,
            params.gardner_err_limit, params.gardner_gain,
            params.resync_threshold, msyms)
    # the python float takes the state's dtype: no host copy a chunk
    ss0 = torch.where(g_state.half_raw == 0, params.step_size,
                      g_state.half_raw)
    return clock_ops.mm_manchester_scan(
        g_state._replace(half_raw=ss0), m_state, x, t, n, params.fs_interp,
        params.baud, params.gardner_err_limit, params.gardner_gain,
        params.resync_threshold, msyms)


# input samples the upsampling clocks stop short of a chunk's end: the
# cubic kernel reads one future sample, and the carried margin (TAIL_MARGIN
# >= EDGE + the kernel's tail) presents them again with full context in the
# next chunk (JAX chain.py:227-233)
EDGE = 2


def _upsampling_timing(params: ChainParams, g_state, m_state, x_ext,
                       t_ext, n_i: int, msyms: int):
    """The upsampling clocks over one chunk-invariant chunk (JAX
    ``chain.py:213-262``): upsample the post-AGC stream and its time axis
    L x, shift the split pointers' integer parts by the margin, run the
    clock on the dense stream up to EDGE input samples short of the end,
    and shift them back into next-chunk-relative coordinates (integer
    parts: exact).  Returns what ``clock_ops.gardner_manchester_scan``
    returns."""
    m, L = TAIL_MARGIN, params.upsample_level
    x_up = resample.upsample(x_ext, L, params.upsample_kind)
    ts_i = float(np.float64(1.0) / params.fs_interp)
    t_up = resample.uniform_times(t_ext, L, ts_i / L)
    step_u = params.step_size * L
    n_lim = (m + n_i - EDGE) * L

    def shift(p2, delta):
        return torch.stack([p2[..., 0] + float(delta), p2[..., 1]], -1)
    if params.clock_algorithm == "upsampling_gardner":
        g_in = clock_ops.GardnerState(
            next_sample=shift(g_state.next_sample, m * L),
            half_raw=shift(g_state.half_raw, m * L),
            prev_bit=g_state.prev_bit)
        scan = clock_ops.upsampling_gardner_manchester_scan
    else:       # upsampling_mm: fixed step and a sign-law nudge
        g_in = g_state._replace(next_sample=shift(g_state.next_sample,
                                                  m * L))
        scan = clock_ops.upsampling_mm_manchester_scan
    g_out, *rest = scan(g_in, m_state, x_up, t_up, n_lim, step_u,
                        params.gardner_err_limit, params.gardner_gain,
                        params.resync_threshold, msyms)
    back = -(m + n_i) * L
    if params.clock_algorithm == "upsampling_gardner":
        g_out = g_out._replace(half_raw=shift(g_out.half_raw, back))
    return (g_out._replace(next_sample=shift(g_out.next_sample, back)),
            *rest)


class ChunkOutput(NamedTuple):
    bits: torch.Tensor          # (..., max_syms) uint8
    bit_times: torch.Tensor     # (..., max_syms)
    bit_mask: torch.Tensor      # (..., max_syms) bool
    sym_count: torch.Tensor
    locksig: torch.Tensor       # (..., n) lock-detector stream
    avg_phase: torch.Tensor     # per-chunk-end quality EWMA
    agc_stream: torch.Tensor    # (..., n*interp) post-AGC soft stream (-r tap)
    syms: torch.Tensor          # (..., max_syms) recovered soft symbols
    sym_valid: torch.Tensor     # (..., max_syms) validity mask


@functools.lru_cache(maxsize=16)
def _device_taps(taps: tuple, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """The FIR taps as a `dtype` tensor on `device`, copied there once: a
    copy a chunk would wait for the kernels queued before it."""
    return torch.tensor(taps, dtype=dtype, device=device)


def chunk_step(params: ChainParams, state: ChainState, iq_re, iq_im, t,
               t_next):
    """Advance one chunk (JAX ``chunk_step``, ``chain.py:163-303``).

    iq_re/iq_im/t/t_next: (..., n) in the state's dtype on its device, n <=
    the state's chunk capacity; t_next[i] = time of input sample i+1.  The
    leading axes are streams, one kernel lane each.  Returns (state,
    ChunkOutput)."""
    _check_clock(params)
    lead = tuple(iq_re.shape[:-1])
    n = iq_re.shape[-1]
    interp = params.interp
    cap_i = state.x_img.shape[-1]
    rows = lambda a: a.reshape(-1, a.shape[-1])
    lanes = lambda s: s.reshape(-1)
    back = lambda a: a.reshape(lead + tuple(a.shape[1:]))

    pll_state, soft, locksig = pll_kernel.pll_scan_kernel(
        params.pll, pll_ops.PLLState(*map(lanes, state.pll)),
        (rows(iq_re), rows(iq_im)))
    if params.squelch_position == "after_pll":
        soft = agc_ops.squelch(soft, locksig, params.squelch_threshold)

    fir_hist = rows(state.fir_hist)
    y = fir_ops.fir_interp(soft, _device_taps(params.taps, soft.dtype,
                                              soft.device),
                           interp, fir_hist)
    fir_hist = fir_ops.fir_history_update(soft, fir_hist, len(params.taps),
                                          interp)
    # LowPassFilterInterp emits t[i+1] per output group (LowPassFilter.c:68);
    # the plain LowPassFilter (interp == 1 modes) leaves the time axis alone
    t_out = (fir_ops.fir_out_times(rows(t_next), interp) if interp > 1
             else rows(t))

    agc_state, y = agc_ops.agc_scan(agc_ops.AGCState(lanes(state.agc.gain)),
                                    y, params.agc_attack, params.agc_decay)
    if params.squelch_position == "after_agc":
        if interp != 1:
            raise ValueError("after_agc squelch requires interp == 1")
        y = agc_ops.squelch(y, locksig, params.squelch_threshold)

    n_i = n * interp
    # a lane's pointers: (B,), or (B, 2) split pairs for the upsampling
    # clocks
    g_in = clock_ops.GardnerState(*(s.reshape((-1,) + tuple(
        s.shape[len(lead):])) for s in state.gardner))
    m_in = man_ops.ManchesterState(*map(lanes, state.manchester))
    msyms = max_symbols(cap_i, params.step_size)
    if params.quirks:
        # persistent buffer images (C heap semantics; see ops/clock.py): the
        # carried mid-bit pointer is NOT rolled over and reads the new
        # chunk's buffer image at its stale absolute index
        x_img = torch.cat([y, rows(state.x_img)[:, n_i:]], dim=-1)
        t_img = torch.cat([t_out, rows(state.t_img)[:, n_i:]], dim=-1)
        timing = _timing(params, g_in, m_in, x_img, t_img, n_i, msyms)
    else:
        # chunk-size-invariant streaming: carry a small tail of the previous
        # chunk so the pending mid-bit read resolves to the true stream
        # sample (fixing the reference's chunk-boundary bug,
        # changelog.txt:9,107).  Work in margin-offset coordinates.
        m = TAIL_MARGIN
        x_img = torch.cat([rows(state.x_img)[:, -m:], y], dim=-1)
        t_img = torch.cat([rows(state.t_img)[:, -m:], t_out], dim=-1)
        if params.clock_algorithm.startswith("upsampling"):
            timing = _upsampling_timing(params, g_in, m_in, x_img, t_img,
                                        n_i, msyms)
        else:
            gardner = params.clock_algorithm == "gardner"
            # for "mm" half_raw carries the adaptive step, not a pointer:
            # no margin offset there
            g_in = g_in._replace(
                next_sample=g_in.next_sample + m,
                half_raw=g_in.half_raw + m if gardner else g_in.half_raw)
            timing = _timing(params, g_in, m_in, x_img, t_img, m + n_i,
                             msyms)
            if gardner:
                # the scan subtracted (m + n_i) from next_sample; bring
                # half_raw into the same next-chunk-relative coordinates
                timing = (timing[0]._replace(
                    half_raw=timing[0].half_raw - (m + n_i)), *timing[1:])
    (gardner_state, man_state, syms, sym_times, sym_valid, sym_count, bits,
     bit_times, bit_mask) = timing

    if params.quirks and not lead:
        # Gardner/Manchester write their outputs over the head of the shared
        # time buffer in C; replicate so a shorter final chunk sees the same
        # stale tail the reference would.
        pos = torch.arange(cap_i, device=t_img.device)
        pad = lambda v: torch.nn.functional.pad(v, (0, cap_i - msyms))
        t_img = torch.where(pos < sym_count[:, None], pad(sym_times), t_img)
        bt_packed, _, nbits = man_ops.compress_stream(
            bit_times, bit_times, bit_mask, msyms)
        t_img = torch.where(pos < nbits[:, None], pad(bt_packed), t_img)

    new_state = ChainState(
        pll=pll_ops.PLLState(*map(back, pll_state)), fir_hist=back(fir_hist),
        agc=agc_ops.AGCState(back(agc_state.gain)),
        gardner=clock_ops.GardnerState(*map(back, gardner_state)),
        manchester=man_ops.ManchesterState(*map(back, man_state)),
        x_img=back(x_img), t_img=back(t_img))
    out = ChunkOutput(bits=back(bits), bit_times=back(bit_times),
                      bit_mask=back(bit_mask), sym_count=back(sym_count),
                      locksig=back(locksig),
                      avg_phase=back(pll_state.avg_phase),
                      agc_stream=back(y), syms=back(syms),
                      sym_valid=back(sym_valid))
    return new_state, out


def from_jax(obj, device="cpu"):
    """Convert a JAX ``ChainParams``, ``ChainState`` or stream state
    (``PLLState``, ``AGCState``, ``GardnerState``, ``ManchesterState``) into
    the port's.

    Parameters are python floats and a taps tuple on both sides and carry
    over field by field; a state's arrays become tensors on `device`:
    float64 where the JAX array is float64 (a state of the ``argos`` mode
    under x64), else float32, ``locked`` bool, the Manchester
    ``clockmod``/``evenodd`` int32; a chain state's stream states convert
    so, and its FIR history and buffer images too.  A clock state keeps its
    shapes: the upsampling clocks' (..., 2) split pointers, and the ``"mm"``
    clock's adaptive step in the half_raw slot.  Works by field names,
    so jax need not be importable here.
    """
    def arr(v, dtype=None):
        a = np.asarray(v)
        if dtype is None:
            dtype = (torch.float64 if a.dtype == np.float64
                     else torch.float32)
        return torch.tensor(a, device=device).to(dtype)
    if getattr(obj, "_fields", None) == ChainState._fields:
        return ChainState(
            pll=from_jax(obj.pll, device), fir_hist=arr(obj.fir_hist),
            agc=from_jax(obj.agc, device), gardner=from_jax(obj.gardner, device),
            manchester=from_jax(obj.manchester, device),
            x_img=arr(obj.x_img), t_img=arr(obj.t_img))
    if hasattr(obj, "taps"):
        fields = obj._asdict()
        fields["pll"] = pll_ops.PLLParams(**obj.pll._asdict())
        fields["taps"] = tuple(float(v) for v in obj.taps)
        return ChainParams(**fields)
    kinds = {pll_ops.PLLState: {"locked": torch.bool},
             agc_ops.AGCState: {},
             clock_ops.GardnerState: {},
             man_ops.ManchesterState: {"clockmod": torch.int32,
                                       "evenodd": torch.int32}}
    for cls, dtypes in kinds.items():
        if getattr(obj, "_fields", None) == cls._fields:
            return cls(**{k: arr(v, dtypes.get(k))
                          for k, v in obj._asdict().items()})
    raise TypeError(f"cannot convert {type(obj).__name__}")

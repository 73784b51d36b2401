"""The Gardner/Manchester kernel's order of evaluation, modelled on the CPU,
against the plain version ``gardner_manchester_ref`` bit for bit
(``torch.equal``) and against JAX's ``gardner_manchester_windowed``
exactly.

``csrc/scan_kernels.cu::gardner_manchester_kernel`` runs one lane a CTA:
for each window it copies the window's buffer (the window and its left
margin, zero before the stream) into shared memory; one thread runs the
slot recurrence over that copy, Manchester decision included, recording
each slot's clamped buffer index and its bit and emit flag, and stops at
the window's first inactive slot; the other threads fill the later slots
with that slot's bit and time (emit 0) and gather the times at the
recorded indices.  :func:`gardner_order` does the same, all lanes at once.

Cases, in the POES geometry (interp 3: windows of 12,288 interpolated
samples, 1,476 slots) and the ARGOS one (interp 1: 4,096 samples, 114
slots), each checked to reach what it names: every sample valid, the valid
length mid-window and inside the first window (slots filled as inactive);
a carried state with ``evenodd`` 1 and a fractional ``next_sample``;
``next_sample`` half a window behind the stream, so that a window's slots
run out and the next window's reads clamp at its buffer's start; a
negative ``half_raw`` (the mid-bit read is 0); ``next_sample`` and
``half_raw`` five million samples away on every other lane, beyond 2^22,
where the kernel rounds with a conversion and not with its add.

The card tests (``tests/test_torch_cuda.py``) hold the kernel to the plain
version and to its serial twin on these cases; JAX is imported inside the
comparison, as the card's host has none.
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu_torch import chain
from project_desert_tortoise_tpu_torch.ops import fastmath
from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    lane_const)
from project_desert_tortoise_tpu_torch.utils.config import ARGOS, POES_TIP

torch.set_num_threads(1)
# geometry: (mode, sample rate, windows)
GEOMETRIES = {"poes": (POES_TIP, 50000.0, 2), "argos": (ARGOS, 32000.0, 3)}
CASES = ["full", "mid_window", "first_window", "carried", "behind",
         "negative_half", "far"]


def _symbols(B, n, seed, step):
    """+-1 symbols `step` interpolated samples long, with noise and a
    timing offset per lane, float32 (B, n)."""
    rng = np.random.default_rng(seed)
    n_sym = int(n / step) + 2
    out = np.empty((B, n), np.float32)
    for b in range(B):
        sym = rng.choice([-1.0, 1.0], n_sym)
        pos = (np.arange(n) + rng.uniform(0, step)) / step
        out[b] = sym[pos.astype(int)] + 0.1 * rng.standard_normal(n)
    return out


def gardner_case(geometry: str, case: str, B: int = 8, seed: int = 0):
    """(fstate, istate, x, t, n, params, layout) of a case, as numpy
    arrays: x the symbol stream, t distinct times (lane b's sample i at
    1 + i + 1000 b), the window layout of the unfused branches (4,096
    input samples interpolated)."""
    mode, fs, n_win = GEOMETRIES[geometry]
    cp = chain.make_params(mode, fs)
    p = sk.GardnerParams(cp.step_size, cp.gardner_err_limit, cp.gardner_gain,
                         cp.resync_threshold)
    window = 4096 * cp.interp
    cap = n_win * window
    lay = sk.layout(cap, window, p.step_size, p.err_limit)
    x = _symbols(B, cap, seed, p.step_size)
    t = (np.arange(1, cap + 1)[None, :]
         + 1000 * np.arange(B)[:, None]).astype(np.float32)
    lanes = np.arange(B, dtype=np.float32)
    f = np.zeros((6, B), np.float32)     # ns, half_raw, prev_bit, cur, ...
    i = np.zeros((2, B), np.int32)       # clockmod, evenodd
    n = np.full(B, cap, np.int32)
    if case == "mid_window":
        n -= window // 2 + 7 * np.arange(B, dtype=np.int32)
    elif case == "first_window":
        n[:] = window // 3
    elif case == "carried":
        f[0] = 0.37 + 0.61 * lanes          # fractional next_sample
        f[1] = f[0] - np.float32(p.step_size / 2)
        f[2:] = np.float32(0.8) * (-1.0) ** lanes
        f[3] = np.float32(1.3)              # a strong cur and prev
        f[4] = np.float32(-1.2) * (-1.0) ** lanes
        i[0] = np.arange(B) % 2
        i[1] = 1
    elif case == "behind":
        f[0] = -(window // 2) - 3.5 * lanes
        f[1] = f[0] - np.float32(p.step_size / 2)
    elif case == "negative_half":
        f[1] = -5.5 - lanes
    elif case == "far":
        f[0, ::2] = 5e6 + 0.5
        f[1, ::2] = -5e6 - 0.5
    return f, i, x, t, n, p, lay


def _torch(case):
    f, i, x, t, n, p, lay = case
    return (tuple(torch.from_numpy(r.copy()) for r in f),
            tuple(torch.from_numpy(r.copy()) for r in i),
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(n),
            p, lay)


def gardner_order(fstate, istate, x, t, n, p: sk.GardnerParams,
                  lay: sk.Layout):
    """gardner_manchester_ref's results in the kernel's order, and the
    model's counts per lane: slots filled as inactive, on-time reads
    clamped to a later window's buffer start, mid-bit reads outside the
    buffer (0)."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    ns, half_raw, prev_bit, m_cur, m_prev, m_prevprev = fstate
    clockmod, evenodd = istate
    c = lambda v: lane_const(v, ns)
    kp, err_limit = c(p.kp), c(p.err_limit)
    neg_limit = c(-np.float32(p.err_limit))
    step = c(p.step_size)
    half_step = c(np.float32(p.step_size) / np.float32(2.0))
    thr, zero = c(p.resync_threshold), c(0.0)
    B = x.shape[0]
    span, spw = lay.window + lay.margin, lay.spw
    counts = {k: torch.zeros(B, dtype=i64)
              for k in ("filled", "clamped", "h_off")}
    bits, btimes, emits = [], [], []
    for w in range(lay.n_win):
        base = w * lay.window - lay.margin
        # the window buffer, copied: zero before the stream
        gi = base + torch.arange(span)
        xs = torch.where(gi >= 0, x[:, gi.clamp(min=0)], zero[:, None])
        w_end = torch.clamp(n, max=(w + 1) * lay.window).to(f32)
        # the chain thread: records up to and including the first
        # inactive slot of each lane
        ridx = torch.zeros((B, spw), dtype=i64)
        rbe = torch.zeros((B, spw), dtype=i32)
        last = torch.full((B,), spw - 1, dtype=i64)
        running = torch.ones(B, dtype=torch.bool)
        for s in range(spw):
            if not running.any():
                break
            idxf = torch.round(ns)
            active = idxf < w_end
            raw = idxf.to(i32) - base
            ii = torch.clamp(raw, 0, span - 1)
            cur = torch.gather(xs, 1, ii.to(i64)[:, None])[:, 0]
            hidxf = torch.round(half_raw)
            hl = hidxf.to(i32) - base
            h_ok = (hl >= 0) & (hl < span) & (hidxf >= 0)
            h = torch.gather(xs, 1, torch.clamp(hl, 0, span - 1).to(
                i64)[:, None])[:, 0]
            hval = torch.where(h_ok, h, zero)
            counts["clamped"] += (running & (raw < 0) & (w > 0)).to(i64)
            counts["h_off"] += (running & ~h_ok).to(i64)

            err = torch.clamp(kp * (cur - prev_bit) * hval, neg_limit,
                              err_limit)
            ns_adj = ns - err
            half_new = ns_adj + half_step
            ns_new = ns_adj + step

            prevprev, prev = m_prev, m_cur
            strong = (torch.abs(prevprev) > thr) & (torch.abs(prev) > thr)
            resync = (evenodd != clockmod) & (fastmath.sign(prevprev)
                                              == fastmath.sign(prev)) & strong
            cm = torch.where(resync, evenodd, clockmod)
            boundary = evenodd == cm
            use_prev = torch.abs(prev) > torch.abs(cur)
            bit = torch.where(use_prev, (prev > 0).to(i32),
                              1 - (cur > 0).to(i32))
            ridx[running, s] = ii.to(i64)[running]
            rbe[running, s] = (bit + 2 * (active & boundary).to(i32))[running]
            last = torch.where(running & ~active, s, last)
            upd = running & active
            ns = torch.where(upd, ns_new, ns)
            half_raw = torch.where(upd, half_new, half_raw)
            prev_bit = torch.where(upd, cur, prev_bit)
            clockmod = torch.where(upd, cm, clockmod)
            evenodd = torch.where(upd, (evenodd + 1) & 1, evenodd)
            m_cur = torch.where(upd, cur, m_cur)
            m_prev = torch.where(upd, prev, m_prev)
            m_prevprev = torch.where(upd, prevprev, m_prevprev)
            running = upd
        counts["filled"] += spw - 1 - last
        # the other threads: fill after `last`, gather t at the records
        slot = torch.arange(spw)[None, :]
        r = torch.minimum(slot, last[:, None])
        be = torch.gather(rbe, 1, r)
        gi = base + torch.gather(ridx, 1, r)
        bits.append((be & 1).to(torch.uint8))
        btimes.append(torch.where(gi >= 0, torch.gather(t, 1, gi.clamp(
            min=0)), zero[:, None]))
        emits.append((slot == r) & (be >> 1 == 1))
    ns = ns - n.to(f32)
    return ((ns, half_raw, prev_bit, m_cur, m_prev, m_prevprev),
            (clockmod, evenodd), torch.cat(bits, 1), torch.cat(btimes, 1),
            torch.cat(emits, 1)), counts


def _jax_windowed(case):
    """JAX's gardner_manchester_windowed on a case's numpy arrays."""
    import jax.numpy as jnp

    from project_desert_tortoise_tpu.ops import clock as JK
    from project_desert_tortoise_tpu.ops import manchester as JM
    f, i, x, t, n, p, lay = case
    g, m = JK.GardnerState(*map(jnp.asarray, f[:3])), JM.ManchesterState(
        clockmod=jnp.asarray(i[0]), evenodd=jnp.asarray(i[1]),
        cur=jnp.asarray(f[3]), prev=jnp.asarray(f[4]),
        prevprev=jnp.asarray(f[5]))
    g, m, bits, btimes, emit = JK.gardner_manchester_windowed(
        g, m, jnp.asarray(x), jnp.asarray(t), jnp.asarray(n), *p,
        window=lay.window)
    return ((*g, m.cur, m.prev, m.prevprev), (m.clockmod, m.evenodd), bits,
            btimes, emit)


def _flat(out):
    return [out[2], out[3], out[4], *out[0], *out[1]]


# what each case must reach, from the model's counts
REACHES = {"full": "filled", "mid_window": "filled",
           "first_window": "filled", "behind": "clamped",
           "negative_half": "h_off", "far": "filled"}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_gardner_order_matches_plain_and_jax(geometry, case):
    np_case = gardner_case(geometry, case)
    args = _torch(np_case)
    got, counts = gardner_order(*args)
    want = sk.gardner_manchester_ref(*args)
    for a, b in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(_flat(_jax_windowed(np_case)), _flat(want)):
        assert np.array_equal(np.asarray(a), b.numpy())
    B = args[2].shape[0]
    assert int(want[4].sum()) > 10 * B        # bits emitted on every case
    if case in REACHES:
        assert int(counts[REACHES[case]].min()) > 0, counts
    if case == "carried":
        assert (args[1][1] == 1).all()


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_gardner_wrapper_on_cpu_is_lane_major(geometry):
    """On CPU tensors the wrapper runs the plain version: contiguous
    (B, n_win * spw) outputs, as the kernel writes them."""
    args = _torch(gardner_case(geometry, "full", B=3))
    before = sk.gardner_manchester.launches
    out = sk.gardner_manchester(*args)
    lay = args[-1]
    assert sk.gardner_manchester.launches == before
    for a in out[2:]:
        assert a.shape == (3, lay.n_win * lay.spw) and a.is_contiguous()

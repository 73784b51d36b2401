"""The staged ``ablate_fused`` kernel's order of evaluation, modelled on the
CPU in chunks with their carries, against the plain version
``ablate_fused_ref`` bit for bit (``torch.equal``), for each of the eight
variants.

``csrc/ablate_fused.cu::ablate_fused_kernel`` gives a CTA 32 lanes, one a
thread of each stage warp, and walks their steps in chunks of 48
(:data:`K`).  At tick u the loader copies chunk u + 1's re and im rows
(three buffers) and chunk u - 3's time rows (two) into shared memory; B
computes chunk u's input terms of the PLL (two buffers); P runs the PLL
over chunk u - 1 into its soft rows, behind 25 rows carried from the
previous chunk (the FIR history; four buffers, as D and G read them too);
C the FIR of chunk u - 2 into its interpolated rows, behind 15 rows carried
from the previous chunk's AGC outputs (three buffers); D the AGC of chunk
u - 3 in place; G the rings, Gardner and Manchester of chunk u - 4: the
value ring a read of the interpolated rows at the age (clamped at 15), the
time ring a read of the chunk's time rows at the age's step or of 15
carried times, the mid-bit read where the ring holds it, the parity by the
kernel's short path; then the carries in front of the next chunk.  The
stages of a tick run at once, so :func:`staged_order` records every row
each stage reads and writes in a tick and fails if two stages touch one
row and one of them writes it; every buffer reads NaN from its recycling
until its writer fills it.  The lanes are independent, so the model runs
them all at once.

Cases, each checked to reach what it names: L not a multiple of K and a
window that does not divide K; Gardner's pointer far behind (the age
clamped at 15, the mid-bit index negative, then out of the ring behind),
the mid-bit index past the ring and parities outside [0, 2) (the long
path); a run shorter than the rings, whose final state holds carried
rows.  The card tests
(``tests/test_torch_ablate_cuda.py``) hold the kernel to the plain
version and its serial twin.
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu_torch.ops import fastmath
from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    AGC_MAX_GAIN, AGC_MIN_GAIN, AGC_REFERENCE, agc_step, lane_const,
    polyphase)
from project_desert_tortoise_tpu_torch.tools import ablate_fused as AF

torch.set_num_threads(1)

K = 48                     # kChunkSteps
SOFT_FRONT = 25            # kSoftFront: the FIR history
Y_FRONT = 15               # kYFront: the ring's older samples
SOFT_BUFS, Y_BUFS = 4, 3
RING = AF.RING
NAN = float("nan")


class Tick:
    """The rows each stage reads and writes in one tick."""

    def __init__(self):
        self.reads, self.writes = {}, {}

    def rd(self, stage, buf, rows):
        self.reads.setdefault(stage, set()).update((buf, r) for r in rows)

    def wr(self, stage, buf, rows):
        self.writes.setdefault(stage, set()).update((buf, r) for r in rows)

    def check(self, u):
        for a, w in self.writes.items():
            for b in set(self.reads) | set(self.writes):
                if a == b:
                    continue
                hit = w & (self.reads.get(b, set())
                           | self.writes.get(b, set()))
                assert not hit, f"tick {u}: {a} writes what {b} touches: " \
                                f"{sorted(hit)[:4]}"


def _gather(buf, rows):
    """buf[rows[b], b] for each lane, rows a (B,) int64 tensor."""
    return torch.gather(buf, 0, rows[None])[0]


def staged_order(name, re, im, tn, state, window: int):
    """ablate_fused's results in the staged kernel's order; returns them
    and the counts of what the run reached."""
    flags = AF.VARIANTS[name]
    pll_on, fir_on, ring_on, gm_on = (f in flags for f in
                                      ("pll", "fir", "ring", "gm"))
    store = "store" in flags
    cp = AF.chain_params()
    poly = polyphase(cp.taps, cp.interp)
    interp, hist_len = cp.interp, len(poly[0])
    assert (interp, hist_len, RING) == (3, SOFT_FRONT + 1, Y_FRONT + 1)
    L, B = re.shape
    AF.check_window(L, window)
    f32, i64 = torch.float32, torch.int64
    like = state[0]
    c = lambda v: lane_const(v, like)
    zero, eps, half = c(0.0), c(1e-7), c(0.5)
    k_pll = pll_ops.loop_consts(cp.pll, like)
    taps = [[c(v) for v in row] for row in poly]
    agc = (c(cp.agc_attack), c(cp.agc_decay), c(AGC_REFERENCE),
           c(AGC_MIN_GAIN), c(AGC_MAX_GAIN), zero)
    gg, lim, neg_lim = (c(cp.gardner_gain), c(cp.gardner_err_limit),
                        c(-np.float32(cp.gardner_err_limit)))
    step = c(cp.step_size)
    half_step = c(np.float32(cp.step_size) / np.float32(2.0))
    thr = c(cp.resync_threshold)

    n_chunks = -(-L // K)
    ln = lambda ch: min(K, L - ch * K)
    nan = lambda rows: torch.full((rows, B), NAN, dtype=f32)
    ri = [[nan(K), nan(K)] for _ in range(3)]
    pre = [[nan(K) for _ in range(3)] for _ in range(2)]
    tnb = [nan(K) for _ in range(2)]
    soft = [nan(SOFT_FRONT + K) for _ in range(SOFT_BUFS)]
    y = [nan(Y_FRONT + 3 * K) for _ in range(Y_BUFS)]
    tcar = nan(Y_FRONT)
    out = torch.zeros((3, L, B), dtype=f32)
    counts = dict(age_clamped=0, carried_time_reads=0, carried_value_reads=0,
                  mid_negative=0, mid_behind_ring=0, mid_ahead=0,
                  mid_in_ring=0, parity_long_path=0)

    rows = list(state.unbind(0))
    pll_s, rows = rows[:6], rows[6:]
    hist0, rows = rows[:hist_len], rows[hist_len:]
    gain, rows = rows[0], rows[1:]
    ring_v, ring_t, rows = rows[:RING], rows[RING:2 * RING], rows[2 * RING:]
    ns, half_raw, prev_bit, clockmod, evenodd, mcur, mprev, mprevprev = rows

    # before the first tick: P's history in front of chunk 0, G's rings in
    # front of it (or in registers, stubbed), the loader's chunk 0
    for m in range(SOFT_FRONT):
        soft[0][m] = hist0[SOFT_FRONT - 1 - m]
    if ring_on:
        for m in range(Y_FRONT):
            y[0][m] = ring_v[Y_FRONT - 1 - m]
            tcar[m] = ring_t[Y_FRONT - 1 - m]
    ri[0][0][:ln(0)] = re[:ln(0)]
    ri[0][1][:ln(0)] = im[:ln(0)]

    def load(tk, buf, plane, ch, key):
        buf[:] = NAN
        buf[:ln(ch)] = plane[ch * K:ch * K + ln(ch)]
        tk.wr("load", key, range(K))

    def stage_b(tk, ch):
        xr, xi = ri[ch % 3]
        for buf in pre[ch & 1]:
            buf[:] = NAN
        terms = pll_ops.input_terms(xr[:ln(ch)], xi[:ln(ch)])
        for buf, v in zip(pre[ch & 1], terms):
            buf[:ln(ch)] = v
        for j in range(2):
            tk.rd("B", ("ri", ch % 3, j), range(ln(ch)))
        for j in range(3):
            tk.wr("B", ("pre", ch & 1, j), range(K))

    def stage_p(tk, ch):
        nonlocal pll_s
        n = ln(ch)
        sb = soft[ch % SOFT_BUFS]
        key = ("soft", ch % SOFT_BUFS)
        if ch > 0:
            sb[:] = NAN
            prev = soft[(ch - 1) % SOFT_BUFS]
            sb[:SOFT_FRONT] = prev[K:K + SOFT_FRONT]
            tk.rd("P", ("soft", (ch - 1) % SOFT_BUFS),
                  range(K, K + SOFT_FRONT))
            tk.wr("P", key, range(SOFT_FRONT + K))
        for k in range(n):
            x_re = ri[ch % 3][0][k]
            tk.rd("P", ("ri", ch % 3, 0), [k])
            if pll_on:
                x_im = ri[ch % 3][1][k]
                tk.rd("P", ("ri", ch % 3, 1), [k])
                for j in range(3):
                    tk.rd("P", ("pre", ch & 1, j), [k])
                st = pll_ops.PLLState(*pll_s[:5], locked=pll_s[5] > half)
                new, (v, _) = pll_ops.step_with_terms(
                    k_pll, st, x_re, x_im, *(b[k] for b in pre[ch & 1]))
                pll_s = [*new[:5], new.locked.to(f32)]
            else:
                v = x_re
                pll_s = [p + eps for p in pll_s]
            sb[SOFT_FRONT + k] = v
            tk.wr("P", key, [SOFT_FRONT + k])

    def recycle_y(tk, ch):
        # chunk ch's interpolated buffer, from its FIR tick on: the rows in
        # front are G's to write a tick later (chunk 0's were set before)
        yb = y[ch % Y_BUFS]
        first = 0 if ch > 0 else Y_FRONT
        yb[first:] = NAN
        tk.wr("C", ("y", ch % Y_BUFS), range(first, Y_FRONT + 3 * K))

    def stage_c(tk, ch):
        sb, yb = soft[ch % SOFT_BUFS], y[ch % Y_BUFS]
        for k in range(ln(ch)):
            acc = [zero] * interp
            for m in range(hist_len):
                h = sb[SOFT_FRONT + k - m]
                tk.rd("C", ("soft", ch % SOFT_BUFS), [SOFT_FRONT + k - m])
                acc = [acc[p] + taps[p][m] * h for p in range(interp)]
            for p in range(interp):
                yb[Y_FRONT + 3 * k + p] = acc[p]

    def stage_d(tk, ch):
        nonlocal gain
        yb, key = y[ch % Y_BUFS], ("y", ch % Y_BUFS)
        for k in range(ln(ch)):
            r = [Y_FRONT + 3 * k + p for p in range(interp)]
            if fir_on:
                tk.rd("D", key, r)
                for q in r:
                    yb[q], gain = agc_step(yb[q].clone(), gain, *agc)
            else:
                v = soft[ch % SOFT_BUFS][SOFT_FRONT + k] * half
                tk.rd("D", ("soft", ch % SOFT_BUFS), [SOFT_FRONT + k])
                for q in r:
                    yb[q] = v
                gain = gain + eps
            tk.wr("D", key, r)

    wpos = 0

    def stage_g(tk, ch):
        nonlocal ns, half_raw, prev_bit, clockmod, evenodd, mcur, mprev
        nonlocal mprevprev, ring_v, ring_t, wpos
        yb, ykey = y[ch % Y_BUFS], ("y", ch % Y_BUFS)
        tb, tkey = tnb[ch & 1], ("tn", ch & 1)
        sb = soft[ch % SOFT_BUFS]
        i0 = ch * K
        for k in range(ln(ch)):
            if gm_on:
                j_hi = (i0 + k) * interp + interp - 1
                target = torch.round(ns)
                emit_sym = target <= j_hi
                tgt_i = torch.clamp(target.to(torch.int32), min=0)
                age = torch.clamp(j_hi - tgt_i, 0, RING - 1).to(i64)
                jl = 3 * k + 2 - age                      # >= -13
                cur = _gather(yb, Y_FRONT + jl)
                tk.rd("G", ykey, (Y_FRONT + jl).tolist())
                from_tn = jl >= 0
                t_chunk = _gather(tb, torch.where(from_tn, jl, 0) // 3)
                t_car = _gather(tcar, torch.where(from_tn, 0, Y_FRONT + jl))
                sym_t = torch.where(from_tn, t_chunk, t_car)
                tk.rd("G", tkey, (jl[from_tn] // 3).tolist())
                counts["age_clamped"] += int((age == RING - 1).sum())
                counts["carried_time_reads"] += int((~from_tn).sum())
                hidx = torch.round(half_raw).to(torch.int32)
                hage = j_hi - hidx
                h_in = (hidx >= 0) & (hage >= 0) & (hage < RING)
                counts["mid_negative"] += int((hidx < 0).sum())
                counts["mid_behind_ring"] += int(((hidx >= 0)
                                                  & (hage >= RING)).sum())
                counts["mid_ahead"] += int((hage < 0).sum())
                counts["mid_in_ring"] += int(h_in.sum())
                hrow = Y_FRONT + 3 * k + 2 - torch.clamp(hage, 0,
                                                         RING - 1).to(i64)
                hval = torch.where(h_in, _gather(yb, hrow), zero)
                tk.rd("G", ykey, hrow.tolist())
                counts["carried_value_reads"] += int(
                    ((jl < 0) | (h_in & (hrow < Y_FRONT))).sum())
                err = torch.clamp(gg * (cur - prev_bit) * hval, neg_lim, lim)
                ns_adj = ns - err
                ns = torch.where(emit_sym, ns_adj + step, ns)
                half_raw = torch.where(emit_sym, ns_adj + half_step,
                                       half_raw)
                prev_bit = torch.where(emit_sym, cur, prev_bit)
                prevprev, prev = mprev, mcur
                strong = (torch.abs(prevprev) > thr) & (torch.abs(prev) > thr)
                resync = ((evenodd != clockmod)
                          & (fastmath.sign(prevprev) == fastmath.sign(prev))
                          & strong)
                clockmod_n = torch.where(resync, evenodd, clockmod)
                boundary = evenodd == clockmod_n
                bit = torch.where(torch.abs(prev) > torch.abs(cur),
                                  (prev > 0).to(f32), 1.0 - (cur > 0).to(f32))
                emit_bit = emit_sym & boundary
                clockmod = torch.where(emit_sym, clockmod_n, clockmod)
                y1 = evenodd + 1.0                    # next_parity
                short = (y1 >= 0) & (y1 < 4)
                r = torch.fmod(y1, 2.0)
                r = torch.where((r != 0) & (r < 0), r + 2.0, r)
                parity = torch.where(short, torch.where(y1 >= 2, y1 - 2.0,
                                                        y1), r)
                counts["parity_long_path"] += int((emit_sym & ~short).sum())
                evenodd = torch.where(emit_sym, parity, evenodd)
                mcur = torch.where(emit_sym, cur, mcur)
                mprev = torch.where(emit_sym, prev, mprev)
                mprevprev = torch.where(emit_sym, prevprev, mprevprev)
            else:
                if not ring_on:
                    ring_v = [r + eps for r in ring_v]
                    ring_t = [r + eps for r in ring_t]
                bit = yb[Y_FRONT + 3 * k]
                sym_t = tb[k]
                emit_bit = sb[SOFT_FRONT + k] > 0
                tk.rd("G", ykey, [Y_FRONT + 3 * k])
                tk.rd("G", tkey, [k])
                tk.rd("G", ("soft", ch % SOFT_BUFS), [SOFT_FRONT + k])
                ns = ns + eps
            if store or wpos == 0:
                i = i0 + k
                out[0, i], out[1, i], out[2, i] = bit, sym_t, emit_bit.to(f32)
            wpos = (wpos + 1) % window
        if ring_on and ch + 1 < n_chunks:       # the carries in front
            nb = y[(ch + 1) % Y_BUFS]
            for m in range(Y_FRONT):
                nb[m] = yb[3 * K + m]
                tcar[m] = tb[(3 * K - Y_FRONT + m) // 3]
            tk.rd("G", ykey, range(3 * K, 3 * K + Y_FRONT))
            tk.rd("G", tkey, range(K - Y_FRONT // 3, K))
            tk.wr("G", ("y", (ch + 1) % Y_BUFS), range(Y_FRONT))

    for u in range(n_chunks + 4):
        tk = Tick()
        if u + 1 < n_chunks:
            load(tk, ri[(u + 1) % 3][0], re, u + 1, ("ri", (u + 1) % 3, 0))
            load(tk, ri[(u + 1) % 3][1], im, u + 1, ("ri", (u + 1) % 3, 1))
        if 0 <= u - 3 < n_chunks:
            load(tk, tnb[(u - 3) & 1], tn, u - 3, ("tn", (u - 3) & 1))
        if pll_on and u < n_chunks:
            stage_b(tk, u)
        if 0 <= u - 1 < n_chunks:
            stage_p(tk, u - 1)
        if 0 <= u - 2 < n_chunks:
            recycle_y(tk, u - 2)
            if fir_on:
                stage_c(tk, u - 2)
        if 0 <= u - 3 < n_chunks:
            stage_d(tk, u - 3)
        if 0 <= u - 4:
            stage_g(tk, u - 4)
        tk.check(u)

    last, n_last = n_chunks - 1, ln(n_chunks - 1)
    sl = soft[last % SOFT_BUFS]
    hist = [sl[SOFT_FRONT + n_last - 1 - m] for m in range(hist_len)]
    if ring_on:
        yl, tl = y[last % Y_BUFS], tnb[last & 1]
        ring_v, ring_t = [], []
        for a in range(RING):
            j = 3 * n_last - 1 - a
            ring_v.append(yl[Y_FRONT + j])
            ring_t.append(tl[j // 3] if j >= 0 else tcar[Y_FRONT + j])
    st_out = torch.stack(pll_s + hist + [gain] + ring_v + ring_t
                         + [ns, half_raw, prev_bit, clockmod, evenodd, mcur,
                            mprev, mprevprev])
    return (*out.unbind(0), st_out), counts


def ablate_case(case: str):
    """(re, im, tn, state, window) on the CPU: the tool's inputs (normal
    draws, the state at 0.1) at 4 lanes, then the case's changes."""
    steps, window = {"ragged": (200, 40), "pointers": (200, 50),
                     "short": (4, 2)}[case]
    (re, im, tn), state = AF.inputs(steps, 1, "cpu")
    re, im, tn, state = (t[..., :4].clone() for t in (re, im, tn, state))
    if case == "pointers":
        ns, half_raw = 6 + 26 + 1 + 2 * RING, 6 + 26 + 2 + 2 * RING
        state[ns, 1] = -1000.0        # far behind past chunk 0: ages
        #                               clamped at 15, carried times read
        state[half_raw, 1] = -7.0
        state[half_raw, 2] = 500.0    # the mid-bit index past the ring
        state[ns, 3] = -60.0
        state[ns + 4, 0] = -3.25      # evenodd: the parity's long path
        state[ns + 4, 2] = 6.5
    if case == "short":
        state[6:6 + 26] = torch.linspace(-1, 1, 26)[:, None]
        state[6 + 27:6 + 27 + 2 * RING] = torch.linspace(
            -2, 2, 2 * RING)[:, None]
    return re, im, tn, state, window


@pytest.mark.parametrize("case", ["ragged", "pointers", "short"])
@pytest.mark.parametrize("name", list(AF.VARIANTS))
def test_staged_order_matches_plain(name, case):
    args = ablate_case(case)
    got, counts = staged_order(name, *args)
    want = AF.ablate_fused_ref(name, *args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    L, window = args[0].shape[0], args[-1]
    if case == "ragged":
        assert L % K and K % window            # what the case names
    if "gm" in AF.VARIANTS[name] and case != "short":
        assert counts["mid_in_ring"] > 0 and counts["carried_value_reads"] > 0
        if case == "pointers":
            assert counts["age_clamped"] > 0
            assert counts["carried_time_reads"] > 0
            assert counts["mid_negative"] > 0 and counts["mid_ahead"] > 0
            assert counts["mid_behind_ring"] > 0
            assert counts["parity_long_path"] > 0
    if "store" not in AF.VARIANTS[name]:       # rows off the window are 0
        off = [i for i in range(L) if i % window]
        assert not got[0][off].any() and not got[2][off].any()


def test_staged_order_flags_a_conflict():
    """The tick check finds two stages on one row."""
    tk = Tick()
    tk.wr("P", ("soft", 0), [3])
    tk.rd("C", ("soft", 0), [3])
    with pytest.raises(AssertionError, match="P writes what C touches"):
        tk.check(0)


def test_serial_twin_refuses_cpu_tensors():
    re, im, tn, state, window = ablate_case("short")
    before = AF.ablate_fused_serial.launches
    with pytest.raises(ValueError, match="CUDA device only"):
        AF.ablate_fused_serial("full", re, im, tn, state, window)
    assert AF.ablate_fused_serial.launches == before


def test_design_masks_match_the_kernel_switches():
    """Each single-bit mask that tools/ablate_fused_design.py builds undoes
    one departure that the kernel source switches on PDT_ABLATE_PLAIN, and
    every other mask undoes the union of its bits'."""
    from project_desert_tortoise_tpu_torch.tools import ablate_fused_design
    masks = ablate_fused_design.MASKS
    src = ablate_fused_design.SOURCE.read_text()
    singles = {m: u for m, u in masks.items() if m and m & (m - 1) == 0}
    assert sorted(singles) == [1, 2, 4, 8] and masks[0] == []
    for m in singles:
        assert f"(PDT_ABLATE_PLAIN & {m})" in src
    for m, undoes in masks.items():
        assert undoes == [singles[k][0] for k in sorted(singles) if m & k]

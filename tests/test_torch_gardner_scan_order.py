"""The whole-image Gardner/Manchester kernel's order of evaluation, modelled
on the CPU, against the plain version ``gardner_manchester_scan_ref`` bit
for bit (``torch.equal``) and against JAX's ``gardner_scan`` followed by
``manchester_scan`` exactly.

``csrc/scan_kernels.cu::gardner_scan_kernel`` runs one lane a CTA.  The
lane's image is staged in shared memory as a ring of tiles: image tile k
in ring slot k % tiles, sample i at ``ring[sh + (i & mask)]`` (``sh`` the
row's floats past a 16-byte boundary), the whole image when it fits
(resident), else a power-of-two ring whose tiles are refilled once the
on-time and mid-bit reads have both passed them.  One thread runs the slot
chain: it reads both samples from the ring, then, where a read leaves the
staged tiles or both reads have passed the oldest one, stages the tiles it
needs (waiting on their copies), reads a mid-bit sample outside them from
device memory, and drops the tiles behind both reads.  It runs the timing
half of each slot only, records the slot's clamped on-time index and soft
symbol in segments of 256 slots, and stops at the first inactive slot.
One mover thread makes the Manchester decision on each segment's records
(through the stop slot); the other movers then store the segment, the
times gathered at the recorded indices, and fill every slot after the
stop from its record.  :func:`scan_order` does
the same, lane by lane: a tile's slot reads NaN from its issue until its
copy is waited, and the next tile's data once it is refilled, so a read
the protocol does not cover shows as a mismatch.

Cases (float32 modes, the exact chain's images): a ``poes_tip`` quirks
image whose carried mid-bit pointer is stale inside the image, past the
valid length, past the image or negative; a quirks=False image with the
``TAIL_MARGIN`` samples carried in front; an ``argos_realtime`` quirks
image; six lanes of an image larger than the forced ring, rows off
16-byte boundaries, ragged valid lengths and one lane stopping early; each
with the ring the kernel would choose (resident) and a forced small one
(recycled), checked to reach what it names.

The float64 ``argos`` mode's kernel (``gardner_manchester_scan_f64``) is
the same kernel instantiated in double: a 16-byte bulk copy holds 2
doubles, so a row lies 0 or 1 double past a boundary and its ragged ends
are 8-byte copies; the rounding add is 1.5 * 2^52 (below 2^30).  Its
cases are the same on the ``argos`` mode's images (2,400 doubles a
chunk) in float64, against the plain version bit for bit and against
JAX's scans under x64 exactly.

The card tests (``tests/test_torch_exact_cuda.py``) hold the kernel to the
plain version and its serial twin on such cases.
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu_torch import chain
from project_desert_tortoise_tpu_torch.ops import fastmath
from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
from project_desert_tortoise_tpu_torch.utils.config import (
    ARGOS, ARGOS_REALTIME, POES_TIP)

torch.set_num_threads(1)

# the kernel's constants (csrc/scan_kernels.cu)
TILE_LOG2, SEGMENT, MIN_RING = 10, 256, 64
MAX_SMEM, SMEM_PER_SM, CTA_RESERVE, MAX_CTAS = 232448, 233472, 1024, 8
RINT_ADD, RINT_ADD_BITS, RINT_ADD_LIMIT = 12582912.0, 0x4B400000, 4194304.0
RINT_ADD_D, RINT_ADD_LIMIT_D = 6755399441055744.0, 1073741824.0   # double


def smem_bytes(tiles: int, ring: int, size: int = 4) -> int:
    """gs_smem_bytes<T> for elements of `size` bytes: barriers, the ring
    (+16 bytes for the shift), records (index, symbol, bits)."""
    return (((tiles + 4) * 8 + 15) // 16 * 16 + (ring + 16 // size) * size
            + 2 * SEGMENT * (4 + size + 1))


def scan_geom(B: int, cap: int, ring_floats: int = 0, n_sm: int = 132,
              size: int = 4):
    """scan_geom<T>: (tile log2, tiles, resident, ring elements, CTAs an
    SM) for elements of `size` bytes."""
    ctas = min(max(-(-B // n_sm), 1), MAX_CTAS)
    budget = min(MAX_SMEM, SMEM_PER_SM // ctas - CTA_RESERVE) - 4
    nt = -(-cap // (1 << TILE_LOG2))
    vec = 16 // size
    whole = (cap + vec - 1) & ~(vec - 1)
    if (ring_floats <= 0 or ring_floats >= whole) and \
            smem_bytes(nt, whole, size) <= budget:
        return TILE_LOG2, nt, True, whole, ctas

    def tile_log2(ring):
        lt = 0
        while (4 << lt) < ring:
            lt += 1
        return min(lt, TILE_LOG2)
    ring, nxt = MIN_RING, 2 * MIN_RING
    while (ring_floats <= 0 or nxt <= ring_floats) and \
            smem_bytes(nxt >> tile_log2(nxt), nxt, size) <= budget:
        ring, nxt = nxt, 2 * nxt
    lt = tile_log2(ring)
    return lt, ring >> lt, False, ring, ctas


def rint_int(v: torch.Tensor, add: bool) -> int:
    """rint_int<ADD>: the add trick's bits, or the saturating conversion."""
    if add and v.dtype == torch.float64:     # the low word of the sum
        s = v + torch.tensor([RINT_ADD_D], dtype=torch.float64)
        low = int(s.view(torch.int64)) & 0xFFFFFFFF
        return low - (1 << 32) if low >= 1 << 31 else low
    if add:
        s = v + torch.tensor([RINT_ADD], dtype=torch.float32)
        return int(s.view(torch.int32)) - RINT_ADD_BITS
    r = float(torch.round(v))
    return 0 if r != r else int(min(max(r, -2.0 ** 31), 2.0 ** 31 - 1))


class Ring:
    """One lane's ring of tiles and its counts (the chain thread's)."""

    def __init__(self, row: torch.Tensor, geom, sh: int):
        self.lt, self.tiles, self.resident, ring_floats, _ = geom
        self.row, self.cap, self.sh = row, row.numel(), sh
        self.nt = (self.cap + (1 << self.lt) - 1) >> self.lt
        self.mask = (self.tiles << self.lt) - 1
        self.mem = torch.full((ring_floats + 16 // row.element_size(),),
                              float("nan"), dtype=row.dtype)
        self.lo = self.hi = 0
        self.counts = dict(refills=0, far_reads=0, waits_ahead=0)
        for k in range(min(self.tiles, self.nt)):
            self.issue(k)

    def slot(self, k):
        return k if self.resident else k & (self.tiles - 1)

    def pos(self, i):
        return self.sh + (i if self.resident else i & self.mask)

    def span(self, k):
        i0 = k << self.lt
        return i0, min(i0 + (1 << self.lt), self.cap)

    def issue(self, k):
        # the copy is in flight: its slot reads NaN until it is waited
        a = self.sh + (self.slot(k) << self.lt)
        i0, i1 = self.span(k)
        self.mem[a:a + i1 - i0] = float("nan")
        self.counts["refills"] += k >= self.tiles

    def land(self, k):
        a = self.sh + (self.slot(k) << self.lt)
        i0, i1 = self.span(k)
        self.mem[a:a + i1 - i0] = self.row[i0:i1]

    def release_to(self, m):
        while self.lo < m:
            if self.lo + self.tiles < self.nt:
                self.issue(self.lo + self.tiles)
            self.lo += 1

    def stage_to(self, k):
        while self.hi <= k:
            if not self.resident and self.hi - self.lo >= self.tiles:
                self.release_to(self.hi - self.tiles + 1)
            assert self.hi < min(self.lo + self.tiles, self.nt)   # issued
            self.land(self.hi)
            self.hi += 1

    def ld(self, i):
        return self.mem[self.pos(i)].reshape(1).clone()

    def read(self, i):
        k = i >> self.lt
        if self.lo <= k < self.hi:
            return self.ld(i)
        self.counts["far_reads"] += 1
        return self.row[i].reshape(1)

    def slow(self, ii, hc, in_img):
        kt, kh = ii >> self.lt, hc >> self.lt
        self.stage_to(kt)
        if in_img and self.hi <= kh < self.lo + self.tiles:
            self.counts["waits_ahead"] += kh > kt
            self.stage_to(kh)
        cur = self.read(ii)
        h = self.read(hc) if in_img else torch.zeros(1, dtype=self.row.dtype)
        if not self.resident:
            if not in_img or kh < self.lo or kh >= self.hi:
                kh = kt
            if min(kt, kh) > self.lo:
                self.release_to(min(kt, kh))
        return cur, h


def timing_half(st, cur, hval, active, k):
    """The chain thread's half of a slot (next_sample, half_raw,
    prev_bit), in the plain version's operations in the stream's dtype."""
    ns, half_raw, prev_bit = st
    err = torch.clamp(k.kp * (cur - prev_bit) * hval, k.neg_limit,
                      k.err_limit)
    ns_adj = ns - err
    keep = lambda new, old: torch.where(active, new, old)
    return (keep(ns_adj + k.step, ns), keep(ns_adj + k.half_step, half_raw),
            keep(cur, prev_bit))


def manchester_half(m, cur, active, k):
    """The mover's half (Manchester cur, prev, prevprev, clockmod,
    evenodd): returns (state, bit + 2 * emit as an int)."""
    m_cur, m_prev, m_prevprev, clockmod, evenodd = m
    prevprev, prev = m_prev, m_cur
    strong = (torch.abs(prevprev) > k.thr) & (torch.abs(prev) > k.thr)
    resync = (evenodd != clockmod) & (fastmath.sign(prevprev)
                                      == fastmath.sign(prev)) & strong
    cm = torch.where(resync, evenodd, clockmod)
    boundary = evenodd == cm
    use_prev = torch.abs(prev) > torch.abs(cur)
    bit = torch.where(use_prev, (prev > 0).to(torch.int32),
                      1 - (cur > 0).to(torch.int32))
    keep = lambda new, old: torch.where(active, new, old)
    m = (keep(cur, m_cur), keep(prev, m_prev), keep(prevprev, m_prevprev),
         keep(cm, clockmod), keep((evenodd + 1) & 1, evenodd))
    return m, int(bit) + 2 * int(active & boundary)


def scan_order(fstate, istate, x, t, n, p: sk.GardnerParams, max_syms: int,
               ring_floats: int = 0, row_offset: int = 0):
    """gardner_manchester_scan_ref's results in the kernel's order, lane by
    lane, and each lane's counts.  row_offset: elements the image's first
    row lies past a 16-byte boundary."""
    dt = x.dtype                     # the stream's: float32 or float64
    size = x.element_size()
    B, cap = x.shape
    geom = scan_geom(B, cap, ring_floats, size=size)
    npt = np.float64 if size == 8 else np.float32
    limit = RINT_ADD_LIMIT_D if size == 8 else RINT_ADD_LIMIT
    per_slot = (abs(npt(p.step_size)) + abs(npt(p.err_limit))
                + npt(1.0))
    outs = {k: [] for k in ("syms", "times", "valid", "bits", "emit")}
    finals, counts, stops = [], [], []
    for b in range(B):
        lane_state = tuple(s[b:b + 1].clone() for s in (*fstate, *istate))
        st, m = lane_state[:3], lane_state[3:]
        k = sk._slot_consts(p, st[0])
        nf = n[b:b + 1].to(dt)
        ring = Ring(x[b], geom, (row_offset + b * cap) & (16 // size - 1))
        lane = dict(filled=0, add_segments=0, segments=0)
        rows = {k: torch.empty(max_syms, dtype=d) for k, d in (
            ("syms", dt), ("times", dt), ("valid", torch.bool),
            ("bits", torch.uint8), ("emit", torch.bool))}
        stop = max_syms
        for s0 in range(0, max_syms, SEGMENT):
            s1 = min(s0 + SEGMENT, max_syms)
            reach = npt(s1 - s0) * per_slot + npt(2.0)
            add = bool(abs(npt(float(st[0]))) + reach < limit
                       and abs(npt(float(st[1]))) + reach < limit)
            lane["segments"] += 1
            lane["add_segments"] += add
            ridx, rsym = [], []
            lo_lim, hi_lim = ring.lo << ring.lt, ring.hi << ring.lt
            for s in range(s0, s1):
                ns, half_raw = st[0], st[1]
                ir, hr = rint_int(ns, add), rint_int(half_raw, add)
                # integer tests where the values are exact (ADD)
                active = (torch.tensor([ir < int(n[b])]) if add
                          else torch.round(ns) < nf)
                ii = min(max(ir, 0), cap - 1)
                hc = min(max(hr, 0), cap - 1)
                in_img = hr == hc and (add or bool(torch.round(half_raw)
                                                   >= 0))
                cur, h = ring.ld(ii), ring.ld(hc)      # issued before the test
                staged = max(ii, hc) < hi_lim and (
                    ring.resident or 0 <= min(ii, hc) - lo_lim
                    < (1 << ring.lt))
                if not staged:
                    cur, h = ring.slow(ii, hc, in_img)
                    lo_lim, hi_lim = ring.lo << ring.lt, ring.hi << ring.lt
                hval = h if in_img else k.zero
                st = timing_half(st, cur, hval, active, k)
                ridx.append(ii)
                rsym.append(cur)
                if not bool(active):
                    stop = s
                    break
            # the Manchester thread: the records through the stop slot
            rbe = []
            for r, cur in enumerate(rsym):
                m, be = manchester_half(m, cur, torch.tensor([s0 + r < stop]),
                                        k)
                rbe.append(be)
            # the movers: this segment, and all later slots after a stop
            end = max_syms if stop < s1 else s1
            for s in range(s0, end):
                r = min(s, stop) - s0
                rows["syms"][s] = rsym[r]
                rows["times"][s] = t[b, ridx[r]]
                rows["valid"][s] = s < stop
                rows["bits"][s] = rbe[r] & 1
                rows["emit"][s] = rbe[r] >> 1 == 1
            if stop < s1:
                lane["filled"] = max_syms - 1 - stop
                break
        for key in outs:
            outs[key].append(rows[key])
        finals.append((*st, *m))
        stops.append(stop)
        counts.append({**ring.counts, **lane})
    cat = lambda j: torch.cat([f[j] for f in finals])
    fs, is_ = sk._plain_result(tuple(cat(j) for j in range(8)), n)
    out = (fs, is_, *(torch.stack(outs[key]) for key in
                      ("syms", "times", "valid", "bits", "emit")),
           torch.tensor(stops, dtype=torch.int32))
    return out, counts, geom


FS = {"poes_tip": 50000.0, "argos_realtime": 32000.0, "argos": 32000.0}
MODES = {"poes_tip": POES_TIP, "argos_realtime": ARGOS_REALTIME,
         "argos": ARGOS}
STALE = ("inside", "past n", "past cap", "negative")


def _symbols(B, cap, seed, step, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = np.empty((B, cap), dtype)
    for b in range(B):
        sym = rng.choice([-1.0, 1.0], int(cap / step) + 2)
        pos = (np.arange(cap) + rng.uniform(0, step)) / step
        x[b] = sym[pos.astype(int)] + 0.1 * rng.standard_normal(cap)
    return x


def scan_case(case: str, seed: int = 0, dtype=np.float32):
    """(fstate, istate, x, t, n, params, max_syms) as numpy arrays, and
    the first row's offset from a 16-byte boundary in elements.  float64:
    the ``argos`` mode's images (case "argos" is then its quirks image)."""
    if dtype == np.float64:
        mode = "argos"
    else:
        mode = "argos_realtime" if case == "argos" else "poes_tip"
    cp = chain.make_params(MODES[mode], FS[mode], quirks=case != "no_quirks")
    p = sk.GardnerParams(cp.step_size, cp.gardner_err_limit, cp.gardner_gain,
                         cp.resync_threshold)
    rng = np.random.default_rng(seed)
    chunk = 2000 if mode == "poes_tip" else 2400
    cap_i = chunk * cp.interp
    if case == "lanes":               # larger than the forced ring
        B, cap = 6, 3 * cap_i + 1
    elif case == "no_quirks":         # the tail carried in front
        B, cap = 2, chain.TAIL_MARGIN + cap_i
    else:
        B, cap = len(STALE), cap_i
    x = _symbols(B, cap, seed, p.step_size, dtype)
    t = (np.arange(1, cap + 1, dtype=dtype) / dtype(FS[mode])
         + rng.uniform(0, 1, (B, 1)).astype(dtype))
    f = np.zeros((6, B), dtype)        # ns, half_raw, prev_bit, cur, ...
    i = np.zeros((2, B), np.int32)     # clockmod, evenodd
    f[0] = rng.uniform(-0.6, p.step_size, B)
    f[2:] = x[:, :4].T * dtype(0.7)
    i[0] = rng.integers(0, 2, B)
    i[1] = rng.integers(0, 2, B)
    n = np.full(B, cap, np.int32)
    short = cap - 1321
    if case == "lanes":
        n -= 97 * np.arange(B, dtype=np.int32)
        n[4] = cap // 3               # stops early: a long fill
        f[1] = f[0] - dtype(p.step_size / 2)
    elif case == "no_quirks":
        f[0] += chain.TAIL_MARGIN
        f[1] = f[0] - dtype(p.step_size / 2)
        n[1] = short
    else:
        n[1] = short
        f[1] = [cap - 9.6, short + 3.5, cap + 7.25, -4.5]
    max_syms = chain.max_symbols(cap, p.step_size)
    return (f, i, x, t, n, p, max_syms), (1 if case == "lanes" else 0)


def _torch(args):
    f, i, x, t, n, p, max_syms = args
    return (tuple(torch.from_numpy(r.copy()) for r in f),
            tuple(torch.from_numpy(r.copy()) for r in i),
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(n),
            p, max_syms)


def _jax(args):
    """JAX's gardner_scan then manchester_scan, in the wrapper's order."""
    import jax.numpy as jnp

    from project_desert_tortoise_tpu.ops import clock as JK
    from project_desert_tortoise_tpu.ops import manchester as JM
    f, i, x, t, n, p, max_syms = args
    g = JK.GardnerState(*map(jnp.asarray, f[:3]))
    m = JM.ManchesterState(clockmod=jnp.asarray(i[0]),
                           evenodd=jnp.asarray(i[1]), cur=jnp.asarray(f[3]),
                           prev=jnp.asarray(f[4]), prevprev=jnp.asarray(f[5]))
    g, syms, times, valid, count = JK.gardner_scan(
        g, jnp.asarray(x), jnp.asarray(t), jnp.asarray(n), p.step_size,
        p.err_limit, p.kp, max_syms)
    m, bits, btimes, emit = JM.manchester_scan(m, syms, times, valid,
                                               p.resync_threshold)
    assert np.array_equal(np.asarray(btimes), np.asarray(times))
    return ((*g, m.cur, m.prev, m.prevprev), (m.clockmod, m.evenodd), syms,
            times, valid, bits, emit, count)


def _flat(out):
    return [*out[0], *out[1], *out[2:]]


# the forced small ring: 512 floats, four tiles of 128
SMALL_RING = 512


@pytest.mark.parametrize("ring", ["resident", "small"])
@pytest.mark.parametrize("case", ["stale", "no_quirks", "argos", "lanes"])
def test_scan_order_matches_plain_and_jax(case, ring):
    _check_scan_case(case, ring, np.float32)


def _check_scan_case(case, ring, dtype):
    """scan_order on a case against the plain version and JAX, and the
    counts that show the case reaches what it names."""
    args, offset = scan_case(case, dtype=dtype)
    targs = _torch(args)
    ring_floats = SMALL_RING if ring == "small" else 0
    got, counts, geom = scan_order(*targs, ring_floats=ring_floats,
                                   row_offset=offset)
    want = sk.gardner_manchester_scan_ref(*targs)
    for a, b in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(_flat(_jax(args)), _flat(want)):
        assert np.array_equal(np.asarray(a), b.numpy())

    B, cap = targs[2].shape
    total = lambda key: sum(c[key] for c in counts)
    assert geom[2] == (ring == "resident")
    assert int(want[-3].sum()) > 10 * B          # bits emitted
    assert total("filled") > 0                   # slots after a stop
    assert total("add_segments") == total("segments")
    if ring == "resident":
        assert total("refills") == 0 and total("far_reads") == 0
    else:
        assert min(c["refills"] for c in counts) > 0
        assert cap > 4 * SMALL_RING
    if case == "stale":
        # the stale pointer: staged ahead where the image is resident,
        # else read from device memory inside the image, past n; past the
        # image and negative it reads nothing (0)
        c = counts
        if ring == "resident":
            assert c[0]["waits_ahead"] == 1 and c[1]["waits_ahead"] == 1
        else:
            assert c[0]["far_reads"] == 1 and c[1]["far_reads"] == 1
        assert c[2]["far_reads"] == 0 and c[3]["far_reads"] == 0
    if case == "lanes":
        assert int(got[-1][4]) < int(got[-1].max()) // 2   # the early stop


@pytest.fixture
def x64():
    """JAX's x64 switch on for one test, off again after it."""
    import jax
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("ring", ["resident", "small"])
@pytest.mark.parametrize("case", ["stale", "no_quirks", "argos", "lanes"])
def test_scan_order_f64_matches_plain_and_jax_x64(x64, case, ring):
    """The float64 kernel's order on the argos mode's images in double
    ("argos": its quirks image, the mid-bit pointer stale inside it)."""
    _check_scan_case(case, ring, np.float64)


def test_scan_order_f64_beyond_the_add_limit():
    """float64: next_sample and half_raw two thousand million samples out
    (past 2^30): the segments round with the conversion, which saturates
    past the int range; every slot inactive."""
    args, _ = scan_case("stale", dtype=np.float64)
    f = args[0]
    f[0, ::2] = 2e9 + 0.5
    f[1, ::2] = -3e9 - 0.5
    targs = _torch(args)
    got, counts, _ = scan_order(*targs, ring_floats=SMALL_RING)
    want = sk.gardner_manchester_scan_ref(*targs)
    for a, b in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert counts[0]["add_segments"] == 0 and int(got[-1][0]) == 0
    assert counts[1]["add_segments"] == counts[1]["segments"]


def test_scan_order_beyond_the_add_limit():
    """next_sample and half_raw five million samples out: the segments
    round with the conversion, not the add; every slot inactive."""
    args, _ = scan_case("stale")
    f = args[0]
    f[0, ::2] = 5e6 + 0.5
    f[1, ::2] = -5e6 - 0.5
    targs = _torch(args)
    got, counts, _ = scan_order(*targs, ring_floats=SMALL_RING)
    want = sk.gardner_manchester_scan_ref(*targs)
    for a, b in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert counts[0]["add_segments"] == 0 and int(got[-1][0]) == 0
    assert counts[1]["add_segments"] == counts[1]["segments"]


@pytest.mark.parametrize("B,cap,resident,ring,ctas", [
    (1, 30000, True, 30000, 1),       # poes_tip's quirks image
    (1, 7200, True, 7200, 1),         # poes_tip_realtime's
    (1, 2400, True, 2400, 1),         # argos_realtime's
    (1, 30016, True, 30016, 1),       # poes_tip without quirks
    (352, 380928, False, 16384, 3),   # the window=0 layout of the POES pass
    (1, 60000, False, 32768, 1),      # a long chunk (-c 20000)
])
def test_scan_geometry(B, cap, resident, ring, ctas):
    """The ring the kernel chooses (scan_geom on 132 SMs): each float32
    mode's chunk resident, the fallback's 352 lanes three CTAs an SM."""
    lt, tiles, res, ring_floats, n_ctas = scan_geom(B, cap)
    assert (res, ring_floats, n_ctas) == (resident, ring, ctas)
    assert n_ctas * (smem_bytes(tiles, ring_floats) + CTA_RESERVE + 4) \
        <= SMEM_PER_SM
    if not res:
        assert tiles << lt == ring_floats and tiles >= 4


@pytest.mark.parametrize("B,cap,ring_floats,resident,ring", [
    (1, 2400, 0, True, 2400),         # the argos mode's chunk
    (1, 1680, 0, True, 1680),         # its final chunk on the pass
    (1, 2416, 0, True, 2416),         # without quirks (16 carried)
    (1, 2400, SMALL_RING, False, 512),
    (1, 60000, 0, False, 16384),      # a long chunk (-c 60000)
])
def test_scan_geometry_f64(B, cap, ring_floats, resident, ring):
    """The ring the float64 kernel chooses: doubles, 16 bytes two of them;
    the argos chunk resident in 25 KB."""
    lt, tiles, res, n_ring, ctas = scan_geom(B, cap, ring_floats, size=8)
    assert (res, n_ring) == (resident, ring)
    assert ctas * (smem_bytes(tiles, n_ring, 8) + CTA_RESERVE + 4) \
        <= SMEM_PER_SM
    if cap == 2400 and res:
        assert smem_bytes(tiles, n_ring, 8) < 26 * 1024
    if not res:
        assert tiles << lt == n_ring and tiles >= 4


def test_scan_wrapper_on_cpu_takes_the_ring_keyword():
    """On CPU tensors the wrapper runs the plain version, ring_floats or
    not; the serial twin refuses them."""
    args, _ = scan_case("stale")
    targs = _torch(args)
    before = sk.gardner_manchester_scan.launches
    a = sk.gardner_manchester_scan(*targs, ring_floats=SMALL_RING)
    b = sk.gardner_manchester_scan(*targs)
    assert sk.gardner_manchester_scan.launches == before
    for u, v in zip(_flat(a), _flat(b)):
        assert torch.equal(u, v)
    with pytest.raises(ValueError):
        sk.gardner_manchester_scan_serial(*targs)

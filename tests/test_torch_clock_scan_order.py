"""The whole-image kernel's order of evaluation under the exact chain's
``"mm"``, ``"upsampling_gardner"`` and ``"upsampling_mm"`` clocks,
modelled on the CPU, against the plain versions ``mm_manchester_scan_ref``,
``upsampling_gardner_manchester_scan_ref`` and
``upsampling_mm_manchester_scan_ref`` bit for bit (``torch.equal``) and
against JAX's ``mm_scan``, ``upsampling_gardner_scan`` or
``upsampling_mm_scan`` followed by ``manchester_scan`` exactly (under x64
for float64).

``csrc/scan_kernels.cu::scan_kernel`` is ``gardner_manchester_scan``'s
kernel made a template over a clock policy (``MmScan``,
``UpGardnerScan``, ``UpMmScan``): one lane a CTA, the lane's image staged in a ring of
shared-memory tiles (``tests/test_torch_gardner_scan_order.py`` models the
ring, whose ``Ring`` this file uses: a tile's slot reads NaN from its issue
until its copy is waited, a read outside the staged tiles reads device
memory).  One thread runs the clock's timing half of each slot, reading
through the ring: M&M one read a slot at rint(next_sample), rounded by the
add where next_sample stays below its limit over the segment; upsampling
Gardner the on-time read at int + (frac >= 0.5) and the mid-bit read, 0
outside [0, cap); upsampling M&M the on-time read alone.  It records each slot's clamped on-time index and soft
symbol in segments of 256 slots and stops at the first inactive slot (an
inactive slot freezes the state, so the active slots are a prefix and the
count is the stop).  One mover thread makes the Manchester decision on the
records; the movers store them, the times gathered at the recorded
indices, and fill every slot after the stop.  :func:`clock_order` does the
same, lane by lane.

Cases, each in float32 and float64, with the ring the kernel would choose
(resident) and a forced small one (recycled), each checked to reach what
it names: a fresh state with a ragged final chunk; a carried state (for
upsampling Gardner: the chain's carried mid-bit pointer, one behind the
staged span, one negative, one past the image); five lanes of an image
larger than the forced ring, rows off 16-byte boundaries, ragged valid
lengths, one lane stopping early.  The geometry the kernel chooses at the
exact chain's POES images: float32 resident, float64 recycled.

The card tests (``tests/test_torch_clocks_cuda.py``) hold the kernels to
the plain versions and their serial twins on such cases.
"""

import types

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu_torch import chain
from project_desert_tortoise_tpu_torch.ops import fastmath
from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    lane_const)
from test_torch_gardner_scan_order import (  # noqa: F401 (x64: a fixture)
    CTA_RESERVE, RINT_ADD_LIMIT, RINT_ADD_LIMIT_D, SEGMENT, SMEM_PER_SM,
    Ring, manchester_half, rint_int, scan_geom, smem_bytes, x64)

torch.set_num_threads(1)

FS = 50000.0
BAUD, THR = 8320.0, 0.4
# "mm" at the poes_tip interpolation (x3): the JAX tests' error limit and
# gain (tests/test_clock.py:118-121)
MM = dict(fs=3 * FS, baud=BAUD, step_range=3.0, kp=0.15)
MM_STEP = float(np.float32(3 * FS / BAUD))
# the upsampling clocks at interp 1, 4 x cubic (tests/test_upsampling_clock.
# py:18-27): the step in upsampled samples
UP_L = 4
UP_STEP = float(np.float32(FS / BAUD)) * UP_L
UP = dict(err_limit=2.0, kp=1.0)
M = chain.TAIL_MARGIN
SMALL_RING = 512                  # four tiles of 128: recycled


def _consts(clock, p, like):
    c = lambda v: lane_const(v, like)
    if clock == "mm":
        return dict(kp=c(p.kp), smin=c(p.step_min), smax=c(p.step_max),
                    thr=c(p.resync_threshold))
    return dict(kp=c(p.kp), lim=c(p.err_limit), si=c(p.step_int),
                sf=c(p.step_frac), hsi=c(p.half_int), hsf=c(p.half_frac),
                zero=c(0.0), half=c(0.5), thr=c(p.resync_threshold))


def mm_advance(st, cur, active, k):
    """MmClock::advance, in the plain version's operations."""
    ns, ss, prev = st
    err = fastmath.sign(prev) * cur - fastmath.sign(cur) * prev
    ss_new = torch.clamp(ss + k["kp"] * err, k["smin"], k["smax"])
    keep = lambda new, old: torch.where(active, new, old)
    return keep(ns + ss_new, ns), keep(ss_new, ss), keep(cur, prev)


def _split(i, f):
    fl = torch.floor(f)
    return i + fl, f - fl


def um_advance(st, cur, active, k):
    """UpMmClock::advance: the clipped sign-law error added to the split
    pointer, then the fixed step."""
    ni, nf, prev = st
    err = torch.clamp(k["kp"] * (fastmath.sign(prev) * cur
                                 - fastmath.sign(cur) * prev),
                      -k["lim"], k["lim"])
    ai, af = _split(ni, nf + err)
    nni, nnf = _split(ai + k["si"], af + k["sf"])
    keep = lambda new, old: torch.where(active, new, old)
    return keep(nni, ni), keep(nnf, nf), keep(cur, prev)


def up_advance(st, cur, hval, active, k):
    """UpGardnerClock::advance."""
    ni, nf, hi, hf, prev = st
    err = torch.clamp(k["kp"] * (cur - prev) * hval, -k["lim"], k["lim"])
    ai, af = _split(ni, nf - err)
    nhi, nhf = _split(ai + k["hsi"], af + k["hsf"])
    nni, nnf = _split(ai + k["si"], af + k["sf"])
    keep = lambda new, old: torch.where(active, new, old)
    return (keep(nni, ni), keep(nnf, nf), keep(nhi, hi), keep(nhf, hf),
            keep(cur, prev))


def clock_order(clock, fstate, istate, x, t, n, p, max_syms: int,
                ring_floats: int = 0, row_offset: int = 0):
    """The plain version's results in the kernel's order, lane by lane, and
    each lane's counts.  row_offset: elements the image's first row lies
    past a 16-byte boundary."""
    dt = x.dtype                     # the stream's: float32 or float64
    size = x.element_size()
    B, cap = x.shape
    geom = scan_geom(B, cap, ring_floats, size=size)
    npt = np.float64 if size == 8 else np.float32
    limit = RINT_ADD_LIMIT_D if size == 8 else RINT_ADD_LIMIT
    n_rows = 5 if clock == "upsampling_gardner" else 3
    if clock == "mm":
        per_slot = max(abs(npt(p.step_min)), abs(npt(p.step_max))) + npt(1)
    outs = {k: [] for k in ("syms", "times", "valid", "bits", "emit")}
    finals, counts, stops = [], [], []
    for b in range(B):
        lane_state = tuple(s[b:b + 1].clone() for s in (*fstate, *istate))
        st, m = lane_state[:n_rows], lane_state[n_rows:]
        k = _consts(clock, p, st[0])
        thr = types.SimpleNamespace(thr=k["thr"])
        nf = n[b:b + 1].to(dt)
        capf = torch.tensor([float(cap)], dtype=dt)
        ring = Ring(x[b], geom, (row_offset + b * cap) & (16 // size - 1))
        tile = 1 << ring.lt
        lane = dict(filled=0, add_segments=0, segments=0)
        rows = {key: torch.empty(max_syms, dtype=d) for key, d in (
            ("syms", dt), ("times", dt), ("valid", torch.bool),
            ("bits", torch.uint8), ("emit", torch.bool))}
        stop = max_syms
        for s0 in range(0, max_syms, SEGMENT):
            s1 = min(s0 + SEGMENT, max_syms)
            add = False
            if clock == "mm":
                reach = npt(s1 - s0) * per_slot + npt(2.0)
                add = bool(abs(npt(float(st[0]))) + reach < limit)
            lane["segments"] += 1
            lane["add_segments"] += add
            ridx, rsym = [], []
            lo_lim, hi_lim = ring.lo << ring.lt, ring.hi << ring.lt
            for s in range(s0, s1):
                if clock == "mm":
                    ir = rint_int(st[0], add)
                    active = (torch.tensor([ir < int(n[b])]) if add
                              else torch.round(st[0]) < nf)
                    ii = hc = min(max(ir, 0), cap - 1)
                    in_img = False
                elif clock == "upsampling_mm":
                    idx = st[0] + (st[1] >= k["half"]).to(dt)
                    active = idx < nf
                    ii = hc = min(max(int(idx.to(torch.int32)), 0), cap - 1)
                    in_img = False
                else:
                    idx = st[0] + (st[1] >= k["half"]).to(dt)
                    active = idx < nf
                    ii = min(max(int(idx.to(torch.int32)), 0), cap - 1)
                    hidx = st[2] + (st[3] >= k["half"]).to(dt)
                    in_img = bool((hidx >= 0) & (hidx < capf))
                    hc = min(max(int(hidx.to(torch.int32)), 0), cap - 1)
                cur, h = ring.ld(ii), ring.ld(hc)   # issued before the test
                staged = max(ii, hc) < hi_lim and (
                    ring.resident or 0 <= min(ii, hc) - lo_lim < tile)
                if not staged:
                    cur, h = ring.slow(ii, hc, in_img)
                    lo_lim, hi_lim = ring.lo << ring.lt, ring.hi << ring.lt
                if clock == "mm":
                    st = mm_advance(st, cur, active, k)
                elif clock == "upsampling_mm":
                    st = um_advance(st, cur, active, k)
                else:
                    st = up_advance(st, cur, h if in_img else k["zero"],
                                    active, k)
                ridx.append(ii)
                rsym.append(cur)
                if not bool(active):
                    stop = s
                    break
            # the Manchester thread: the records through the stop slot
            rbe = []
            for r, cur in enumerate(rsym):
                m, be = manchester_half(m, cur, torch.tensor([s0 + r < stop]),
                                        thr)
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
        if clock == "mm":           # next_sample rolled over by n
            st = (st[0] - nf, *st[1:])
        finals.append((*st, *m))
        stops.append(stop)
        counts.append({**ring.counts, **lane})
    cat = lambda j: torch.cat([f[j] for f in finals])
    n_f = n_rows + 3
    out = (tuple(cat(j) for j in range(n_f)),
           tuple(cat(j) for j in range(n_f, n_f + 2)),
           *(torch.stack(outs[key]) for key in
             ("syms", "times", "valid", "bits", "emit")),
           torch.tensor(stops, dtype=torch.int32))
    return out, counts, geom


def _symbols(B, cap, step, rng, dtype):
    x = np.empty((B, cap), dtype)
    for b in range(B):
        sym = rng.choice([-1.0, 1.0], int(cap / step) + 2)
        pos = (np.arange(cap) + rng.uniform(0, step)) / step
        x[b] = sym[pos.astype(int)] + 0.1 * rng.standard_normal(cap)
    return x


def clock_case(clock: str, case: str, dtype, seed: int = 0):
    """(fstate rows, istate rows, x, t, n, params, max_syms) as numpy
    arrays, and the first row's offset from a 16-byte boundary in
    elements."""
    rng = np.random.default_rng(seed)
    B = {"fresh": 2, "carried": 4, "lanes": 5}[case]
    if clock == "mm":
        chunk, step, up = 1000, MM_STEP, 3
    else:
        chunk, step, up = 1000, UP_STEP, UP_L
    cap = (M + chunk) * up if clock != "mm" else M + chunk * up
    if case == "lanes":               # larger than the forced ring
        cap = 2 * cap + 1
    x = _symbols(B, cap, step, rng, dtype)
    t = (np.arange(1, cap + 1, dtype=dtype) / dtype(FS)
         + rng.uniform(0, 1, (B, 1)).astype(dtype))
    n = np.full(B, cap, np.int32)
    n[1] -= 1321 if clock == "mm" else 4 * 331    # a ragged final chunk
    i = np.zeros((2, B), np.int32)                # clockmod, evenodd
    man = np.zeros((3, B), dtype)                 # cur, prev, prevprev
    if case != "fresh":
        i[0] = rng.integers(0, 2, B)
        i[1] = rng.integers(0, 2, B)
        man[:] = x[:, :3].T * dtype(0.7)
    if clock == "mm":
        p = sk.mm_params(MM["fs"], MM["baud"], MM["step_range"], MM["kp"],
                         THR)
        ns = np.full(B, M, dtype)
        ss = np.full(B, step, dtype)
        prev = np.zeros(B, dtype)
        if case != "fresh":
            ns += rng.uniform(-0.6, step, B).astype(dtype)
            ss *= rng.uniform(0.9996, 1.0004, B).astype(dtype)
            prev = x[:, 5] * dtype(0.8)
        f = np.stack([ns, ss, prev])
    else:
        p = sk.upsampling_params(step, UP["err_limit"], UP["kp"], THR)
        ni = np.full(B, M * up, dtype)
        nf = np.zeros(B, dtype)
        hi, hf = ni.copy(), nf.copy()
        prev = np.zeros(B, dtype)
        if case == "carried":
            # the chain's carried pointers; the mid-bit pointer behind the
            # staged span (the on-time one six small-ring tiles on), one
            # negative, one past the image
            ni[:] = [M * up - 3, 700, M * up + 5, M * up - 2]
            nf[:] = [0.37, 0.2, 0.5, 0.75]
            hi[:] = [M * up - 40, 20, -7, cap + 3]
            hf[:] = [0.86, 0.6, 0.86, 0.25]
            prev = x[:, 5] * dtype(-0.6)
        elif case == "lanes":
            ni += rng.integers(-3, 4, B).astype(dtype)
            nf[:] = rng.uniform(0, 1, B).astype(dtype)
            hi = ni - dtype(12)
            hf[:] = rng.uniform(0, 1, B).astype(dtype)
            prev = x[:, 5] * dtype(0.5)
        f = np.stack([ni, nf, hi, hf, prev])
        if clock == "upsampling_mm":          # no mid-bit pointer
            f = np.stack([ni, nf, prev])
    if case == "lanes":
        n -= 97 * np.arange(B, dtype=np.int32)
        n[3] = cap // 3               # stops early: a long fill
    if clock == "mm":
        max_syms = chain.max_symbols(cap, step)
    else:
        max_syms = chain.max_symbols(cap // up, step / up)
    return ((np.concatenate([f, man]).astype(dtype), i, x, t, n, p,
             max_syms), (1 if case == "lanes" else 0))


def _torch(args):
    f, i, x, t, n, p, max_syms = args
    return (tuple(torch.from_numpy(r.copy()) for r in f),
            tuple(torch.from_numpy(r.copy()) for r in i),
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(n),
            p, max_syms)


def _jax(clock, args):
    """JAX's clock scan then manchester_scan, in the wrapper's order."""
    import jax.numpy as jnp

    from project_desert_tortoise_tpu.ops import clock as JK
    from project_desert_tortoise_tpu.ops import manchester as JM
    f, i, x, t, n, p, max_syms = args
    r = f.shape[0] - 3
    m = JM.ManchesterState(clockmod=jnp.asarray(i[0]),
                           evenodd=jnp.asarray(i[1]), cur=jnp.asarray(f[r]),
                           prev=jnp.asarray(f[r + 1]),
                           prevprev=jnp.asarray(f[r + 2]))
    xj, tj, nj = jnp.asarray(x), jnp.asarray(t), jnp.asarray(n)
    if clock == "mm":
        st, (syms, times, valid, count) = JK.mm_scan(
            (jnp.asarray(f[0]), jnp.asarray(f[2]), jnp.asarray(f[1])), xj,
            tj, nj, MM["fs"], MM["baud"], MM["step_range"], MM["kp"],
            max_syms)
        rows = (st[0], st[2], st[1])
    elif clock == "upsampling_mm":
        st, syms, times, valid, count = JK.upsampling_mm_scan(
            (jnp.asarray(f[0:2].T), jnp.asarray(f[2])), xj, tj, nj, UP_STEP,
            UP["err_limit"], UP["kp"], max_syms)
        rows = (st[0][:, 0], st[0][:, 1], st[1])
    else:
        g = JK.GardnerState(next_sample=jnp.asarray(f[0:2].T),
                            half_raw=jnp.asarray(f[2:4].T),
                            prev_bit=jnp.asarray(f[4]))
        g, syms, times, valid, count = JK.upsampling_gardner_scan(
            g, xj, tj, nj, UP_STEP, UP["err_limit"],
            UP["kp"], max_syms)
        rows = (g.next_sample[:, 0], g.next_sample[:, 1], g.half_raw[:, 0],
                g.half_raw[:, 1], g.prev_bit)
    m, bits, btimes, emit = JM.manchester_scan(m, syms, times, valid, THR)
    assert np.array_equal(np.asarray(btimes), np.asarray(times))
    return ((*rows, m.cur, m.prev, m.prevprev), (m.clockmod, m.evenodd),
            syms, times, valid, bits, emit, count)


def _flat(out):
    return [*out[0], *out[1], *out[2:]]


REFS = {"mm": sk.mm_manchester_scan_ref,
        "upsampling_gardner": sk.upsampling_gardner_manchester_scan_ref,
        "upsampling_mm": sk.upsampling_mm_manchester_scan_ref}


def _check_case(clock, case, ring, dtype):
    """clock_order on a case against the plain version and JAX, and the
    counts that show the case reaches what it names."""
    args, offset = clock_case(clock, case, dtype)
    targs = _torch(args)
    ring_floats = SMALL_RING if ring == "small" else 0
    got, counts, geom = clock_order(clock, *targs, ring_floats=ring_floats,
                                    row_offset=offset)
    want = REFS[clock](*targs)
    for a, b in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(_flat(_jax(clock, args)), _flat(want)):
        assert np.array_equal(np.asarray(a), b.numpy())

    B, cap = targs[2].shape
    total = lambda key: sum(c[key] for c in counts)
    assert geom[2] == (ring == "resident")
    assert int(want[-3].sum()) > 10 * B          # bits emitted
    assert total("filled") > 0                   # slots after a stop
    # the active slots are a prefix: the count is the stop
    assert torch.equal(got[-1], want[-1])
    if clock == "mm":
        assert total("add_segments") == total("segments")
    else:
        assert total("add_segments") == 0
    if ring == "resident":
        assert total("refills") == 0 and total("far_reads") == 0
    else:
        assert min(c["refills"] for c in counts) > 0
        assert cap > 4 * SMALL_RING
    if clock == "upsampling_gardner" and case == "carried":
        # the mid-bit pointer behind the staged span: from device memory
        # on the small ring (the ring staged it where it is resident);
        # negative and past the image it reads nothing (0)
        far = [c["far_reads"] for c in counts]
        assert far == ([0, 1, 0, 0] if ring == "small" else [0, 0, 0, 0])
    if case == "lanes":
        assert int(got[-1][3]) < int(got[-1].max()) // 2   # the early stop


@pytest.mark.parametrize("ring", ["resident", "small"])
@pytest.mark.parametrize("case", ["fresh", "carried", "lanes"])
@pytest.mark.parametrize("clock", ["mm", "upsampling_gardner",
                                   "upsampling_mm"])
def test_clock_order_matches_plain_and_jax(clock, case, ring):
    _check_case(clock, case, ring, np.float32)


@pytest.mark.parametrize("ring", ["resident", "small"])
@pytest.mark.parametrize("case", ["fresh", "carried", "lanes"])
@pytest.mark.parametrize("clock", ["mm", "upsampling_gardner",
                                   "upsampling_mm"])
def test_clock_order_f64_matches_plain_and_jax_x64(x64, clock, case, ring):
    _check_case(clock, case, ring, np.float64)


def test_mm_order_beyond_the_add_limit():
    """next_sample five million samples out: the segments round with the
    conversion, not the add; every slot inactive."""
    args, _ = clock_case("mm", "carried", np.float32)
    args[0][0, ::2] = 5e6 + 0.5
    targs = _torch(args)
    got, counts, _ = clock_order("mm", *targs, ring_floats=SMALL_RING)
    want = sk.mm_manchester_scan_ref(*targs)
    for a, b in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert counts[0]["add_segments"] == 0 and int(got[-1][0]) == 0
    assert counts[1]["add_segments"] == counts[1]["segments"]


@pytest.mark.parametrize("clock,dtype,chunk,resident,ring", [
    ("mm", np.float32, 10000, True, 30016),       # clocks_exact's images
    ("upsampling_gardner", np.float32, 10000, True, 40064),
    ("mm", np.float64, 10000, False, 16384),      # recycled
    ("upsampling_gardner", np.float64, 10000, False, 16384),
    ("mm", np.float32, 7000, True, 21016),        # the second chunk size
    ("upsampling_gardner", np.float32, 7000, True, 28064),
    ("upsampling_mm", np.float32, 10000, True, 40064),
    ("upsampling_mm", np.float64, 10000, False, 16384),
    ("upsampling_mm", np.float32, 7000, True, 28064),
])
def test_clock_scan_geometry(clock, dtype, chunk, resident, ring):
    """The ring the kernel chooses at one lane of the exact chain's POES
    images (TAIL_MARGIN + the chunk at interp 3 for "mm"; x 4 upsampled at
    interp 1): float32 resident, float64 recycled in 16 tiles."""
    size = np.dtype(dtype).itemsize
    cap = M + 3 * chunk if clock == "mm" else (M + chunk) * UP_L
    lt, tiles, res, n_ring, ctas = scan_geom(1, cap, size=size)
    assert (res, n_ring, ctas) == (resident, ring, 1)
    assert smem_bytes(tiles, n_ring, size) + CTA_RESERVE + 4 <= SMEM_PER_SM
    if not res:
        assert (tiles, 1 << lt) == (16, 1024) and cap * size > 227 * 1024


CLOCK_WRAPPERS = ("mm_manchester_scan", "upsampling_gardner_manchester_scan",
                  "upsampling_mm_manchester_scan")


@pytest.mark.parametrize("name", CLOCK_WRAPPERS)
def test_clock_wrapper_on_cpu_takes_the_ring_keyword(name):
    """On CPU tensors the wrapper runs the plain version, ring_floats or
    not, and launches nothing."""
    clock = name.rsplit("_manchester", 1)[0]
    targs = _torch(clock_case(clock, "fresh", np.float32)[0])
    wrapper = getattr(sk, name)
    before = wrapper.launches
    a = wrapper(*targs, ring_floats=SMALL_RING)
    b = wrapper(*targs)
    assert wrapper.launches == before
    for u, v in zip(_flat(a), _flat(b)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("name", [f"{w}{s}_serial" for w in CLOCK_WRAPPERS
                                  for s in ("", "_f64")])
def test_serial_twins_refuse_cpu_tensors(name):
    clock = name.rsplit("_manchester", 1)[0]
    dtype = np.float64 if "_f64" in name else np.float32
    targs = _torch(clock_case(clock, "fresh", dtype)[0])
    twin = getattr(sk, name)
    with pytest.raises(ValueError, match="CUDA device only"):
        twin(*targs)
    assert twin.launches == 0

"""The exact chain's kernels against their plain PyTorch versions, on the
card: ``gardner_manchester_scan`` at one lane over a quirks buffer image
whose carried mid-bit pointer is stale (inside the image, past the valid
length, past the image, negative) and at 37 lanes with ragged valid
lengths, its ring holding the whole image or forced small (tiles
recycled, the stale pointer read from device memory), on rows aligned to
16 bytes or not, also against its serial twin
``gardner_manchester_scan_serial``; ``pll_scan`` and ``agc_scan`` at one
lane from an unlocked start over a chunk of each float32 mode and a short
final one, in float32 (POES) and in float64 (the ``argos`` mode: their
double instances ``pll_scan_f64`` and ``agc_scan_f64``); and three chunks
of ``chain.chunk_step`` in each mode, float32 and float64 (there the
three double instances, ``gardner_manchester_scan_f64`` too), the kernels
against the plain versions on the same card, every output and state bit
for bit.  The float64 redesigns on their own: ``pll_scan_f64`` (the
decoupled kernel in double) and ``gardner_manchester_scan_f64`` (the
whole-image kernel in double) against their plain versions and their
serial twins ``pll_scan_f64_serial`` and
``gardner_manchester_scan_f64_serial``, at 1, 255, 256, 257, 1,234, 1,680
and 2,400 samples; the PLL from an unlocked start in noise (it stays
unlocked), a locked start, a lane that locks inside a 256-sample chunk
and three such lanes at once; the Gardner scan over quirks images with
the mid-bit pointer stale (inside, past the valid length, past the
image, negative) on three lanes, rows aligned to 16 bytes or one double
past, the ring resident or forced small.

Marked ``cuda``; skips without a card.  On a machine with one:

    python -m pytest tests/test_torch_exact_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu_torch import chain
from project_desert_tortoise_tpu_torch.ops import agc, fir, pll
from project_desert_tortoise_tpu_torch.ops import manchester as man
from project_desert_tortoise_tpu_torch.ops.kernels import pll_kernel
from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
from project_desert_tortoise_tpu_torch.utils import synth, wav as W
from project_desert_tortoise_tpu_torch.utils.config import MODES, POES_TIP

FS = 50000.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal(got, want):
    for a, b in zip(got, want):
        if isinstance(a, (tuple, list)):
            _equal(a, b)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


def _image(B, cap, step, seed, dev, offset=0):
    """x and t (B, cap) on dev; with `offset`, each a view `offset` floats
    into its storage, so that rows start off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    x = np.empty((B, cap), np.float32)
    for b in range(B):
        sym = rng.choice([-1.0, 1.0], int(cap / step) + 2)
        pos = (np.arange(cap) + rng.uniform(0, step)) / step
        x[b] = sym[pos.astype(int)] + 0.1 * rng.standard_normal(cap)
    t = np.tile(np.arange(1, cap + 1, dtype=np.float32) / np.float32(FS),
                (B, 1))

    def place(a):
        buf = torch.zeros(B * cap + offset, device=dev)
        buf[offset:] = torch.from_numpy(a).reshape(-1).to(dev)
        return buf[offset:].view(B, cap)
    return place(x), place(t)


# the forced small ring: 2,048 floats, four tiles of 512
SMALL_RING = 2048


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["aligned", "unaligned"])
@pytest.mark.parametrize("ring", ["resident", "small"])
@pytest.mark.parametrize("case", ["inside", "past n", "past cap",
                                  "negative"])
@pytest.mark.parametrize("B", [1, 37])
def test_gardner_manchester_scan_matches_plain_on_card(card, case, B, ring,
                                                       rows):
    params = chain.make_params(POES_TIP, FS, quirks=True)
    # unaligned: rows of 17,999 floats from 1 float past a 16-byte
    # boundary, so each lane's row has its own ragged head and tail
    cap = 6000 * params.interp - (rows == "unaligned")
    msyms = chain.max_symbols(cap, params.step_size)
    x, t = _image(B, cap, params.step_size, B, card,
                  offset=int(rows == "unaligned"))
    n = torch.full((B,), cap, dtype=torch.int32, device=card)
    n[::3] = cap - 4321                      # short final chunks
    half = {"inside": cap - 9.6, "past n": cap - 4321 + 3.5,
            "past cap": cap + 7.25, "negative": -4.5}[case]
    full = lambda v: torch.full((B,), float(np.float32(v)), device=card)
    fstate = (full(7.3), full(half), full(0.4), full(0.9), full(-0.8),
              full(0.7))
    m0 = man.manchester_init((B,), device=card)
    istate = (m0.clockmod, m0.evenodd + 1)
    gp = sk.GardnerParams(params.step_size, params.gardner_err_limit,
                          params.gardner_gain, params.resync_threshold)
    ring_floats = SMALL_RING if ring == "small" else 0
    config = sk.gardner_scan_launch_config(B, cap, ring_floats)
    assert config["resident"] == (ring == "resident"), config
    assert config["local_bytes"] == 0, config
    before = sk.gardner_manchester_scan.launches
    got = sk.gardner_manchester_scan(fstate, istate, x, t, n, gp, msyms,
                                     ring_floats=ring_floats)
    torch.cuda.synchronize()
    assert sk.gardner_manchester_scan.launches == before + 1
    _equal(got, sk.gardner_manchester_scan_ref(fstate, istate, x, t, n, gp,
                                               msyms))
    _equal(got, sk.gardner_manchester_scan_serial(fstate, istate, x, t, n,
                                                  gp, msyms))
    assert int(got[-1].min()) > 0 and int(got[-2].sum()) > 100 * B


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L", [10000, 2400, 1234])
def test_one_lane_pll_and_agc_from_an_unlocked_start_on_card(card, L,
                                                              dtype):
    """float32: POES_TIP on a POES clip; float64: the argos mode on an
    ARGOS clip, on the double instances."""
    f64 = dtype == "float64"
    fs = 32000.0 if f64 else FS
    params = chain.make_params(MODES["argos" if f64 else "poes_tip"], fs)
    if f64:
        iq, _ = synth.make_argos_recording(n_packets=2, fs=fs)
    else:
        iq, _ = synth.make_poes_recording(n_frames=3, fs=FS)
    iq = (iq / (np.abs(iq).max() * 1.2)).astype(
        np.complex128 if f64 else np.complex64)
    a = int(0.3 * fs)                        # where the signal starts
    z = tuple(torch.from_numpy(np.ascontiguousarray(v[a:a + L])[None]).to(
        card) for v in (iq.real, iq.imag))
    tdt = getattr(torch, dtype)
    cold = pll.init_state(params.pll, (1,), device=card, dtype=tdt)
    launches = (pll_kernel.pll_scan_f64.launches,
                sk.agc_scan_f64.launches)
    got = pll_kernel.pll_scan_kernel(params.pll, cold, z)
    _equal(got, pll.pll_scan_ref(params.pll, cold, *z))
    x = fir.fir_interp(got[1], params.taps, params.interp)
    gain = torch.full((1,), 17.58, device=card, dtype=tdt)
    ap = sk.AGCParams(params.agc_attack, params.agc_decay)
    _equal(sk.agc_scan(gain, x, ap), sk.agc_scan_ref(gain, x, ap))
    assert got[1].dtype == x.dtype == tdt
    assert (pll_kernel.pll_scan_f64.launches,
            sk.agc_scan_f64.launches) == tuple(k + f64 for k in launches)


F64_LENGTHS = [1, 255, 256, 257, 1234, 1680, 2400]


def _argos_clip():
    """The two-packet ARGOS clip in complex128, the argos mode's params."""
    fs = 32000.0
    iq, _ = synth.make_argos_recording(n_packets=2, fs=fs)
    iq = (iq / (np.abs(iq).max() * 1.2)).astype(np.complex128)
    return iq, chain.make_params(MODES["argos"], fs), fs


@pytest.mark.cuda
@pytest.mark.parametrize("L", F64_LENGTHS)
@pytest.mark.parametrize("start", ["unlocked", "locked",
                                   "locks mid-chunk", "three lanes"])
def test_pll_scan_f64_matches_plain_and_serial_on_card(card, start, L):
    iq, params, fs = _argos_clip()
    a = int(0.4 * fs)                        # where the first packet starts
    zd = [torch.from_numpy(np.ascontiguousarray(v)).to(card)
          for v in (iq.real, iq.imag)]
    plane = lambda b: tuple(v[b:b + L] for v in zd)
    cold = pll.init_state(params.pll, (1,), device=card, dtype=torch.float64)
    warm, _, lock = pll.pll_scan_ref(params.pll, cold,
                                     *(v[a:a + 2400][None] for v in zd))
    locks_at = int(torch.nonzero(lock[0] > params.pll.lock_threshold)[0])
    assert bool(warm.locked[0]) and locks_at % 256 not in (0, 255)
    lanes = {"unlocked": [(cold, 0)], "locked": [(warm, a + 2400)],
             "locks mid-chunk": [(cold, a)],
             "three lanes": [(cold, 0), (warm, a + 2400), (cold, a)]}[start]
    st = pll.PLLState(*(torch.cat(f) for f in zip(*(s for s, _ in lanes))))
    z = tuple(torch.stack(p).contiguous()
              for p in zip(*(plane(b) for _, b in lanes)))
    before = (pll_kernel.pll_scan_f64.launches,
              pll_kernel.pll_scan_f64_serial.launches)
    got = pll_kernel.pll_scan_kernel(params.pll, st, z)
    torch.cuda.synchronize()
    _equal(got, pll.pll_scan_ref(params.pll, st, *z))
    _equal(got, pll_kernel.pll_scan_f64_serial(params.pll, st, z))
    assert (pll_kernel.pll_scan_f64.launches,
            pll_kernel.pll_scan_f64_serial.launches) == tuple(
                k + 1 for k in before)
    assert got[1].dtype == torch.float64
    if start == "unlocked":                  # noise: no lock in the chunk
        assert not bool(got[0].locked[0])
    with pytest.raises(ValueError, match="unlocked"):
        pll_kernel.pll_scan_kernel(
            params.pll, st, z, unlocked=torch.zeros(
                (len(lanes),), dtype=torch.int32, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["aligned", "unaligned"])
@pytest.mark.parametrize("ring", ["resident", "small"])
@pytest.mark.parametrize("L", F64_LENGTHS)
def test_gardner_manchester_scan_f64_matches_plain_and_serial_on_card(
        card, L, ring, rows):
    """Three lanes of the argos mode's quirks image (L new samples over a
    2,400-sample image), the mid-bit pointer stale in each of four ways;
    unaligned: rows of 2,399 doubles, one double past a boundary."""
    _, params, fs = _argos_clip()
    B = 3
    cap = 2400 - (rows == "unaligned")
    msyms = chain.max_symbols(cap, params.step_size)
    rng = np.random.default_rng(L)
    x = np.empty((B, cap))
    for b in range(B):
        sym = rng.choice([-1.0, 1.0], int(cap / params.step_size) + 2)
        pos = (np.arange(cap) + rng.uniform(0, params.step_size)) \
            / params.step_size
        x[b] = sym[pos.astype(int)] + 0.1 * rng.standard_normal(cap)
    t = np.tile(np.arange(1, cap + 1) / fs, (B, 1))
    offset = int(rows == "unaligned")

    def place(a):
        buf = torch.zeros(B * cap + offset, dtype=torch.float64, device=card)
        buf[offset:] = torch.from_numpy(a).reshape(-1).to(card)
        return buf[offset:].view(B, cap)
    x, t = place(x), place(t)
    n = torch.full((B,), min(L, cap), dtype=torch.int32, device=card)
    n[1] = cap
    gp = sk.GardnerParams(params.step_size, params.gardner_err_limit,
                          params.gardner_gain, params.resync_threshold)
    m0 = man.manchester_init((B,), device=card)
    istate = (m0.clockmod, m0.evenodd + 1)
    ring_floats = 256 if ring == "small" else 0
    config = sk.gardner_scan_launch_config(B, cap, ring_floats,
                                           dtype=torch.float64)
    assert config["resident"] == (ring == "resident"), config
    assert config["local_bytes"] == 0, config
    f = lambda v: torch.full((B,), v, dtype=torch.float64, device=card)
    for half in (cap - 9.6, min(L, cap) + 3.5, cap + 7.25, -4.5):
        fstate = (f(7.3), f(half), f(0.4), f(0.9), f(-0.8), f(0.7))
        args = (fstate, istate, x, t, n, gp, msyms)
        before = sk.gardner_manchester_scan_f64.launches
        got = sk.gardner_manchester_scan(*args, ring_floats=ring_floats)
        torch.cuda.synchronize()
        assert sk.gardner_manchester_scan_f64.launches == before + 1
        _equal(got, sk.gardner_manchester_scan_ref(*args))
        _equal(got, sk.gardner_manchester_scan_f64_serial(*args))
        assert got[2].dtype == torch.float64 and int(got[-1][1]) > 0


def _plain_kernels(monkeypatch):
    """The exact chain's kernel wrappers, as chain.chunk_step reaches them,
    replaced by their plain versions."""
    monkeypatch.setattr(pll_kernel, "pll_scan_kernel",
                        lambda p, s, z, **_: pll.pll_scan_ref(p, s, *z))
    monkeypatch.setattr(sk, "agc_scan", sk.agc_scan_ref)
    monkeypatch.setattr(sk, "gardner_manchester_scan",
                        sk.gardner_manchester_scan_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,quirks", [
    ("poes_tip", True), ("poes_tip", False), ("poes_tip_realtime", True),
    ("argos_realtime", True), ("argos", True), ("argos", False)])
def test_chunk_step_kernels_match_plain_on_card(card, mode, quirks,
                                                monkeypatch):
    """Each mode in its dtype: float32, or float64 for ``argos``."""
    cfg = MODES[mode]
    dt = cfg.np_dtype()
    fs = 32000.0 if mode.startswith("argos") else FS
    params = chain.make_params(cfg, fs, quirks=quirks)
    if mode.startswith("argos"):
        iq, _ = synth.make_argos_recording(n_packets=1, fs=fs)
    else:
        iq, _ = synth.make_poes_recording(n_frames=3, fs=fs)
    iq = (iq / (np.abs(iq).max() * 1.2)).astype(
        np.complex128 if dt == np.float64 else np.complex64)
    t = W.time_axis(len(iq), fs, dt)
    t_ext = np.concatenate([t, [t[-1] + dt.type(1.0) / dt.type(fs)]])
    chunk, a0 = 2000, int(0.3 * fs)

    def run():
        state = chain.init_state(params, 17.58, chunk, device=card,
                                 dtype=getattr(torch, str(dt)))
        outs = []
        for k, n in enumerate((chunk, chunk, chunk * 5 // 8)):
            a = a0 + k * chunk
            planes = [torch.from_numpy(np.ascontiguousarray(v)).to(card)
                      for v in (iq[a:a + n].real, iq[a:a + n].imag,
                                t[a:a + n], t_ext[a + 1:a + n + 1])]
            state, out = chain.chunk_step(params, state, *planes)
            outs.append(out)
        return state, outs
    scan = (sk.gardner_manchester_scan_f64 if dt == np.float64
            else sk.gardner_manchester_scan)
    before = scan.launches
    pll_before = pll_kernel.pll_scan_f64.launches
    got = run()
    assert scan.launches == before + 3
    assert pll_kernel.pll_scan_f64.launches == pll_before + 3 * (
        dt == np.float64)
    with monkeypatch.context() as m:
        _plain_kernels(m)
        want = run()
    _equal(got, want)
    assert sum(int(o.bit_mask.sum()) for o in got[1]) > 0


@pytest.mark.cuda
def test_gardner_scan_refuses_bad_input(card):
    params = chain.make_params(POES_TIP, FS)
    gp = sk.GardnerParams(params.step_size, params.gardner_err_limit,
                          params.gardner_gain, params.resync_threshold)
    x = torch.zeros((2, 300), device=card)
    n = torch.full((2,), 300, dtype=torch.int32, device=card)
    f = tuple(torch.zeros(2, device=card) for _ in range(6))
    i = tuple(torch.zeros(2, dtype=torch.int32, device=card)
              for _ in range(2))
    for scan in (sk.gardner_manchester_scan,
                 sk.gardner_manchester_scan_serial):
        with pytest.raises(TypeError):
            scan(f, i, x.double(), x, n, gp, 20)
        with pytest.raises(ValueError):
            scan(f, i, x, x.cpu(), n, gp, 20)
        with pytest.raises(ValueError):
            scan(f, i, x, x, n[:1], gp, 20)
    with pytest.raises(RuntimeError):            # the kernel refuses 0 slots
        sk.gardner_manchester_scan(f, i, x, x, n, gp, 0)
    with pytest.raises(ValueError):              # no plain version behind it
        sk.gardner_manchester_scan_serial(f, i, x.cpu(), x.cpu(), n.cpu(),
                                          gp, 20)

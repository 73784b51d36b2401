"""The CUDA kernels against their plain PyTorch versions, on the card:
the fused chain (POES and ARGOS geometries, staged times and in-kernel time
generation), the front-half chain (PLL+FIR+AGC, both geometries), the PLL
scan, the AGC scan, the windowed Gardner/Manchester scan and every variant
of the two ablation kernels.  The Gardner kernel also on the cases of
``tests/test_torch_gardner_order.py`` (both geometries) and over many
windows against its serial twin (``gardner_manchester_serial``).  The decoupled fused and front-half kernels
also on warm, cold and mixed lanes, ragged batches and lanes shorter than
a chunk, and against the serial kernels they replace
(``fused_demod_serial``, ``pll_fir_agc_serial``) over 120,000 samples;
the decoupled PLL and AGC scans against their plain versions and their
serial twins (``pll_scan_serial``, ``agc_scan_serial``) on warm, cold and
mixed lanes, 1 to 100 lanes, lanes shorter than a chunk and longer.

Marked ``cuda``; skips without a card.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The kernels are built with -fmad=false and without fast math, so they
agree with the plain versions bit for bit on every output.
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu_torch import chain
from project_desert_tortoise_tpu_torch.ops import fir, pll
from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
from project_desert_tortoise_tpu_torch.ops.kernels import chain_kernel as CK
from project_desert_tortoise_tpu_torch.ops.kernels import fused_kernel as FK
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    pll_fir_agc, pll_fir_agc_ref, pll_fir_agc_serial)
from project_desert_tortoise_tpu_torch.ops.kernels.fused_kernel import (
    fused_demod, fused_demod_ref, fused_demod_serial)
from project_desert_tortoise_tpu_torch.ops.kernels import pll_kernel as PK
from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
    pll_scan_kernel, pll_scan_serial)
from project_desert_tortoise_tpu_torch.tools import ablate_fused as AF
from project_desert_tortoise_tpu_torch.tools import ablate_kernel as AK
from project_desert_tortoise_tpu_torch.utils.config import ARGOS, POES_TIP
from test_torch_gardner_order import (
    CASES, GEOMETRIES, gardner_case, gardner_order)

FS = 50000.0
ARGOS_FS = 32000.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _input(B, L, seed, dev):
    rng = np.random.default_rng(seed)
    sym = rng.choice([-1.0, 1.0], size=(B, L // 3 + 9))
    base = np.repeat(sym, 3, axis=1)[:, :L]
    re = (base * 0.01 + 0.002 * rng.standard_normal((B, L))).astype(np.float32)
    im = (0.002 * rng.standard_normal((B, L))).astype(np.float32)
    tn = np.tile(np.arange(1, L + 1, dtype=np.float32) / FS, (B, 1))
    return re, im, torch.from_numpy(tn).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("squelch", [None, "after_pll", "after_agc"])
@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_kernel_matches_plain_on_card(card, squelch, dtype):
    params = chain.make_params(POES_TIP, FS)._replace(
        squelch_threshold=0.05 if squelch else None, squelch_position=squelch)
    B, L = 100, 1500                      # ragged: not a multiple of a warp
    re, im, tn = _input(B, L, 1, card)
    if dtype == "int16":
        re = np.round(re * 32768.0).astype(np.int16)
        im = np.round(im * 32768.0).astype(np.int16)
    z = (torch.from_numpy(re).to(card), torch.from_numpy(im).to(card))
    st = pll.init_state(params.pll, (B,), device=card)
    gain = torch.full((B,), 17.58, device=card)
    before = fused_demod.launches
    got = fused_demod(params, st, gain, z, tn)
    torch.cuda.synchronize()
    assert fused_demod.launches == before + 1
    want = fused_demod_ref(params, st, gain, z, tn)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_refuses_bad_input(card):
    params = chain.make_params(POES_TIP, FS)
    st = pll.init_state(params.pll, (4,), device=card)
    gain = torch.full((4,), 17.58, device=card)
    z = torch.zeros((4, 64), device=card)
    with pytest.raises(TypeError):
        fused_demod(params, st, gain, (z.double(), z.double()), z)
    with pytest.raises(ValueError):
        fused_demod(params, st, gain, (z, z), z.cpu())
    # interp 2 (hist 39): a geometry the kernel does not instantiate
    with pytest.raises(NotImplementedError):
        fused_demod(params._replace(interp=2), st, gain, (z, z), z)
    with pytest.raises(NotImplementedError):
        pll_fir_agc(params._replace(interp=2), st, gain, (z, z))
    with pytest.raises(ValueError, match="time generation"):
        fused_demod(params, st, gain, (z, z), None)


def _equal(got, want):
    for a, b in zip(got, want):
        if isinstance(a, (tuple, list)):
            _equal(a, b)
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("squelch", [None, "after_pll"])
def test_pll_fir_agc_matches_plain_on_card(card, squelch):
    params = chain.make_params(POES_TIP, FS)._replace(
        squelch_threshold=0.05 if squelch else None, squelch_position=squelch)
    B, L = 100, 1500
    re, im, _ = _input(B, L, 2, card)
    z = (torch.from_numpy(re).to(card), torch.from_numpy(im).to(card))
    st = pll.init_state(params.pll, (B,), device=card)
    gain = torch.full((B,), 17.58, device=card)
    before = pll_fir_agc.launches
    got = pll_fir_agc(params, st, gain, z)
    torch.cuda.synchronize()
    assert pll_fir_agc.launches == before + 1
    _equal(got, pll_fir_agc_ref(params, st, gain, z))


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
def test_pll_scan_matches_plain_on_card(card, warm):
    params = chain.make_params(POES_TIP, FS).pll
    B, L = 100, 1500
    re, im, _ = _input(B, L, 3, card)
    st = pll.init_state(params, (B,), device=card)
    if warm:
        st = st._replace(freq=torch.full((B,), 0.1, device=card),
                         locked=torch.ones((B,), dtype=torch.bool,
                                           device=card))
    z = (torch.from_numpy(re).to(card), torch.from_numpy(im).to(card))
    before = pll_scan_kernel.launches
    got = pll_scan_kernel(params, st, z)
    torch.cuda.synchronize()
    assert pll_scan_kernel.launches == before + 1
    _equal(got, pll.pll_scan_ref(params, st, *z))


@pytest.mark.cuda
def test_agc_scan_matches_plain_on_card(card):
    params = chain.make_params(POES_TIP, FS)
    B, n = 100, 4500
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal((B, n)) * np.linspace(
        0.01, 2.0, n)).astype(np.float32)).to(card)
    gain = torch.full((B,), 17.58, device=card)
    p = sk.AGCParams(params.agc_attack, params.agc_decay)
    before = sk.agc_scan.launches
    got = sk.agc_scan(gain, x, p)
    torch.cuda.synchronize()
    assert sk.agc_scan.launches == before + 1
    _equal(got, sk.agc_scan_ref(gain, x, p))


@pytest.mark.cuda
def test_fir_interp_full_float32_on_card(card):
    """The scan branch's FIR convolution sums in float32 on the card (no
    TF32): within 1e-5 of the float64 sum at unit input amplitude.  TF32's
    10-bit mantissa would be off by about 1e-3 wherever cuDNN picked a
    TF32 algorithm for this one-channel convolution."""
    params = chain.make_params(POES_TIP, FS)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (100, 4500)).astype(np.float32))
    want = fir.fir_interp(x.double(), params.taps, params.interp)
    got = fir.fir_interp(x.to(card), params.taps, params.interp)
    assert got.dtype == torch.float32
    assert float((got.cpu().double() - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_gardner_manchester_matches_plain_on_card(card):
    params = chain.make_params(POES_TIP, FS)
    B, L = 100, 1500
    re, im, _ = _input(B, L, 5, card)
    z = (torch.from_numpy(re).to(card), torch.from_numpy(im).to(card))
    st = pll.init_state(params.pll, (B,), device=card)
    _, _, y, _ = pll_fir_agc_ref(params, st, torch.full((B,), 17.58,
                                                        device=card), z)
    cap = 3 * 1536                         # two windows of 768 samples
    y = torch.nn.functional.pad(y, (0, cap - y.shape[1]))
    t = torch.arange(1, cap + 1, dtype=torch.float32,
                     device=card).expand(B, cap)
    p = sk.GardnerParams(params.step_size, params.gardner_err_limit,
                         params.gardner_gain, params.resync_threshold)
    lay = sk.layout(cap, cap // 2, params.step_size,
                    params.gardner_err_limit)
    zf = torch.zeros((B,), device=card)
    zi = torch.zeros((B,), dtype=torch.int32, device=card)
    n = torch.full((B,), 3 * L - 100, dtype=torch.int32, device=card)
    args = ((zf,) * 6, (zi, zi), y, t, n, p, lay)
    before = sk.gardner_manchester.launches
    got = sk.gardner_manchester(*args)
    torch.cuda.synchronize()
    assert sk.gardner_manchester.launches == before + 1
    assert int(got[4].sum()) > 10 * B
    _equal(got, sk.gardner_manchester_ref(*args))


def _argos_input(B, L, seed, dev):
    """40-sample BPSK symbols with noise (tests/test_pallas_fused.py:101)."""
    rng = np.random.default_rng(seed)
    sym = rng.choice([-1.0, 1.0], size=(B, L // 40 + 2))
    base = np.repeat(sym, 40, axis=1)[:, :L]
    re = (base * 0.01 + 0.001 * rng.standard_normal((B, L))).astype(np.float32)
    im = (0.001 * rng.standard_normal((B, L))).astype(np.float32)
    return torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev)


def _int16(z):
    return tuple(torch.round(x * 32768.0).to(torch.int16) for x in z)


@pytest.mark.cuda
@pytest.mark.parametrize("squelch", [None, "after_pll", "after_agc"])
@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_argos_fused_matches_plain_on_card(card, squelch, dtype):
    params = chain.make_params(ARGOS, ARGOS_FS)._replace(
        squelch_threshold=0.15 if squelch else None, squelch_position=squelch)
    B, L = 100, 2000
    z = _argos_input(B, L, 7, card)
    if dtype == "int16":
        z = _int16(z)
    tn = torch.arange(L, dtype=torch.float32, device=card).expand(B, L)
    st = pll.init_state(params.pll, (B,), device=card)
    gain = torch.full((B,), 50.0, device=card)
    before = fused_demod.launches
    got = fused_demod(params, st, gain, z, tn.contiguous())
    torch.cuda.synchronize()
    assert fused_demod.launches == before + 1
    assert int(got[2].sum()) > B
    _equal(got, fused_demod_ref(params, st, gain, z, tn.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["poes", "argos"])
@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_time_generation_matches_plain_on_card(card, mode, dtype):
    """t_next=None: seeds, a zero-padded head on lane 0 and step ts."""
    if mode == "poes":
        params, fs = chain.make_params(POES_TIP, FS), FS
        re, im, _ = _input(100, 1500, 8, card)
        z = (torch.from_numpy(re).to(card), torch.from_numpy(im).to(card))
    else:
        params, fs = chain.make_params(ARGOS, ARGOS_FS), ARGOS_FS
        z = _argos_input(100, 1500, 9, card)
    B, L = z[0].shape
    z = tuple(x.clone() for x in z)
    for x in z:
        x[0, :300] = 0.0
    if dtype == "int16":
        z = _int16(z)
    ts = float(np.float32(1.0) / np.float32(fs))
    seed = torch.arange(B, dtype=torch.float32, device=card) * 0.25 + ts
    pad0 = torch.zeros(B, device=card)
    pad0[0] = 300.0
    st = pll.init_state(params.pll, (B,), device=card)
    gain = torch.full((B,), 17.58, device=card)
    before = fused_demod.launches
    got = fused_demod(params, st, gain, z, None, seed, pad0, ts)
    torch.cuda.synchronize()
    assert fused_demod.launches == before + 1
    _equal(got, fused_demod_ref(params, st, gain, z, None, seed, pad0, ts))


@pytest.mark.cuda
@pytest.mark.parametrize("squelch", [None, "after_pll"])
def test_argos_pll_fir_agc_matches_plain_on_card(card, squelch):
    params = chain.make_params(ARGOS, ARGOS_FS)._replace(
        squelch_threshold=0.15 if squelch else None, squelch_position=squelch)
    B = 100
    z = _argos_input(B, 1500, 10, card)
    st = pll.init_state(params.pll, (B,), device=card)
    gain = torch.full((B,), 50.0, device=card)
    before = pll_fir_agc.launches
    got = pll_fir_agc(params, st, gain, z)
    torch.cuda.synchronize()
    assert pll_fir_agc.launches == before + 1
    _equal(got, pll_fir_agc_ref(params, st, gain, z))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(AK.VARIANTS))
def test_ablate_kernel_matches_plain_on_card(card, name):
    ins, state = AK.inputs(name, 512, 1, card)
    before = AK.ablate_kernel.launches
    got = AK.ablate_kernel(name, ins, state, 128)
    torch.cuda.synchronize()
    assert AK.ablate_kernel.launches == before + 1
    _equal(got, AK.ablate_kernel_ref(name, ins, state, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(AF.VARIANTS))
def test_ablate_fused_matches_plain_on_card(card, name):
    xs, state = AF.inputs(512, 1, card)
    before = AF.ablate_fused.launches
    got = AF.ablate_fused(name, *xs, state, 128)
    torch.cuda.synchronize()
    assert AF.ablate_fused.launches == before + 1
    want = AF.ablate_fused_ref(name, *xs, state, 128)
    _equal(got, want)
    # twice into the same buffers, as the tool's timed calls write
    out = AF.output_buffers(512, AF.LANES, card)
    for _ in range(2):
        _equal(AF.ablate_fused(name, *xs, state, 128, out), want)


# --- the decoupled kernels: lane states, variants, shapes, the serial twins

def _mode(mode, squelch="mode"):
    """(params, fs, input maker) of a mode; squelch overrides its position
    (threshold 0.05, as the realtime modes')."""
    if mode == "poes":
        params, fs = chain.make_params(POES_TIP, FS), FS

        def make(B, L, seed, dev):
            re, im, _ = _input(B, L, seed, dev)
            return torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev)
    else:
        params, fs, make = chain.make_params(ARGOS, ARGOS_FS), ARGOS_FS, \
            _argos_input
    if squelch != "mode":
        params = params._replace(squelch_threshold=0.05 if squelch else None,
                                 squelch_position=squelch)
    return params, fs, make


def _lanes(params, B, kind, dev):
    """PLL lanes: "warm" (locked, the main path's warm start), "cold"
    (pll.init_state) or "mixed": warm, cold, and cold with the lock signal
    just under its threshold (it locks within the first chunk), in turn."""
    cold = pll.init_state(params.pll, (B,), device=dev)
    if kind == "cold":
        return cold
    warm = cold._replace(freq=torch.full((B,), 0.01, device=dev),
                         locked=torch.ones((B,), dtype=torch.bool,
                                           device=dev))
    if kind == "warm":
        return warm
    near = cold._replace(locksig=torch.full(
        (B,), float(np.float32(params.pll.lock_threshold) - 1e-4),
        device=dev))
    which = torch.arange(B, device=dev) % 3
    return pll.PLLState(*(torch.where(which == 0, w, torch.where(
        which == 1, c, n)) for w, c, n in zip(warm, cold, near)))


def _times(fs, B, L, tgen, dev):
    ts = float(np.float32(1.0) / np.float32(fs))
    if not tgen:
        return (torch.arange(1, L + 1, dtype=torch.float32, device=dev)
                .div(fs).expand(B, L).contiguous(),)
    pad0 = torch.zeros(B, device=dev)
    pad0[0] = min(300.0, L)
    return (None, torch.arange(B, dtype=torch.float32, device=dev) * 0.25
            + ts, pad0, ts)


@pytest.mark.cuda
@pytest.mark.parametrize("tgen", [False, True])
@pytest.mark.parametrize("squelch", [None, "after_pll", "after_agc"])
@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("mode", ["poes", "argos"])
def test_decoupled_fused_every_variant_on_card(card, mode, dtype, squelch,
                                               tgen):
    """Every instantiated variant on mixed lanes, B = 37 (not a multiple
    of a warp), L = 700 (not a multiple of the chunk);
    the unlocked counts: 0 on warm lanes, at most L on the others, and
    strictly between on some lanes that lock during the launch."""
    params, fs, make = _mode(mode, squelch)
    B, L = 37, 700
    z = make(B, L, 11, card)
    if dtype == "int16":
        z = _int16(z)
    st = _lanes(params, B, "mixed", card)
    gain = torch.full((B,), 17.58, device=card)
    targs = _times(fs, B, L, tgen, card)
    unlocked = torch.full((B,), -1, dtype=torch.int32, device=card)
    got = fused_demod(params, st, gain, z, *targs, unlocked=unlocked)
    _equal(got, fused_demod_ref(params, st, gain, z, *targs))
    n = unlocked.cpu()
    assert (n[0::3] == 0).all() and ((n >= 0) & (n <= L)).all()
    assert ((n > 0) & (n < L)).any()   # some lanes lock inside the launch


@pytest.mark.cuda
@pytest.mark.parametrize("squelch", [None, "after_pll"])
@pytest.mark.parametrize("lanes", ["warm", "cold", "mixed"])
@pytest.mark.parametrize("mode", ["poes", "argos"])
def test_decoupled_pll_fir_agc_lanes_on_card(card, mode, lanes, squelch):
    params, fs, make = _mode(mode, squelch)
    B, L = 37, 700
    z = make(B, L, 12, card)
    st = _lanes(params, B, lanes, card)
    gain = torch.full((B,), 17.58, device=card)
    _equal(pll_fir_agc(params, st, gain, z),
           pll_fir_agc_ref(params, st, gain, z))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", ["warm", "cold"])
@pytest.mark.parametrize("mode", ["poes", "argos"])
def test_decoupled_fused_lanes_on_card(card, mode, lanes):
    params, fs, make = _mode(mode)
    B, L = 37, 700
    z = make(B, L, 13, card)
    st = _lanes(params, B, lanes, card)
    gain = torch.full((B,), 17.58, device=card)
    targs = _times(fs, B, L, True, card)
    _equal(fused_demod(params, st, gain, z, *targs),
           fused_demod_ref(params, st, gain, z, *targs))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 100, 256, 257])
@pytest.mark.parametrize("mode", ["poes", "argos"])
def test_decoupled_short_lanes_on_card(card, mode, L):
    """Lanes shorter than a chunk, one chunk, a chunk and one sample; a
    batch of 3 mixed lanes."""
    params, fs, make = _mode(mode)
    B = 3
    z = make(B, L, 14, card)
    st = _lanes(params, B, "mixed", card)
    gain = torch.full((B,), 17.58, device=card)
    targs = _times(fs, B, L, True, card)
    _equal(fused_demod(params, st, gain, z, *targs),
           fused_demod_ref(params, st, gain, z, *targs))
    _equal(pll_fir_agc(params, st, gain, z),
           pll_fir_agc_ref(params, st, gain, z))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["poes", "argos"])
def test_decoupled_matches_serial_over_long_lanes_on_card(card, mode):
    """120,000 samples a lane (469 chunks) on 64 mixed lanes against the
    serial kernels, bit for bit; and the launch counters: each wrapper
    counts its own kernel only."""
    params, fs, make = _mode(mode)
    B, L = 64, 120000
    z = make(B, L, 15, card)
    st = _lanes(params, B, "mixed", card)
    gain = torch.full((B,), 17.58, device=card)
    targs = _times(fs, B, L, True, card)
    counts = lambda: (fused_demod.launches, fused_demod_serial.launches,
                      pll_fir_agc.launches, pll_fir_agc_serial.launches)
    before = counts()
    want = fused_demod_serial(params, st, gain, z, *targs)
    assert int(want[2].sum()) > B * L // 100
    _equal(fused_demod(params, st, gain, z, *targs), want)
    want = pll_fir_agc_serial(params, st, gain, z)
    _equal(pll_fir_agc(params, st, gain, z), want)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1, 1]


@pytest.mark.cuda
def test_serial_kernels_refuse_the_cpu(card):
    params = chain.make_params(POES_TIP, FS)
    st = pll.init_state(params.pll, (4,), device="cpu")
    gain = torch.full((4,), 17.58)
    z = torch.zeros((4, 64))
    with pytest.raises(ValueError):
        fused_demod_serial(params, st, gain, (z, z), z)
    with pytest.raises(ValueError):
        pll_fir_agc_serial(params, st, gain, (z, z))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["poes", "argos"])
def test_launch_config_on_card(card, mode):
    """What the card reports for the main path's instantiations: the
    design's one lane a CTA, 256-sample chunks and 128 threads, shared
    memory within the card's 227 KB a CTA, and no local memory beyond
    the 48-byte frame of sinf/cosf's slow path (no spills)."""
    params, _, _ = _mode(mode)
    for cfg in (FK.launch_config(params), CK.launch_config(params)):
        assert cfg["lanes_per_cta"] == 1 and cfg["chunk"] == 256
        assert cfg["threads"] == 128 and 0 < cfg["registers"] <= 255
        assert cfg["smem_bytes"] <= 232448 and cfg["local_bytes"] <= 48


# --- the scan branch's decoupled kernels: pll_scan and agc_scan

@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 100])
@pytest.mark.parametrize("L", [1, 255, 257, 1500])
@pytest.mark.parametrize("lanes", ["warm", "cold", "mixed"])
@pytest.mark.parametrize("mode", ["poes", "argos"])
def test_decoupled_pll_scan_on_card(card, mode, lanes, L, B):
    """pll_scan against its plain version and its serial twin, bit for
    bit; each wrapper's launch counter moves by exactly one; the unlocked
    counts: 0 on warm lanes, at most L on any."""
    params, _, make = _mode(mode)
    z = make(B, L, 16, card)
    st = _lanes(params, B, lanes, card)
    unlocked = torch.full((B,), -1, dtype=torch.int32, device=card)
    counts = lambda: (pll_scan_kernel.launches, pll_scan_serial.launches)
    before = counts()
    got = pll_scan_kernel(params.pll, st, z, unlocked=unlocked)
    serial = pll_scan_serial(params.pll, st, z)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1]
    _equal(got, pll.pll_scan_ref(params.pll, st, *z))
    _equal(got, serial)
    n = unlocked.cpu()
    assert ((n >= 0) & (n <= L)).all()
    if lanes == "warm":
        assert (n == 0).all()


def _agc_input(kind, B, n, dev):
    """Noise whose level rises from 0.01 to 2 ("ramp": attack and decay
    both act) or from 1e-4 to 100 with a gain ceiling of 20 and a fast
    attack ("clamps": both clamps of the gain act)."""
    params = chain.make_params(POES_TIP, FS)
    rng = np.random.default_rng(n + B)
    if kind == "ramp":
        level = np.linspace(0.01, 2.0, n)
        p = sk.AGCParams(params.agc_attack, params.agc_decay)
    else:
        level = np.logspace(-4, 2, n)
        p = sk.AGCParams(0.5, 0.05, max_gain=20.0)
    x = (rng.standard_normal((B, n)) * level).astype(np.float32)
    return torch.from_numpy(x).to(dev), p


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 100])
@pytest.mark.parametrize("n", [1, 255, 257, 4500])
@pytest.mark.parametrize("kind", ["ramp", "clamps"])
def test_decoupled_agc_scan_on_card(card, kind, n, B):
    """agc_scan against its plain version and its serial twin, bit for
    bit; each wrapper's launch counter moves by exactly one."""
    x, p = _agc_input(kind, B, n, card)
    gain = torch.full((B,), 17.58, device=card)
    counts = lambda: (sk.agc_scan.launches, sk.agc_scan_serial.launches)
    before = counts()
    got = sk.agc_scan(gain, x, p)
    serial = sk.agc_scan_serial(gain, x, p)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1]
    _equal(got, sk.agc_scan_ref(gain, x, p))
    _equal(got, serial)


@pytest.mark.cuda
def test_scan_kernels_refuse_bad_input(card):
    """Each of the four wrappers raises on a wrong dtype or shape; the
    serial twins refuse CPU tensors."""
    params = chain.make_params(POES_TIP, FS)
    st = pll.init_state(params.pll, (4,), device=card)
    z = torch.zeros((4, 64), device=card)
    for f in (pll_scan_kernel, pll_scan_serial):
        with pytest.raises(TypeError):
            f(params.pll, st, (z.double(), z.double()))
        with pytest.raises(ValueError):
            f(params.pll, st, (z, z[:, :32]))
        with pytest.raises(ValueError):
            f(params.pll, st._replace(freq=st.freq[:3]), (z, z))
        with pytest.raises(TypeError):
            f(params.pll, st._replace(locked=st.phase), (z, z))
    with pytest.raises(ValueError):
        pll_scan_kernel(params.pll, st, (z, z), unlocked=torch.zeros(
            (3,), dtype=torch.int32, device=card))
    with pytest.raises(TypeError):
        pll_scan_kernel(params.pll, st, (z, z),
                        unlocked=torch.zeros((4,), device=card))
    gain = torch.full((4,), 17.58, device=card)
    p = sk.AGCParams(params.agc_attack, params.agc_decay)
    for f in (sk.agc_scan, sk.agc_scan_serial):
        with pytest.raises(TypeError):
            f(gain, z.double(), p)
        with pytest.raises(TypeError):
            f(gain.double(), z, p)
        with pytest.raises(ValueError):
            f(gain[:3], z, p)
    cpu = pll.init_state(params.pll, (4,), device="cpu")
    with pytest.raises(ValueError):
        pll_scan_serial(params.pll, cpu, (z.cpu(), z.cpu()))
    with pytest.raises(ValueError):
        sk.agc_scan_serial(gain.cpu(), z.cpu(), p)


@pytest.mark.cuda
def test_scan_launch_config_on_card(card):
    """What the card reports for pll_scan and agc_scan: one lane a CTA,
    256-sample chunks, 128 threads, static shared memory within 48 KB,
    and no local memory beyond the 48-byte frame of sinf/cosf's slow path
    (no spills)."""
    for cfg in (PK.launch_config(), sk.agc_launch_config()):
        assert cfg["lanes_per_cta"] == 1 and cfg["chunk"] == 256
        assert cfg["threads"] == 128 and 0 < cfg["registers"] <= 255
        assert 0 < cfg["smem_bytes"] <= 49152 and cfg["local_bytes"] <= 48


# --- the Gardner kernel: one lane a CTA, each window in shared memory

def _gardner_args(case, dev):
    """A case of tests/test_torch_gardner_order.py as tensors on dev."""
    f, i, x, t, n, p, lay = case
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (tuple(on(r) for r in f), tuple(on(r) for r in i), on(x), on(t),
            on(n), p, lay)


def _gardner_counts():
    return (sk.gardner_manchester.launches,
            sk.gardner_manchester_serial.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_gardner_window_kernel_cases_on_card(card, geometry, case):
    """gardner_manchester against its plain version and its serial twin,
    bit for bit, on the CPU model's cases (POES: one window buffer; ARGOS:
    two); one launch a call, the serial twin's count unmoved by it;
    contiguous lane-major outputs; the slots filled as inactive, lane by
    lane, as the CPU model counts them."""
    np_case = gardner_case(geometry, case)
    args = _gardner_args(np_case, card)
    B, lay = args[2].shape[0], args[-1]
    filled = torch.full((B,), -1, dtype=torch.int32, device=card)
    before = _gardner_counts()
    got = sk.gardner_manchester(*args, filled=filled)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_gardner_counts(), before)] == [1, 0]
    for a in got[2:]:
        assert a.shape == (B, lay.n_win * lay.spw) and a.is_contiguous()
    _equal(got, sk.gardner_manchester_ref(*args))
    _equal(got, sk.gardner_manchester_serial(*args))
    assert [a - b for a, b in zip(_gardner_counts(), before)] == [1, 1]
    _, model = gardner_order(*_gardner_args(np_case, "cpu"))
    assert torch.equal(filled.cpu().to(torch.int64), model["filled"])


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_gardner_window_kernel_matches_serial_over_many_windows_on_card(
        card, geometry):
    """61 lanes (not a multiple of a warp) over 12 windows, valid lengths
    from the whole row down to inside the first window, a carried state on
    every other lane: bit for bit against the serial twin."""
    B = 61
    f, i, x, t, n, p, lay = gardner_case(geometry, "carried", B=B, seed=3)
    n_win = 12
    x = np.tile(x, (1, -(-n_win // lay.n_win)))[:, :n_win * lay.window]
    t = np.tile(t, (1, -(-n_win // lay.n_win)))[:, :n_win * lay.window]
    lay = sk.layout(x.shape[1], lay.window, p.step_size, p.err_limit)
    f[:, 1::2] = 0.0
    i[:, 1::2] = 0
    n = (x.shape[1] * (1.0 - np.arange(B) / B)).astype(np.int32)
    args = _gardner_args((f, i, x, t, n, p, lay), card)
    got = sk.gardner_manchester(*args)
    want = sk.gardner_manchester_serial(*args)
    assert int(want[4].sum()) > 100 * B
    _equal(got, want)


@pytest.mark.cuda
def test_gardner_launch_config_on_card(card):
    """What the card reports for the unfused branches' layouts: one lane a
    CTA, 128 threads; POES (windows of 12,288 and 16 samples of margin)
    one window buffer and ARGOS two, within 72 KB of dynamic shared
    memory, so that three CTAs share an SM (352 lanes in one wave on 132
    SMs); no local memory (no spills)."""
    for geometry, buffers in (("poes", 1), ("argos", 2)):
        lay = gardner_case(geometry, "full", B=1)[-1]
        cfg = sk.gardner_launch_config(lay)
        assert cfg["lanes_per_cta"] == 1 and cfg["threads"] == 128
        assert cfg["buffers"] == buffers
        span = lay.window + lay.margin
        assert cfg["dynamic_smem_bytes"] >= buffers * span * 4
        assert cfg["dynamic_smem_bytes"] <= 72 * 1024
        assert cfg["ctas_per_sm"] >= 3
        assert 0 < cfg["registers"] <= 255 and cfg["local_bytes"] == 0


@pytest.mark.cuda
def test_gardner_kernels_refuse_bad_input(card):
    """Both wrappers raise on a wrong dtype, shape or layout and count no
    launch; the serial twin refuses CPU tensors; a window whose buffer
    exceeds an SM's shared memory is refused by the launch."""
    fs, ist, x, t, n, p, lay = _gardner_args(
        gardner_case("argos", "full", B=4), card)
    before = _gardner_counts()
    for f in (sk.gardner_manchester, sk.gardner_manchester_serial):
        with pytest.raises(TypeError):
            f(fs, ist, x.double(), t, n, p, lay)
        with pytest.raises(TypeError):
            f(fs, ist, x, t, n.long(), p, lay)
        with pytest.raises(ValueError):
            f(fs, ist, x[:, :-1], t, n, p, lay)
        with pytest.raises(ValueError):
            f(fs[:5], ist, x, t, n, p, lay._replace(n_win=lay.n_win + 1))
        with pytest.raises(ValueError):
            f((fs[0][:3],) + fs[1:], ist, x, t, n, p, lay)
    with pytest.raises(TypeError):
        sk.gardner_manchester(fs, ist, x, t, n, p, lay,
                              filled=torch.zeros((4,), device=card))
    cpu = _gardner_args(gardner_case("argos", "full", B=4), "cpu")
    with pytest.raises(ValueError):
        sk.gardner_manchester_serial(*cpu)
    huge = sk.layout(2 * 65536, 65536, p.step_size, p.err_limit)
    z = torch.zeros((4, 2 * 65536), device=card)
    with pytest.raises(RuntimeError):
        sk.gardner_manchester(fs, ist, z, z, n, p, huge)
    assert _gardner_counts() == before

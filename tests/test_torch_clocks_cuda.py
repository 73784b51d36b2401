"""The exact chain's other clock kernels against their plain PyTorch
versions, on the card: ``mm_manchester_scan``,
``upsampling_gardner_manchester_scan`` and
``upsampling_mm_manchester_scan``, each in float32 and in float64 (their
``_f64`` instances), at 1 and 5 lanes, from a fresh and from a carried
state, over full and ragged valid lengths, the upsampling Gardner mid-bit
pointer inside, before and past the image; each (the whole-image kernel)
also against its serial twin (``*_serial``) and on rings capped at 64 and
1,024 elements, the float64 POES images on the recycled ring the
kernel chooses; and three chunks of
``chain.chunk_step`` with each clock (``"mm"`` in both quirks modes, the
upsampling clocks without), float32 and float64, the kernels against the
plain versions on the same card.  Every output and state bit for bit.

Marked ``cuda``; skips without a card.  On a machine with one:

    python -m pytest tests/test_torch_clocks_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu_torch import chain
from project_desert_tortoise_tpu_torch.ops import pll, resample
from project_desert_tortoise_tpu_torch.ops.kernels import pll_kernel
from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
from project_desert_tortoise_tpu_torch.utils import config as TCFG
from project_desert_tortoise_tpu_torch.utils import synth, wav as W

FS = 50000.0
STEP = float(np.float32(FS * 3 / 8320.0))
CLOCKS = {"mm": (sk.mm_manchester_scan, sk.mm_manchester_scan_f64,
                 sk.mm_manchester_scan_ref),
          "upsampling_gardner": (sk.upsampling_gardner_manchester_scan,
                                 sk.upsampling_gardner_manchester_scan_f64,
                                 sk.upsampling_gardner_manchester_scan_ref),
          "upsampling_mm": (sk.upsampling_mm_manchester_scan,
                            sk.upsampling_mm_manchester_scan_f64,
                            sk.upsampling_mm_manchester_scan_ref)}


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


def clock_cfg(algorithm):
    """The JAX tests' configuration of a clock (tests/test_clock.py:118-121,
    tests/test_upsampling_clock.py:18-27)."""
    P = TCFG.POES_TIP
    if algorithm == "mm":
        return dataclasses.replace(P, gardner=dataclasses.replace(
            P.gardner, algorithm="mm", error_limit=3.0, gain=0.15))
    return dataclasses.replace(
        P, fir=TCFG.FIRConfig(cutoff_hz=11000.0, base_order=26,
                              target_rate_hz=None, interp=1),
        gardner=dataclasses.replace(
            P.gardner, algorithm=algorithm, upsample_level=4,
            upsample_kind="cubic", gain=1.0, error_limit=2.0))


def _image(B, cap, step, dev, dtype, seed):
    rng = np.random.default_rng(seed)
    x = np.empty((B, cap))
    for b in range(B):
        sym = rng.choice([-1.0, 1.0], int(cap / step) + 2)
        pos = (np.arange(cap) + rng.uniform(0, step)) / step
        x[b] = sym[pos.astype(int)] + 0.1 * rng.standard_normal(cap)
    return torch.tensor(x, dtype=dtype, device=dev)


def _clock_args(algorithm, dtype, start, B, dev):
    """A clock kernel's arguments at B lanes of one POES chunk's image: a
    fresh or a carried state, ragged final chunks on every other lane, the
    upsampling Gardner mid-bit pointer past, inside and before the image on
    lanes 1-3."""
    if algorithm == "mm":
        cap = 30016
        x = _image(B, cap, STEP, dev, dtype, B)
        p = sk.mm_params(150000.0, 8320.0, 3.0, 0.15, 0.4)
        rows = ([0.0, STEP, 0.0] if start == "fresh"
                else [3.4, STEP * 1.0007, 0.8])
        msyms = chain.max_symbols(cap, STEP)
    else:
        cap0 = 10016
        x = resample.upsample(_image(B, cap0, STEP / 3, dev, dtype, B), 4,
                              "cubic").contiguous()
        cap = x.shape[1]
        p = sk.upsampling_params(STEP / 3 * 4, 2.0, 1.0, 0.4)
        msyms = chain.max_symbols(cap0, STEP / 3)
        half = {"fresh": [64.0, 0.0], "carried": [-7.0, 0.86]}[start]
        if algorithm == "upsampling_gardner":
            rows = ([64.0, 0.0] if start == "fresh" else [61.0, 0.37]) \
                + half + [0.0 if start == "fresh" else -0.6]
        else:
            rows = ([64.0, 0.0, 0.0] if start == "fresh"
                    else [63.0, 0.51, 0.9])
    man = [0.0, 0.0, 0.0] if start == "fresh" else [0.9, -0.8, 0.7]
    fstate = [torch.full((B,), float(v), dtype=dtype, device=dev)
              for v in rows + man]
    if algorithm == "upsampling_gardner" and B > 1:
        fstate[2][1:] = torch.tensor([cap + 3.0, 20.0, -1.0, 5.0][:B - 1],
                                     dtype=dtype)   # mid-bit past, inside,
    fstate = tuple(fstate)                          # and before the image
    istate = (torch.zeros(B, dtype=torch.int32, device=dev),
              torch.full((B,), int(start == "carried"), dtype=torch.int32,
                         device=dev))
    t = (torch.arange(1, cap + 1, device=dev, dtype=dtype) / FS).expand(
        B, cap).contiguous()
    n = torch.full((B,), cap, dtype=torch.int32, device=dev)
    n[::2] = cap - 3 * 1111                          # ragged final chunks
    return (fstate, istate, x, t, n, p, msyms)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("start", ["fresh", "carried"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("algorithm", list(CLOCKS))
def test_clock_kernel_matches_plain_on_card(card, algorithm, dtype, start,
                                            B):
    f32, f64, ref = CLOCKS[algorithm]
    args = _clock_args(algorithm, dtype, start, B, card)
    msyms = args[-1]
    wrapper = f64 if dtype == torch.float64 else f32
    before = wrapper.launches
    got = f32(*args)              # the float32 wrapper routes float64
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = ref(*args)
    _equal(got, want)
    count = got[-1]
    assert int(count.min()) > 0 and int(count.max()) < msyms


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("start", ["fresh", "carried"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("algorithm", list(CLOCKS))
def test_whole_image_clock_matches_plain_and_serial_on_card(
        card, algorithm, dtype, start, B):
    """The whole-image kernel under each clock, on the
    ring it chooses (float32: the image resident; float64: 16 tiles
    recycled) and on rings capped at 64 and 1,024 elements, against the
    plain version and the serial twin, bit for bit."""
    f32, _, ref = CLOCKS[algorithm]
    suffix = "_f64" if dtype == torch.float64 else ""
    twin = getattr(sk, f"{algorithm}_manchester_scan{suffix}_serial")
    args = _clock_args(algorithm, dtype, start, B, card)
    B, cap = args[2].shape
    want = ref(*args)
    before = twin.launches
    _equal(twin(*args), want)
    assert twin.launches == before + 1
    for ring_floats in (0, 64, 1024):
        cfg = sk.clock_scan_launch_config(algorithm, B, cap, ring_floats,
                                          dtype=dtype)
        assert cfg["resident"] == (ring_floats == 0
                                   and dtype == torch.float32)
        assert cfg["local_bytes"] == 0 and cfg["ctas_per_sm"] >= 1
        got = f32(*args, ring_floats=ring_floats)
        torch.cuda.synchronize()
        _equal(got, want)
        assert torch.equal(got[-1], got[4].sum(1, dtype=torch.int32))


def _plain_kernels(monkeypatch):
    """The exact chain's kernel wrappers, as chain.chunk_step reaches them,
    replaced by their plain versions."""
    monkeypatch.setattr(pll_kernel, "pll_scan_kernel",
                        lambda p, s, z, **_: pll.pll_scan_ref(p, s, *z))
    monkeypatch.setattr(sk, "agc_scan", sk.agc_scan_ref)
    for name, (f32, _, ref) in CLOCKS.items():
        monkeypatch.setattr(sk, f32.__name__, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("algorithm,quirks", [
    ("mm", True), ("mm", False), ("upsampling_gardner", False),
    ("upsampling_mm", False)])
def test_chunk_step_clocks_match_plain_on_card(card, algorithm, quirks,
                                               dtype, monkeypatch):
    cfg = dataclasses.replace(clock_cfg(algorithm), dtype=dtype)
    dt = cfg.np_dtype()
    params = chain.make_params(cfg, FS, quirks=quirks)
    iq, _ = synth.make_poes_recording(n_frames=3, fs=FS)
    iq = (iq / (np.abs(iq).max() * 1.2)).astype(
        np.complex128 if dt == np.float64 else np.complex64)
    t = W.time_axis(len(iq), FS, dt)
    t_ext = np.concatenate([t, [t[-1] + dt.type(1.0) / dt.type(FS)]])
    chunk, a0 = 4000, int(0.3 * FS)

    def run():
        state = chain.init_state(params, 17.58, chunk, device=card,
                                 dtype=getattr(torch, dtype))
        outs = []
        for k, n in enumerate((chunk, chunk, chunk * 5 // 8)):
            a = a0 + k * chunk
            planes = [torch.from_numpy(np.ascontiguousarray(v)).to(card)
                      for v in (iq[a:a + n].real, iq[a:a + n].imag,
                                t[a:a + n], t_ext[a + 1:a + n + 1])]
            state, out = chain.chunk_step(params, state, *planes)
            outs.append(out)
        return state, outs
    f32, f64, _ = CLOCKS[algorithm]
    wrapper = f64 if dtype == "float64" else f32
    before = wrapper.launches
    got = run()
    assert wrapper.launches == before + 3
    with monkeypatch.context() as m:
        _plain_kernels(m)
        want = run()
    _equal(got, want)
    assert sum(int(o.bit_mask.sum()) for o in got[1]) > 0


@pytest.mark.cuda
def test_clock_kernels_refuse_bad_params(card):
    x = torch.zeros((2, 300), device=card)
    n = torch.full((2,), 300, dtype=torch.int32, device=card)
    f = tuple(torch.zeros(2, device=card) for _ in range(6))
    i = tuple(torch.zeros(2, dtype=torch.int32, device=card)
              for _ in range(2))
    bad = sk.upsampling_params(24.0, 2.0, 1.0, 0.4)   # 7 values, not 4
    with pytest.raises(RuntimeError, match="CUDA error"):
        sk.mm_manchester_scan(f, i, x, x, n, bad, 30)

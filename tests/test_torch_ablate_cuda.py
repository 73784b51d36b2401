"""The staged ``ablate_fused`` kernel against its plain PyTorch version and
its serial twin (``ablate_fused_serial``), on the card: every variant at
128 and 4,224 lanes, over a run that is not a whole number of 48-step
chunks with a window that does not divide a chunk, from the tool's state
and from one with Gardner's pointers far behind and past the ring; a run
shorter than the rings; Manchester parities outside [0, 2) (against the
plain version only: there the serial twin's fmodf keeps the dividend's
sign, torch.remainder the divisor's); the launch configuration; lane
counts that leave the last CTA part full, on planes that are not 16-byte
aligned.  Every output and state bit for bit.
``tests/test_torch_ablate_order.py`` models the kernel's order on the CPU.

Marked ``cuda``; skips without a card.  On a machine with one:

    python -m pytest tests/test_torch_ablate_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from project_desert_tortoise_tpu_torch.tools import ablate_fused as AF

NS_ROW, HALF_ROW = 6 + 26 + 1 + 2 * AF.RING, 6 + 26 + 2 + 2 * AF.RING


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _case(case, S, dev):
    """(re, im, tn, state, window): the tool's inputs at S x 128 lanes;
    "pointers": Gardner's next-sample pointer far behind on lanes 1 and 3,
    the mid-bit pointer negative on lane 1 and past the ring on lane 2."""
    steps, window = {"ragged": (300, 100), "pointers": (300, 50),
                     "parity": (300, 50), "short": (4, 2)}[case]
    xs, state = AF.inputs(steps, S, dev)
    if case == "pointers":
        state[NS_ROW, 1] = -1000.0
        state[HALF_ROW, 1] = -7.0
        state[HALF_ROW, 2] = 500.0
        state[NS_ROW, 3] = -60.0
    if case == "parity":                          # evenodd
        state[NS_ROW + 4, :4] = torch.tensor([-3.25, 6.5, -1.0, -2.0])
    return (*xs, state, window)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "pointers"])
@pytest.mark.parametrize("S", [1, 33])
@pytest.mark.parametrize("name", list(AF.VARIANTS))
def test_staged_ablation_matches_plain_and_serial_on_card(card, name, S,
                                                         case):
    args = _case(case, S, card)
    want = AF.ablate_fused_ref(name, *args)
    before = AF.ablate_fused.launches, AF.ablate_fused_serial.launches
    got = AF.ablate_fused(name, *args)
    twin = AF.ablate_fused_serial(name, *args)
    torch.cuda.synchronize()
    assert (AF.ablate_fused.launches, AF.ablate_fused_serial.launches) == (
        before[0] + 1, before[1] + 1)
    _equal(got, want)
    _equal(twin, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(AF.VARIANTS))
def test_staged_ablation_shorter_than_the_rings_on_card(card, name):
    args = _case("short", 1, card)
    state = args[3]
    state[6:6 + 26] = torch.linspace(-1, 1, 26, device=card)[:, None]
    state[6 + 27:6 + 27 + 2 * AF.RING] = torch.linspace(
        -2, 2, 2 * AF.RING, device=card)[:, None]
    _equal(AF.ablate_fused(name, *args), AF.ablate_fused_ref(name, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(AF.VARIANTS))
def test_staged_ablation_parity_outside_its_range_on_card(card, name):
    args = _case("parity", 1, card)
    _equal(AF.ablate_fused(name, *args), AF.ablate_fused_ref(name, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(AF.VARIANTS))
def test_staged_ablation_launch_config(card, name):
    cfg = AF.ablate_fused_launch_config(name)
    assert (cfg["lanes_per_cta"], cfg["chunk_steps"], cfg["threads"],
            cfg["fir_warps"]) == (AF.CTA_LANES, 48, 256, 4)
    warps = [cfg["pll_warp"], cfg["agc_warp"], cfg["gardner_warp"],
             cfg["loader_warp"]] + [w for w in range(8)
                                    if cfg["fir_warp_mask"] >> w & 1]
    assert sorted(warps) == list(range(8))
    assert cfg["ctas_per_sm"] >= 1 and 0 < cfg["registers"] <= 255
    assert 48 * 1024 < cfg["smem_bytes"] <= 227 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [100, 97, 5])
@pytest.mark.parametrize("name", list(AF.VARIANTS))
def test_staged_ablation_partial_cta_on_card(card, name, lanes):
    """Lane counts that leave the last CTA part full (97 and 5 also
    misalign every row but the first): staged kernel and twin against the
    plain version, over a run of whole and partial chunks."""
    re, im, tn, state, window = _case("pointers", 1, card)
    args = (re[:, :lanes], im[:, :lanes], tn[:, :lanes], state[:, :lanes],
            window)
    want = AF.ablate_fused_ref(name, *args)
    _equal(AF.ablate_fused(name, *args), want)
    _equal(AF.ablate_fused_serial(name, *args), want)

"""The staged ``ablate_kernel`` kernel against its plain PyTorch version and
its serial twin (``ablate_kernel_serial``), on the card: every variant at
128 and 4,224 lanes and at 100 and 4,200 (the last CTA part full, its rows
4-byte copies), over a run that is not a whole number of 256-step chunks,
on the tool's inputs and on seeded varied ones (``varied_inputs``: ring16's
ages at 0, 15 and both clamps; a PLL run in which lanes lock); a run
shorter than a chunk; the launch configuration.  Every output and the
final carry bit for bit.  ``tests/test_torch_ablate_kernel_order.py``
models the kernel's order on the CPU.

Marked ``cuda``; skips without a card.  On a machine with one:

    python -m pytest tests/test_torch_ablate_kernel_cuda.py -m cuda \\
        --noconftest -q
"""

import pytest
import torch

from project_desert_tortoise_tpu_torch.tools import ablate_kernel as AK


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal(got, want):
    (outs, st), (w_outs, w_st) = got, want
    assert len(outs) == len(w_outs)
    for a, b in zip(outs + [st], w_outs + [w_st]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _case(name, inputs, lanes, steps, dev):
    if inputs == "tool":
        ins, state = AK.inputs(name, steps, -(-lanes // AK.LANES), dev)
        return [ins[0][:, :lanes].contiguous()], state[:, :lanes].contiguous()
    return AK.varied_inputs(name, steps, lanes, seed=lanes, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["tool", "varied"])
@pytest.mark.parametrize("lanes", [128, 4224, 100, 4200])
@pytest.mark.parametrize("name", list(AK.VARIANTS))
def test_staged_kernel_matches_plain_and_serial_on_card(card, name, lanes,
                                                        inputs):
    steps, window = 800, 160
    ins, state = _case(name, inputs, lanes, steps, card)
    want = AK.ablate_kernel_ref(name, ins, state, window)
    before = AK.ablate_kernel.launches, AK.ablate_kernel_serial.launches
    got = AK.ablate_kernel(name, ins, state, window)
    twin = AK.ablate_kernel_serial(name, ins, state, window)
    torch.cuda.synchronize()
    assert (AK.ablate_kernel.launches, AK.ablate_kernel_serial.launches) == (
        before[0] + 1, before[1] + 1)
    _equal(got, want)
    _equal(twin, want)
    if name == "pll" and inputs == "varied":
        locked0, locked1 = state[5] > 0.5, got[1][5] > 0.5
        assert (~locked0 & locked1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [128, 100])
@pytest.mark.parametrize("name", list(AK.VARIANTS))
def test_staged_kernel_shorter_than_a_chunk_on_card(card, name, lanes):
    ins, state = AK.varied_inputs(name, 50, lanes, seed=3, device=card)
    _equal(AK.ablate_kernel(name, ins, state, 25),
           AK.ablate_kernel_ref(name, ins, state, 25))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(AK.VARIANTS))
def test_staged_kernel_launch_config(card, name):
    cfg = AK.ablate_kernel_launch_config(name)
    staged = not name.startswith("empty")
    assert cfg["lanes_per_cta"] == AK.CTA_LANES
    assert cfg["chunk_steps"] == (AK.CHUNK_STEPS if staged else 0)
    warps = cfg["threads"] // 32
    roles = [w for w in range(warps)
             if (cfg["chain_warp_mask"] | cfg["b_warp_mask"]) >> w & 1]
    if staged:
        roles.append(cfg["loader_warp"])
    assert sorted(roles) == list(range(warps))
    assert cfg["b_warp_mask"] == (0b110 if name in ("pll", "ring16") else 0)
    assert cfg["ctas_per_sm"] >= 1 and 0 < cfg["registers"] <= 255
    assert cfg["local_bytes"] <= 64 and cfg["smem_bytes"] <= 227 * 1024

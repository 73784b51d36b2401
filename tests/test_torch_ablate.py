"""The port's ablation tools (``project_desert_tortoise_tpu_torch/tools``)
against the JAX package's (``tools/ablate_kernel.py``,
``tools/ablate_fused.py``), variant by variant, on the CPU.

Each JAX tool is loaded from its path and driven through its own ``main()``
with ``--steps 128 --window 64 --only NAME``; ``pallas_call`` is wrapped so
that it runs in interpret mode and keeps the kernel's inputs and outputs,
and ``jax.jit`` is the identity.  The port's inputs must equal the JAX
tool's, and its plain version (the CPU side of each tool's wrapper) run on
them must give the JAX kernel's outputs:

- exactly, where the body has no sin/cos and no multiply feeding an add;
- within 2e-5 where the PLL's sin/cos enter (the envelope of
  tests/test_torch_fused.py; XLA's sin/cos differ from PyTorch's by an ulp
  now and then), with identical emit decisions;
- ``acc * 1.0001 + x`` (mac26, mac78) and the FIR/AGC multiply-adds: XLA on
  the CPU contracts each into one fused multiply-add, while the port and
  its CUDA kernel (``-fmad=false``) round the product first.  Both sides
  are held exactly to a numpy model of their own rounding, and to each
  other within the float32 rounding that the contraction moves.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

from project_desert_tortoise_tpu_torch.tools import ablate_fused as AF
from project_desert_tortoise_tpu_torch.tools import ablate_kernel as AK

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
STEPS, WINDOW = 128, 64


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_kernel(monkeypatch):
    """Runs a JAX tool's main() for one variant; returns the (inputs,
    outputs) of its first kernel call as numpy arrays."""
    real = pl.pallas_call
    calls = []

    def spy(kernel, **kw):
        f = real(kernel, interpret=True, **kw)

        def run(*args):
            out = f(*args)
            calls.append(([np.asarray(a) for a in args],
                          [np.asarray(o) for o in out]))
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", spy)
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)

    def drive(tool, name):
        calls.clear()
        monkeypatch.setattr("sys.argv", [tool, "--steps", str(STEPS),
                                         "--window", str(WINDOW),
                                         "--only", name])
        _jax_tool(tool).main()
        assert calls, f"the JAX tool ran no kernel for {name}"
        return calls[0]
    return drive


def _lanes(a):
    """(n, S, 128) JAX planes -> (n, S*128)."""
    return a.reshape(a.shape[0], -1)


def _mac_model(state, x, n_mac, fused: bool):
    """acc = acc * 1.0001 + x over the steps, in numpy: the product rounded
    to float32 first (fused=False) or the multiply-add rounded once."""
    acc = state[0].astype(np.float32)
    k = np.float32(1.0001)
    for xi in x:
        for _ in range(n_mac):
            if fused:
                acc = (acc.astype(np.float64) * np.float64(k)
                       + xi.astype(np.float64)).astype(np.float32)
            else:
                acc = (acc * k).astype(np.float32) + xi
    return acc


@pytest.mark.parametrize("name", list(AK.VARIANTS))
def test_ablate_kernel_matches_jax(jax_kernel, name):
    (j_in, j_out) = jax_kernel("ablate_kernel", name)
    v = AK.VARIANTS[name]
    ins, state = AK.inputs(name, STEPS, 1, "cpu")
    assert len(j_in) == v.n_in + 1 and len(j_out) == v.n_out + 1
    for a, b in zip(ins + [state], j_in):
        assert np.array_equal(a.numpy(), _lanes(b))
    outs, st = AK.ablate_kernel(name, ins, state, WINDOW)
    got = [o.numpy() for o in outs] + [st.numpy()]
    want = [_lanes(o) for o in j_out]
    if name.startswith("mac"):
        n_mac = int(name[3:])
        x = ins[0].numpy()
        assert np.array_equal(got[0][0], _mac_model(state.numpy(), x, n_mac,
                                                    fused=False))
        assert np.array_equal(want[0][0], _mac_model(state.numpy(), x, n_mac,
                                                     fused=True))
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    elif name == "pll":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=2e-5)
    else:
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("name", list(AF.VARIANTS))
def test_ablate_fused_matches_jax(jax_kernel, name):
    (j_in, j_out) = jax_kernel("ablate_fused", name)
    xs, state = AF.inputs(STEPS, 1, "cpu")
    assert state.shape[0] == 73
    for a, b in zip(xs + [state], j_in):
        assert np.array_equal(a.numpy(), _lanes(b))
    got = [o.numpy() for o in AF.ablate_fused(name, *xs, state, WINDOW)]
    want = [_lanes(o) for o in j_out]
    if "store" not in AF.VARIANTS[name]:    # each window's first step only
        rows = slice(None, None, WINDOW)
        got[:3] = [g[rows] for g in got[:3]]
        want[:3] = [w[rows] for w in want[:3]]
    assert np.array_equal(got[2], want[2])          # emit decisions
    if name == "none":
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    else:   # no_pll: the FIR/AGC multiply-adds are XLA's only difference
        tol = 1e-5 if name == "no_pll" else 2e-5
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


def test_window_must_divide_steps():
    ins, state = AK.inputs("empty_c1", 100, 1, "cpu")
    with pytest.raises(ValueError, match="window"):
        AK.ablate_kernel("empty_c1", ins, state, 64)
    xs, st = AF.inputs(100, 1, "cpu")
    with pytest.raises(ValueError, match="window"):
        AF.ablate_fused("none", *xs, st, 64)


@pytest.mark.parametrize("tool", [AK, AF])
def test_cli_on_cpu(tool, capsys):
    assert tool.main(["--steps", "64", "--window", "32", "--only", "none"
                      if tool is AF else "store3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ns/step (cpu, plain version)" in out and out.count("\n") == 1

"""The staged ``ablate_kernel`` kernel's order of evaluation, modelled on the
CPU in chunks with their carries, against the plain version
``ablate_kernel_ref`` bit for bit (``torch.equal``), for each of the eight
variants; and the ``pll`` and ``ring16`` variants on the same varied inputs
against the JAX tool's kernel (``tools/ablate_kernel.py``) in interpret
mode.

``csrc/ablate_kernel.cu`` gives a CTA 32 lanes, one a thread of each warp.
The empty variants read nothing: their carried values are split over four
warps (one for ``empty_c1``), each warp's share in its registers.  The
others walk their steps in chunks of 256 (:data:`K`).  At tick u the loader
copies chunk u + 1's input rows into one of three buffers; the two B warps
compute chunk u's terms into one of two buffers, the steps of rank r those
with k % 2 == r (``pll``: the sample phase and the normalised sample;
``ring16``: the age); the chain warp runs chunk u - 1 (chunk u for the
``mac`` variants, which have no B): the multiply-adds, the PLL step from
B's terms, or the ring in 16 registers (step j's value in slot j & 15,
the value at the age read by a tree of selects on the bits of the age
minus 1, the newest value entering the last select); ``store3``'s four
store warps write chunk u's three output rows from the staged ones, warp
r rows 4r..4r + 3 of every 16 (16 bytes a thread) or, in a part-full CTA,
rows r, r + 4, ... (a lane a thread).  The stages of a tick run at
once, so :func:`staged_order` records every row each stage reads and
writes in a tick and fails if two stages touch one row and one of them
writes it (``Tick``, shared with ``tests/test_torch_ablate_order.py``);
every buffer reads NaN from its recycling until its writer fills it.  A
CTA's lanes past B run on lane B - 1's inputs and are dropped.

Cases, each checked to reach what it names: L not a multiple of K with a
window that does not divide K; L shorter than one chunk; the tool's inputs;
seeded inputs in [-3, 20] (``varied_inputs``: ring16's ages 0 and 15 and
both clamps; for ``pll`` a run in which ``locked`` goes from 0 to 1); 40
lanes (a part-full CTA).  The card tests
(``tests/test_torch_ablate_kernel_cuda.py``) hold the kernel to the plain
version and its serial twin.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.tools import ablate_kernel as AK
from test_torch_ablate_order import Tick

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]

K = 256                    # kChunk
X_BUFS = 3
RING = AK.RING
B_WARPS = 2
STORE_WARPS = 4
LANES = 32                 # a CTA's
NAN = float("nan")


def _pad(t, B):
    """Lanes padded to whole CTAs with lane B - 1's values (dim 1)."""
    n = -(-B // LANES) * LANES
    return torch.cat([t, t[:, -1:].expand(-1, n - B)], 1) if n > B else t


def _empty(name, state, L, counts):
    """The empty variants: each warp's share of the carried values."""
    n, eps = state.shape[0], torch.tensor(np.float32(1e-6))
    warps = 1 if n == 1 else 4
    owner = {}
    for w in range(warps):
        k0 = w * (n // warps) + min(w, n % warps)
        for k in range(k0, k0 + n // warps + (w < n % warps)):
            assert k not in owner, f"rows {k} on warps {owner[k]} and {w}"
            owner[k] = w
    assert sorted(owner) == list(range(n))
    counts["warps"] = warps
    counts["values_per_warp"] = sorted(
        {list(owner.values()).count(w) for w in range(warps)})
    rows = list(state.unbind(0))
    for _ in range(L):
        rows = [r + eps for r in rows]
    return [], torch.stack(rows)


def staged_order(name, ins, state, window: int):
    """ablate_kernel's results in the staged kernel's order; returns them
    and the counts of what the run reached."""
    v = AK.VARIANTS[name]
    x_all = ins[0]
    L, B = x_all.shape
    AK.check_window(L, window)
    counts = {}
    if name.startswith("empty"):
        return (*_empty(name, state, L, counts), counts)
    x_all, state = _pad(x_all, B), _pad(state, B)
    Bp = x_all.shape[1]
    f32 = torch.float32
    full = lambda val: torch.full((Bp,), float(np.float32(val)), dtype=f32)
    lag = 1 if name in ("pll", "ring16") else 0
    n_chunks = -(-L // K)
    ln = lambda c: min(K, L - c * K)
    nan = lambda: torch.full((K, Bp), NAN, dtype=f32)
    xb = [nan() for _ in range(X_BUFS)]
    term_rows = {"pll": 2, "ring16": 1}.get(name, 0)
    terms = [[nan() for _ in range(term_rows)] for _ in range(2)]
    out = torch.zeros((v.n_out, L, Bp), dtype=f32)
    counts.update(ages=torch.zeros(RING, dtype=torch.int64), clamped_low=0,
                  clamped_high=0, chunks=n_chunks)
    carry = list(state.unbind(0))
    if name == "pll":
        k_pll = pll_ops.loop_consts(AK.pll_params(), state[0])
        pll_s = pll_ops.PLLState(*carry[:5], locked=carry[5] > full(0.5))
    if name == "ring16":
        q = [carry[RING - 1 - k] for k in range(RING)]   # slot (-1 - k) & 15

    def load(tk, c):
        buf = xb[c % X_BUFS]
        buf[:] = NAN
        buf[:ln(c)] = x_all[c * K:c * K + ln(c)]
        tk.wr("load", ("x", c % X_BUFS), range(K))

    load(Tick(), 0)                      # before the first tick

    def stage_b(tk, c):
        xs, ts = xb[c % X_BUFS], terms[c & 1]
        for t in ts:
            t[:] = NAN
        for r in range(B_WARPS):
            rows = range(r, ln(c), B_WARPS)
            for k in rows:
                if name == "pll":
                    sp, rx, _ = pll_ops.input_terms(xs[k], xs[k])
                    ts[0][k], ts[1][k] = sp, rx
                else:
                    ts[0][k] = torch.clamp(xs[k].to(torch.int32), 0,
                                           RING - 1).to(f32)
            tk.rd(f"B{r}", ("x", c % X_BUFS), rows)
            for j in range(term_rows):
                tk.wr(f"B{r}", ("terms", c & 1, j), rows)

    def chain(tk, c):
        nonlocal carry, pll_s
        xs, ts, j0, n = xb[c % X_BUFS], terms[c & 1], c * K, ln(c)
        tk.rd("chain", ("x", c % X_BUFS), range(n))
        for j in range(term_rows):
            tk.rd("chain", ("terms", c & 1, j), range(n))
        if name.startswith("mac"):
            mac, acc = full(1.0001), carry[0]
            for k in range(n):
                for _ in range(int(name[3:])):
                    acc = acc * mac + xs[k]
            carry = [acc]
        elif name == "pll":
            for k in range(n):
                x = xs[k]
                pll_s, (soft, _) = pll_ops.step_with_terms(
                    k_pll, pll_s, x, x, ts[0][k], ts[1][k], ts[1][k])
                out[0, j0 + k] = soft
        else:                                           # ring16
            age = ts[0].to(torch.int64)
            for k in range(n):
                counts["ages"] += torch.bincount(age[k], minlength=RING)
                r = (j0 + k) % RING                  # the step's slot
                m = age[k] - 1                       # the tree's index
                level = [q[(r - 2 - i) % RING] for i in range(RING)]
                for bit in range(4):
                    odd = (m >> bit) & 1 == 1
                    level = [torch.where(odd, level[2 * i + 1], level[2 * i])
                             for i in range(len(level) // 2)]
                newest = q[(r - 1) % RING]
                q[r] = xs[k] + torch.where(age[k] == 0, newest, level[0])

    def stores(tk, c):
        xs, j0, n = xb[c % X_BUFS], c * K, ln(c)
        wide = B % LANES == 0
        for r in range(STORE_WARPS):
            if wide:                   # 8 vectors a row, 16 rows a pass
                rows = [k for k in range(n) if (k % 16) // 4 == r]
            else:
                rows = list(range(r, n, STORE_WARPS))
            tk.rd(f"S{r}", ("x", c % X_BUFS), rows)
            tk.wr(f"S{r}", ("out", c), rows)
            for k in rows:
                y = xs[k] + carry[0]
                out[0, j0 + k], out[1, j0 + k] = y, y * full(2.0)
                out[2, j0 + k] = y * full(3.0)

    for u in range(n_chunks + lag):
        tk = Tick()
        if u + 1 < n_chunks:
            load(tk, u + 1)
        if lag and u < n_chunks:
            stage_b(tk, u)
        if name == "store3":
            stores(tk, u)
        elif 0 <= u - lag < n_chunks:
            chain(tk, u - lag)
        tk.check(u)

    if name == "pll":
        carry = [*pll_s[:5], pll_s.locked.to(f32)]
    elif name == "ring16":
        carry = [q[(L - 1 - k) % RING] for k in range(RING)] + carry[RING:]
        counts["clamped_low"] = int((x_all < 0).sum())
        counts["clamped_high"] = int((x_all >= RING).sum())
    return ([o[:, :B] for o in out.unbind(0)], torch.stack(carry)[:, :B],
            counts)


def ablate_case(name, case):
    """(ins, state, window) on the CPU: the tool's inputs or seeded varied
    ones (varied_inputs), at 128 lanes or 40 (a part-full CTA)."""
    steps, window, lanes = {"ragged": (800, 160, 128),
                            "short": (50, 25, 128),
                            "tool": (300, 100, 128),
                            "lanes40": (300, 60, 40)}[case]
    if case == "tool":
        ins, state = AK.inputs(name, steps, 1, "cpu")
        return ins, state, window
    ins, state = AK.varied_inputs(name, steps, lanes, seed=7)
    return ins, state, window


@pytest.mark.parametrize("case", ["ragged", "short", "tool", "lanes40"])
@pytest.mark.parametrize("name", list(AK.VARIANTS))
def test_staged_order_matches_plain(name, case):
    ins, state, window = ablate_case(name, case)
    outs, st, counts = staged_order(name, ins, state, window)
    w_outs, w_st = AK.ablate_kernel_ref(name, ins, state, window)
    assert len(outs) == len(w_outs)
    for a, b in zip(outs + [st], w_outs + [w_st]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    L = ins[0].shape[0]
    if case == "ragged":                       # what the case names
        assert L % K and K % window and counts.get("chunks", 4) == 4
    if case == "short":
        assert L < K
    if name.startswith("empty"):
        n = state.shape[0]
        assert counts["values_per_warp"] == {1: [1], 8: [2],
                                             73: [18, 19]}[n]
    if name == "ring16" and case in ("ragged", "lanes40"):
        ages = counts["ages"]
        assert ages[0] > 0 and ages[RING - 1] > 0 and (ages > 0).all()
        assert counts["clamped_low"] > 0 and counts["clamped_high"] > 0
    if name == "pll" and case not in ("tool", "short"):
        locked0, locked1 = state[5] > 0.5, st[5] > 0.5
        assert (~locked0 & locked1).any() and (~locked1).any()
        assert not (locked0 & ~locked1).any()


def test_serial_twin_refuses_cpu_tensors():
    ins, state, window = ablate_case("store3", "short")
    before = AK.ablate_kernel_serial.launches
    with pytest.raises(ValueError, match="CUDA device only"):
        AK.ablate_kernel_serial("store3", ins, state, window)
    assert AK.ablate_kernel_serial.launches == before


@pytest.mark.parametrize("name", ["empty_c1", "store3"])
def test_tensors_on_two_devices_are_refused(name):
    """A plane on another device than the carry is refused, not run on the
    plain version (which reads no plane in the empty variants)."""
    ins, state, window = ablate_case(name, "short")
    with pytest.raises(ValueError, match="not on one device"):
        AK.ablate_kernel(name, [ins[0].to("meta")], state, window)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "_jax_tool_ablate_kernel", REPO / "tools" / "ablate_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["pll", "ring16"])
def test_varied_inputs_match_jax(monkeypatch, name):
    """The JAX tool's kernel for `name`, in interpret mode, on the varied
    inputs at 128 lanes instead of its own ones: ring16 exactly; pll with
    the same lock decisions, its state within 2e-5 (XLA's sin/cos differ
    from PyTorch's by an ulp now and then; the envelope of
    tests/test_torch_ablate.py) and its soft output, the sample times the
    carrier's sine and cosine, within 2e-5 times the sample's magnitude
    (up to 20 here, 1 there)."""
    steps, window = 240, 60
    ins, state = AK.varied_inputs(name, steps, AK.LANES, seed=11)
    real = pl.pallas_call
    got = []

    def spy(kernel, **kw):
        f = real(kernel, interpret=True, **kw)

        def run(*args):       # the tool's timed calls repeat the first
            assert [a.shape for a in args] == [
                (steps, 1, 128), (state.shape[0], 1, 128)]
            if not got:
                got.append(f(ins[0].numpy()[:, None], state.numpy()[:, None]))
            return got[0]
        return run

    monkeypatch.setattr(pl, "pallas_call", spy)
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    monkeypatch.setattr("sys.argv", ["ablate_kernel", "--steps", str(steps),
                                     "--window", str(window), "--only", name])
    _jax_tool().main()
    assert got, f"the JAX tool ran no kernel for {name}"
    want = [np.asarray(o).reshape(o.shape[0], -1) for o in got[0]]
    outs, st = AK.ablate_kernel(name, ins, state, window)
    mine = [o.numpy() for o in outs] + [st.numpy()]
    assert len(mine) == len(want)
    if name == "ring16":
        for a, b in zip(mine, want):
            assert np.array_equal(a, b)
    else:
        assert np.array_equal(mine[-1][5], want[-1][5])       # locked
        assert (state[5].numpy() < 0.5).any() and (mine[-1][5] > 0.5).any()
        np.testing.assert_allclose(mine[1], want[1], atol=2e-5)
        scale = np.maximum(np.abs(ins[0].numpy()), 1.0)
        assert (np.abs(mine[0] - want[0]) <= 2e-5 * scale).all()

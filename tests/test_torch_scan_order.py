"""The scan branch's decoupled kernels, ``pll_scan`` and ``agc_scan``: their
order of evaluation, modelled on the CPU, against the plain versions
``pll_scan_ref`` and ``agc_scan_ref`` bit for bit (``torch.equal``), and
the same inputs through the JAX package.

``csrc/pll_kernel.cu`` runs stages A, B and M of ``csrc/front_stages.cuh``
alone over chunks of a lane's samples (A: the phase recurrence, the whole
PLL step while a lane is unlocked; B: the step's feed-forward terms from
A's phases; M: the two EMAs); ``csrc/scan_kernels.cu``'s AGC runs stage D
alone (the gain over a chunk of inputs in order).  The models are the
stage functions of ``tests/test_torch_fused_order.py`` over chunks of K =
64 samples; L = 1, 63 and 1,000 (not multiples of K); warm (locked) lanes,
cold lanes (``pll.init_state``), cold lanes whose lock signal sits just
under its threshold (they lock within a chunk), and batches that mix them.

Against JAX (``pll_scan_pallas(interpret=True)``, the XLA scans
``ops/pll.py::pll_scan`` and ``ops/agc.py::agc_scan``) the tolerances are
those of ``tests/test_torch_chain.py``: the PLL's outputs 2e-5, its phase
4e-6 (a few ulps of 2*pi), its frequency 1e-6, ``locked`` equal; the AGC
1e-5.  XLA's sin/cos differ from PyTorch's by an ulp on some arguments and
XLA contracts products into fused multiply-adds, so the two sides are not
bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_order import (
    K, MODES, _input, _state, agc_chunk, pll_chunk)

from project_desert_tortoise_tpu.ops import agc as JA
from project_desert_tortoise_tpu.ops import pll as JP
from project_desert_tortoise_tpu.ops.pallas.pll_kernel import pll_scan_pallas
from project_desert_tortoise_tpu.utils import config as jax_config
from project_desert_tortoise_tpu_torch import chain
from project_desert_tortoise_tpu_torch.ops import agc as agc_ops
from project_desert_tortoise_tpu_torch.ops import fir
from project_desert_tortoise_tpu_torch.ops import pll as pll_ops
from project_desert_tortoise_tpu_torch.ops.kernels import scan_kernels as sk
from project_desert_tortoise_tpu_torch.ops.kernels.chain_kernel import (
    lane_const)
from project_desert_tortoise_tpu_torch.ops.kernels.pll_kernel import (
    pll_scan_kernel)

torch.set_num_threads(1)
LANES = ["warm", "cold", "near", "mixed"]
JAX_MODES = {"poes": jax_config.POES_TIP, "argos": jax_config.ARGOS}


def pll_scan_order(params, state, zre, zim):
    """pll_scan_ref's results in the decoupled kernel's order: A, B and M
    over each chunk; the final state A's, its locksig and avg_phase M's."""
    xre, xim = zre.t().contiguous(), zim.t().contiguous()
    k = pll_ops.loop_consts(params, state.phase)
    pll, avg, locksig = state, state.avg_phase, state.locksig
    outs, locks = [], []
    for c0 in range(0, xre.shape[0], K):
        pll, avg, locksig, out, lock = pll_chunk(
            k, pll, avg, locksig, xre[c0:c0 + K], xim[c0:c0 + K])
        outs.append(out)
        locks.append(lock)
    return (pll._replace(locksig=locksig, avg_phase=avg),
            torch.cat(outs).t(), torch.cat(locks).t())


def agc_scan_order(gain, x, p: sk.AGCParams):
    """agc_scan_ref's results in the AGC kernel's order: D over each
    chunk."""
    c = lambda v: lane_const(v, gain)
    agc = (c(p.attack), c(p.decay), c(p.reference), c(p.min_gain),
           c(p.max_gain), c(0.0))
    xt = x.t().contiguous()
    ys = []
    for c0 in range(0, xt.shape[0], K):
        gain, y = agc_chunk(agc, gain, xt[c0:c0 + K])
        ys.append(y)
    return gain, torch.cat(ys).t()


def _equal(got, want):
    for a, b in zip(got, want):
        if isinstance(a, tuple):
            _equal(a, b)
        else:
            assert torch.equal(a, b)


def _pll_case(mode, lanes, L, B):
    """The mode's PLL parameters (the port's, the JAX package's) and a
    case's inputs: BPSK at the mode's samples a symbol, lane states."""
    cfg, fs, sps = MODES[mode]
    cp = chain.make_params(cfg, fs)
    jparams = JP.make_params(JAX_MODES[mode].pll, fs)
    return cp.pll, jparams, _input(B, L, L + B, sps), _state(cp, B, lanes)


@pytest.mark.parametrize("L", [1, 63, 1000])
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("mode", ["poes", "argos"])
def test_pll_scan_order_matches_plain(mode, lanes, L):
    params, _, z, st = _pll_case(mode, lanes, L, 5)
    _equal(pll_scan_order(params, st, *z), pll_ops.pll_scan_ref(params, st,
                                                                 *z))


def test_near_lanes_lock_inside_a_chunk_of_the_scan():
    """The "near" lanes above all lock, some inside a chunk (not on its
    last sample), so the unlocked-to-locked switch of stage A is exercised
    on the PLL alone."""
    for mode in MODES:
        params, _, z, st = _pll_case(mode, "near", 1000, 5)
        _, _, lock = pll_ops.pll_scan_ref(params, st, *z)
        locked = lock > np.float32(params.lock_threshold)
        assert bool(locked.any(1).all())
        assert bool((locked.int().argmax(1) % K != K - 1).any())


def _agc_input(kind, B, n, seed):
    """AGC inputs (B, n) and parameters: "ramp", noise whose level rises
    from 0.01 to 2 (attack and decay both act); "branch", the POES
    scan branch's own input, the PLL output of warm lanes through the
    polyphase FIR; "clamps", noise rising from 1e-4 to 100 with a gain
    ceiling of 20 and a fast attack, so both clamps of the gain act."""
    params = chain.make_params(MODES["poes"][0], MODES["poes"][1])
    p = sk.AGCParams(params.agc_attack, params.agc_decay)
    rng = np.random.default_rng(seed)
    if kind == "branch":
        L = -(-n // params.interp)
        z = _input(B, L, seed, 3)
        _, soft, _ = pll_ops.pll_scan_ref(
            params.pll, _state(params, B, "warm"), *z)
        x = fir.fir_interp(soft, params.taps, params.interp)[:, :n]
        return x.contiguous(), p
    level = (np.logspace(-4, 2, n) if kind == "clamps"
             else np.linspace(0.01, 2.0, n))
    x = (rng.standard_normal((B, n)) * level).astype(np.float32)
    if kind == "clamps":
        p = sk.AGCParams(0.5, 0.05, max_gain=20.0)
    return torch.from_numpy(x), p


@pytest.mark.parametrize("n", [1, 63, 1000])
@pytest.mark.parametrize("kind", ["ramp", "branch", "clamps"])
def test_agc_scan_order_matches_plain(kind, n):
    x, p = _agc_input(kind, 5, n, n)
    gain = torch.full((5,), 17.58)
    got = agc_scan_order(gain, x, p)
    _equal(got, sk.agc_scan_ref(gain, x, p))
    if kind == "clamps" and n == 1000:   # both clamps acted: y = x * gain
        gains = got[1] / x
        for clamp in (p.max_gain, p.min_gain):
            assert bool(torch.isclose(gains, torch.tensor(clamp),
                                      rtol=1e-6).any())


def _jax_state(st):
    return JP.PLLState(*(jnp.asarray(x.numpy()) for x in st))


@pytest.mark.parametrize("L", [1, 63, 1000])
@pytest.mark.parametrize("lanes", LANES)
def test_pll_scan_matches_jax_on_order_inputs(lanes, L):
    """POES: the port's pll_scan (its plain version, on the CPU) against
    JAX's Pallas kernel in interpret mode and its XLA scan, 128 lanes."""
    params, jparams, z, st = _pll_case("poes", lanes, L, 128)
    tst, tout, tlock = pll_scan_kernel(params, st, z)
    jz = tuple(jnp.asarray(x.numpy()) for x in z)
    jst = _jax_state(st)
    for got in (pll_scan_pallas(jparams, jst, jz, window=L, interpret=True),
                JP.pll_scan(jparams, jst, jz)):
        gst, gout, glock = got
        assert np.abs(np.asarray(gout) - tout.numpy()).max() <= 2e-5
        assert np.abs(np.asarray(glock) - tlock.numpy()).max() <= 2e-5
        assert np.abs(np.asarray(gst.phase) - tst.phase.numpy()).max() <= 4e-6
        assert np.abs(np.asarray(gst.freq) - tst.freq.numpy()).max() <= 1e-6
        assert np.array_equal(np.asarray(gst.locked), tst.locked.numpy())


@pytest.mark.parametrize("n", [1, 63, 1000])
@pytest.mark.parametrize("kind", ["ramp", "branch"])
def test_agc_scan_matches_jax_on_order_inputs(kind, n):
    x, p = _agc_input(kind, 5, n, n)
    g0 = np.full((5,), 17.58, np.float32)
    js, jy = JA.agc_scan(JA.AGCState(gain=jnp.asarray(g0)),
                         jnp.asarray(x.numpy()), p.attack, p.decay)
    ts, ty = agc_ops.agc_scan(agc_ops.AGCState(gain=torch.from_numpy(g0)), x,
                              p.attack, p.decay)
    assert np.abs(np.asarray(jy) - ty.numpy()).max() <= 1e-5
    assert np.abs(np.asarray(js.gain) - ts.gain.numpy()).max() <= 1e-5


# The float64 ``argos`` mode (its exact chain's PLL, ``pll_scan_f64``):
# the decoupled kernel instantiated in double runs the same stages in
# double.  Held bit for bit to the plain version in float64, and to JAX's
# XLA scan under x64 with tests/test_torch_argos_exact.py's tolerances:
# the data arm, phase and frequency 1e-12 (XLA contracts the EMAs into
# fused multiply-adds; its sin/cos may round otherwise), the lock signal
# 1e-8 (q_rsqrt squeezes the sample's power through float32), ``locked``
# equal.

@pytest.fixture
def x64():
    """JAX's x64 switch on for one test, off again after it."""
    import jax
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _pll_case_f64(lanes, L, B):
    """_pll_case's argos inputs and lane states in float64."""
    params, jparams, z, st = _pll_case("argos", lanes, L, B)
    st = pll_ops.PLLState(*(x.double() if x.is_floating_point() else x
                            for x in st))
    return params, jparams, tuple(x.double() for x in z), st


@pytest.mark.parametrize("L", [1, 63, 1000, 2400])
@pytest.mark.parametrize("lanes", LANES)
def test_pll_scan_order_matches_plain_f64(lanes, L):
    params, _, z, st = _pll_case_f64(lanes, L, 5)
    got = pll_scan_order(params, st, *z)
    assert got[1].dtype == got[2].dtype == torch.float64
    _equal(got, pll_ops.pll_scan_ref(params, st, *z))


def test_near_lanes_lock_inside_a_chunk_in_float64():
    params, _, z, st = _pll_case_f64("near", 1000, 5)
    _, _, lock = pll_ops.pll_scan_ref(params, st, *z)
    locked = lock > params.lock_threshold
    assert bool(locked.any(1).all())
    assert bool((locked.int().argmax(1) % K != K - 1).any())


@pytest.mark.parametrize("L", [1, 63, 1000, 2400])
@pytest.mark.parametrize("lanes", LANES)
def test_pll_scan_order_f64_matches_jax_x64(x64, lanes, L):
    params, jparams, z, st = _pll_case_f64(lanes, L, 5)
    tst, tout, tlock = pll_scan_order(params, st, *z)
    gst, gout, glock = JP.pll_scan(
        jparams, _jax_state(st), tuple(jnp.asarray(x.numpy()) for x in z))
    assert np.asarray(gout).dtype == np.float64
    assert np.abs(np.asarray(gout) - tout.numpy()).max() <= 1e-12
    assert np.abs(np.asarray(glock) - tlock.numpy()).max() <= 1e-8
    assert np.abs(np.asarray(gst.phase) - tst.phase.numpy()).max() <= 1e-12
    assert np.abs(np.asarray(gst.freq) - tst.freq.numpy()).max() <= 1e-12
    assert np.array_equal(np.asarray(gst.locked), tst.locked.numpy())

"""The port's flat whole-file path (``parallel/blocked.py::
demod_frames_flat``) against the JAX package's, on the CPU (the kernels'
plain versions; JAX's fused kernel in interpret mode).

Both cut the B overlapping block windows from the flat planes on the
device, estimate each block's carrier and run ``demod_blocks``; JAX
stitches on its float32 time axis, the port on sample positions, which
agree on a recording shorter than 512 s.  Tolerance, the
``docs/DESIGN.md`` §4b contract: frame counts, payloads and polarity
identical, each timestamp equal or one sample period apart (XLA's and
libm's ``sin``/``cos`` round differently in the PLL).

- Branch False (the scan branch) at 15 blocks of a small plan, int16
  planes; then the port alone on float32 planes (the int16 values / 32768)
  and on planes packed to their width (``ops/bitpack.py``): the same
  frames as from int16, field for field.
- The fused branch at B = 128 (JAX takes it only at B % 128 == 0) on a
  10.5 s recording, int16 planes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu import chain as JC
from project_desert_tortoise_tpu.parallel import blocked as JB
from project_desert_tortoise_tpu.utils.config import POES_TIP as J_POES
from project_desert_tortoise_tpu_torch import chain as TC
from project_desert_tortoise_tpu_torch.ops import agc, bitpack
from project_desert_tortoise_tpu_torch.parallel import blocked as TB
from project_desert_tortoise_tpu_torch.utils import synth, wav as W
from project_desert_tortoise_tpu_torch.utils.config import POES_TIP

torch.set_num_threads(1)
FS = 50000.0
PLAN = (4096, 4096, 8192, 8)     # core, head, tail, max_frames: CPU time
WINDOW = 4096


def planes(n_frames, peak=32767):
    """int16 planes of a synthetic POES recording (full scale by default,
    as ``write_iq_wav`` quantizes), its float32 accumulated time axis
    t_ext (n+1,) and the norm gain of its first chunk."""
    iq, sent = synth.make_poes_recording(n_frames=n_frames, fs=FS)
    iq = iq / (np.abs(iq).max() * 1.2)
    r16 = np.round(iq.real * peak).astype(np.int16)
    i16 = np.round(iq.imag * peak).astype(np.int16)
    n = len(r16)
    t = W.time_axis(n, FS, np.float32)
    t_ext = np.concatenate([t, [t[-1] + np.float32(1.0) / np.float32(FS)]
                            ]).astype(np.float32)
    z = (r16[:10000] + 1j * i16[:10000]) / 32768.0
    norm = float(agc.static_gain(z, POES_TIP.static_gain_level, np.float32))
    return r16, i16, t_ext, norm, sent


def lines(frames):
    return [(f.time, f.inverted, bytes(f.data)) for f in frames]


def parity(want, got):
    """§4b, frame by frame."""
    assert len(want) == len(got) >= 4
    for (tw, iw, dw), (tg, ig, dg) in zip(lines(want), lines(got)):
        assert iw == ig and dw == dg
        assert abs(tw - tg) <= 1.0001 / FS


def jax_flat(br, B, r16, i16, t_ext, norm):
    plan = JB.BlockPlan(*PLAN)
    params = JC.make_params(J_POES, FS, quirks=False)
    bounds = JB.flat_bounds(t_ext, len(r16), plan, B)
    out = JB.demod_frames_flat(params, J_POES.framer, plan, B, FS, WINDOW, br,
                               jnp.asarray(r16), jnp.asarray(i16),
                               jnp.asarray(t_ext), norm,
                               jnp.asarray(bounds, jnp.float32))
    return JB._fetch_frames(out)


def port_flat(br, B, re, im, t_ext, norm, pack_bits=0):
    plan = TB.BlockPlan(*PLAN)
    params = TC.make_params(POES_TIP, FS)
    out = TB.demod_frames_flat(params, POES_TIP.framer, plan, B, FS, WINDOW,
                               br, torch.from_numpy(re), torch.from_numpy(im),
                               norm, n=len(t_ext) - 1, pack_bits=pack_bits)
    return TB._fetch_frames(out, t_ext)


@pytest.fixture(scope="module")
def scan_branch():
    r16, i16, t_ext, norm, sent = planes(8)
    B = -(-len(r16) // PLAN[0])
    return (r16, i16, t_ext, norm, B,
            port_flat(False, B, r16, i16, t_ext, norm))


def test_scan_branch_matches_jax(scan_branch):
    r16, i16, t_ext, norm, B, got = scan_branch
    assert B == 15
    parity(jax_flat(False, B, r16, i16, t_ext, norm), got)


def test_float32_planes_give_the_int16_frames(scan_branch):
    r16, i16, t_ext, norm, B, want = scan_branch
    f32 = lambda a: (a.astype(np.float32) / np.float32(32768.0))
    got = port_flat(False, B, f32(r16), f32(i16), t_ext, norm)
    assert lines(got) == lines(want)


def test_packed_planes_give_the_int16_frames(scan_branch):
    r16, i16, t_ext, norm, B, want = scan_branch
    w = bitpack.pack_width(r16, i16)
    assert w == 16            # full scale: pack=-1 would ship int16
    w = 16                    # a 16-bit pack is still exact
    pk = lambda a: bitpack.pack(a, w).view(np.int32)
    got = port_flat(False, B, pk(r16), pk(i16), t_ext, norm, pack_bits=w)
    assert lines(got) == lines(want)


def test_fused_branch_matches_jax_at_128_blocks():
    r16, i16, t_ext, norm, sent = planes(100)
    B = 128
    assert len(r16) <= B * PLAN[0]      # every sample in a core
    got = port_flat("fused", B, r16, i16, t_ext, norm)
    parity(jax_flat("fused", B, r16, i16, t_ext, norm), got)
    sset = {bytes(s) for s in sent}
    assert sum(bytes(f.data) in sset for f in got) >= 90

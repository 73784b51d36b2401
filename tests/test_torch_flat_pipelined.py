"""The port's flat whole-file path against the port, on the CPU (the
kernels' plain versions), on planes scaled to 13 signed bits (the level of
the golden clip that ``ops/bitpack.py`` cites):

- ``demod_frames_flat_pipelined`` at 2 slices (int16) and at 4 slices
  with ``pack=-1`` (which must choose width 13) gives the one-shot
  ``demod_frames_flat``'s frames, field for field;
- the flat path gives ``demodulate_blocked``'s frames on the same branch
  and the same samples, field for field, on the scan branch (False) and
  on the fused branch;
- ``tgen=True`` off the fused branch raises, as JAX's ``demod_blocks``
  does, and so does a block count the slices do not divide.
"""

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu_torch import chain as TC
from project_desert_tortoise_tpu_torch.ops import bitpack
from project_desert_tortoise_tpu_torch.parallel import blocked as TB
from project_desert_tortoise_tpu_torch.utils.config import POES_TIP
from test_torch_flat import FS, PLAN, WINDOW, lines, planes

torch.set_num_threads(1)
B = 16           # 60,000 samples in 15 cores of 4,096; 16 divides by 4


@pytest.fixture(scope="module")
def scaled():
    r16, i16, t_ext, norm, _ = planes(8, peak=4095)
    assert int(np.abs(r16).max()) <= 4095 and bitpack.pack_width(
        r16, i16) == 13
    return r16, i16, t_ext, norm


def one_shot(br, r16, i16, t_ext, norm):
    out = TB.demod_frames_flat(TC.make_params(POES_TIP, FS), POES_TIP.framer,
                               TB.BlockPlan(*PLAN), B, FS, WINDOW, br,
                               torch.from_numpy(r16), torch.from_numpy(i16),
                               norm)
    return TB._fetch_frames(out, t_ext)


def pipelined(br, r16, i16, t_ext, norm, **kw):
    return TB.demod_frames_flat_pipelined(
        TC.make_params(POES_TIP, FS), POES_TIP.framer, TB.BlockPlan(*PLAN), B,
        FS, WINDOW, br, r16, i16, t_ext, norm, device="cpu", **kw)


@pytest.fixture(scope="module")
def scan_one_shot(scaled):
    frames = one_shot(False, *scaled)
    assert len(frames) >= 4
    return frames


@pytest.mark.parametrize("n_slices,pack", [(2, 0), (4, -1)])
def test_pipelined_matches_one_shot(scaled, scan_one_shot, n_slices, pack,
                                    monkeypatch):
    widths = []
    real = TB.stage_flat_slices

    def spy(*args, **kw):
        out = real(*args, **kw)
        widths.append(out[2])
        return out
    monkeypatch.setattr(TB, "stage_flat_slices", spy)
    got = pipelined(False, *scaled, n_slices=n_slices, pack=pack)
    assert widths == [13 if pack else 0]
    assert lines(got) == lines(scan_one_shot)


@pytest.mark.parametrize("br", [False, "fused"])
def test_flat_matches_demodulate_blocked(scaled, scan_one_shot, br):
    r16, i16, t_ext, norm = scaled
    flat = scan_one_shot if br is False else one_shot(br, *scaled)
    iq = (r16.astype(np.float32) + 1j * i16.astype(np.float32)) / 32768.0
    t = t_ext[:-1]
    want = TB.demodulate_blocked(iq, t, FS, POES_TIP, norm_factor=norm,
                                 plan=TB.BlockPlan(*PLAN), window=WINDOW,
                                 use_pallas=br, device="cpu")
    assert lines(flat) == lines(want)


def test_tgen_off_the_fused_branch_and_ragged_slices_raise(scaled):
    with pytest.raises(ValueError, match="fused"):
        pipelined(False, *scaled, tgen=True)
    with pytest.raises(ValueError):
        pipelined(False, *scaled, n_slices=3)

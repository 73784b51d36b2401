"""The telemetry products: the port's own copies of ``telemetry/``
(minor frames, the TIP instrument dissectors, ARGOS packets),
``utils/png.py`` and ``apps/telemetry_explorer.py`` against the JAX
package's, and ``--products`` on the port's CLI.

Inputs are synthetic: 960 TIP minor frames (three major frames of
``utils/synth.make_poes_frame``, valid sync and parity, random words),
a few with a flipped bit, the frame-0 rows carrying day and time words;
ARGOS packets with and without the prototype's platform ID, a minute
apart.  Everything is numpy on both sides, so every result is held
exactly: arrays equal in dtype and value, dataclasses field by field,
PNG files and product directories byte for byte.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from project_desert_tortoise_tpu.apps import telemetry_explorer as JX
from project_desert_tortoise_tpu.ops.framer import Frame as JFrame
from project_desert_tortoise_tpu.telemetry import argos as JARG
from project_desert_tortoise_tpu.telemetry import minorframes as JMF
from project_desert_tortoise_tpu.telemetry import tip as JTIP
from project_desert_tortoise_tpu.utils import png as JPNG
from project_desert_tortoise_tpu_torch.apps import demod_poes as port_cli
from project_desert_tortoise_tpu_torch.apps import telemetry_explorer as TX
from project_desert_tortoise_tpu_torch.ops.framer import Frame as TFrame
from project_desert_tortoise_tpu_torch.telemetry import argos as TARG
from project_desert_tortoise_tpu_torch.telemetry import minorframes as TMF
from project_desert_tortoise_tpu_torch.telemetry import tip as TTIP
from project_desert_tortoise_tpu_torch.utils import png as TPNG
from project_desert_tortoise_tpu_torch.utils import synth, wav as W

torch.set_num_threads(1)


def same(a, b, what="value"):
    """Exact equality of nested results: arrays (dtype and values),
    dataclasses, dicts, sequences and scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), what
    else:
        assert type(a) is type(b) and a == b, what


@pytest.fixture(scope="module")
def minor():
    """(frames (960, 104) uint8, times): three major frames of synthetic
    minor frames, day 241 and a time of day in the frame-0 rows, a bit
    flipped in every 97th frame."""
    ids = np.arange(960) % 320
    frames = np.stack([synth.make_poes_frame(int(i), rng=np.random.
                                             default_rng(k))
                       for k, i in enumerate(ids)])
    day, ms = 241, 50_000_000
    for k in np.flatnonzero(ids == 0):
        m = ms + int(k) * 100
        frames[k, 8] = (day >> 1) & 0xFF
        frames[k, 9] = ((day & 1) << 7) | ((m >> 24) & 0b111)
        frames[k, 10:13] = [(m >> 16) & 0xFF, (m >> 8) & 0xFF, m & 0xFF]
    frames[::97, 30] ^= 4
    times = 100.0 + 0.1 * np.arange(960)
    return frames, times


def test_minorframe_functions_equal(minor):
    frames, times = minor
    same(JMF.check_parity(frames), TMF.check_parity(frames), "parity")
    assert not TMF.check_parity(frames)[0].all()
    same(JMF.daytime_decode(frames, times), TMF.daytime_decode(frames, times),
         "daytime")
    same(JMF.daytime_decode(frames), TMF.daytime_decode(frames), "no times")
    pos = np.array([0, 832, 1664, 3000, 3832, 4664])
    same(JMF.sync_spacing_report(pos), TMF.sync_spacing_report(pos))
    jf = [JFrame(time=float(t), inverted=False, data=f, complete=True)
          for t, f in zip(times[:5], frames[:5])]
    tf = [TFrame(time=float(t), inverted=False, data=f, complete=True)
          for t, f in zip(times[:5], frames[:5])]
    same(JMF.frames_to_matrix(jf), TMF.frames_to_matrix(tf))
    same(JMF.frame_times(jf), TMF.frame_times(tf))


def test_tip_dissectors_equal(minor):
    frames, times = minor
    same(JTIP.analog_subcom(frames, times), TTIP.analog_subcom(frames, times),
         "analog")
    jh, th = JTIP.hirs_extract(frames, times), TTIP.hirs_extract(frames,
                                                                   times)
    same(jh, th, "hirs")
    for trusted in (False, True):
        same(JTIP.hirs_images(jh, trusted), TTIP.hirs_images(th, trusted),
             "hirs images")
    jp = JTIP.dcs_extract(frames, times, spacecraft=15)
    tp = TTIP.dcs_extract(frames, times, spacecraft=15)
    assert len(tp) > 0
    same(jp, tp, "dcs")
    same(JTIP.dcs_unroll(frames, times), TTIP.dcs_unroll(frames, times))
    same(JTIP.dcs_by_txid(jp), TTIP.dcs_by_txid(tp), "by txid")
    jm, jt = JTIP.sem_extract(frames)
    tm, tt = TTIP.sem_extract(frames)
    same((jm, jt), (tm, tt), "sem")
    for ch in sorted(jm):
        same(JTIP.despike(jm[ch]), TTIP.despike(tm[ch]), f"despike {ch}")
    x = np.array([5, 5, 90, 5, 6, 200, 7, 7], np.int64)
    same(JTIP.despike(x, 10), TTIP.despike(x, 10))
    same(JTIP.sbuv_extract(frames, times), TTIP.sbuv_extract(frames, times),
         "sbuv")


def test_argos_packet_functions_equal():
    rng = np.random.default_rng(3)
    pid = (251, 58, 208, 0)
    rows = []
    for k in range(9):
        data = rng.integers(0, 256, 7).astype(np.uint8)
        if k % 3:
            data[:4] = pid
        rows.append((1000.0 + 60.0 * k + rng.uniform(-3, 3), data,
                     float(rng.uniform(5, 20))))
    jf, tf = [], []
    for t, d, snr in rows:
        for out, cls in ((jf, JFrame), (tf, TFrame)):
            f = cls(time=t, inverted=False, data=d.copy(), complete=True)
            f.quality_db, f.snr_db, f.carrier_hz = -5.5, snr, 123.25
            out.append(f)
    assert [TARG.platform_id(f) for f in tf] == \
        [JARG.platform_id(f) for f in jf]
    j_pid, t_pid = JARG.filter_platform(jf), TARG.filter_platform(tf)
    assert len(t_pid) == 6
    assert [f.hex_line() for f in t_pid] == [f.hex_line() for f in j_pid]
    jg, tg = JARG.group_by_repetition(j_pid), TARG.group_by_repetition(t_pid)
    assert [[f.hex_line() for f in g] for g in tg] == \
        [[f.hex_line() for f in g] for g in jg]
    assert TARG.packet_report(tf) == JARG.packet_report(jf)


def test_png_bytes_equal(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.normal(100.0, 30.0, (37, 64))
    same(JPNG.autoscale_u8(img), TPNG.autoscale_u8(img))
    gray = TPNG.autoscale_u8(img)
    rgb = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    series = {"a": (np.arange(50.0), np.sin(np.arange(50.0) / 5)),
              "b": (np.arange(30.0) * 2, rng.normal(size=30))}
    for name, mod in (("jax", JPNG), ("port", TPNG)):
        d = tmp_path / name
        d.mkdir()
        mod.write_gray_png(str(d / "g.png"), gray)
        mod.write_rgb_png(str(d / "c.png"), rgb)
        mod.render_series_png(str(d / "s.png"), series, title="t",
                              xlabel="x", ylabel="y")
    for f in ("g.png", "c.png", "s.png"):
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes(), f


def _tree(d):
    """{relative path: bytes} of a directory."""
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def test_explorers_write_the_same_products(minor, tmp_path, capsys):
    frames, times = minor
    src = str(tmp_path / "minorFrames.txt")
    with open(src, "w") as f:
        for t, row in zip(times, frames):
            f.write(f"{t:.5f} " + "".join(f"{b:02X} " for b in row) + "\n")
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    assert JX.run([src, "--outdir", j]) == 0
    assert TX.run([src, "--outdir", t]) == 0
    jt, tt = _tree(j), _tree(t)
    assert {"summary.txt", "DCS_RAW.txt", "HIRS1.png", "HIRS20.png",
            "SEM_MEPED.txt", "analog.txt"} <= set(tt)
    assert list(tt) == list(jt)
    for f in jt:
        assert tt[f] == jt[f], f


def test_cli_products_on_a_short_poes_clip(tmp_path, capsys):
    """``demod_poes --products DIR`` (the exact chain, the plain versions
    on the CPU): the frames file, and in DIR what JAX's explorer writes
    for that file; the summary's error-free count is check_parity's."""
    iq, _ = synth.make_poes_recording(n_frames=6, fs=50000.0)
    wav = str(tmp_path / "in.wav")
    W.write_iq_wav(wav, iq / (np.abs(iq).max() * 1.2), 50000)
    out, prod = str(tmp_path / "frames.txt"), str(tmp_path / "products")
    assert port_cli.run([wav, "--device", "cpu", "--out", out,
                         "--products", prod]) == 0
    assert "error-free frames" in capsys.readouterr().out
    ref = str(tmp_path / "jax")
    assert JX.run([out, "--outdir", ref]) == 0
    got, want = _tree(prod), _tree(ref)
    assert list(got) == list(want) and "summary.txt" in got
    for f in want:
        assert got[f] == want[f], f
    from project_desert_tortoise_tpu_torch.utils.output import (
        parse_frames_file)
    rows = [r[2] for r in parse_frames_file(out) if len(r[2]) == 104]
    good, _ = TMF.check_parity(np.array(rows, np.uint8))
    assert len(rows) >= 4
    assert got["summary.txt"].decode().startswith(
        f"{int(good.sum())} out of {len(rows)} Error Free Frames")


@pytest.mark.parametrize("lead_in", [True, False])
def test_pass_products_reference(tmp_path, lead_in):
    """chip_smoke.POES_PASS_PRODUCTS, the files the card's ``products``
    phase must write for the 12-minute POES pass: JAX's explorer on that
    pass's frames (``synth_pass("poes")``: seed 42, 7,201 frames, the
    acquisition lead-in first), with the lead-in frame and without it."""
    import hashlib

    import chip_smoke
    rng = np.random.default_rng(42)
    frames = [synth.make_poes_frame(i, rng=rng)
              for i in range(chip_smoke.PASS_FRAMES + 1)]
    src = str(tmp_path / "pass.txt")
    with open(src, "w") as f:
        for k, row in enumerate(frames[0 if lead_in else 1:]):
            f.write(f"{0.1 * k:.5f} " + "".join(f"{b:02X} " for b in row)
                    + "\n")
    out = str(tmp_path / "products")
    assert JX.run([src, "--outdir", out]) == 0
    names = sorted(os.listdir(out))
    assert (len(names), hashlib.sha256("\n".join(names).encode())
            .hexdigest()[:16]) == chip_smoke.POES_PASS_PRODUCTS
    # the pass's frames are the recording's
    _, sent = synth.make_poes_recording(n_frames=3)
    assert all(np.array_equal(a, b) for a, b in zip(frames, sent))

"""The port's own copies of the JAX package's jax-free modules
(``utils/config.py``, ``utils/synth.py``, ``utils/wav.py`` and the mode
registry) give the same configurations, recordings and files: exact."""

import dataclasses

import numpy as np
import pytest

from project_desert_tortoise_tpu.models import registry as JR
from project_desert_tortoise_tpu.utils import config as JCFG
from project_desert_tortoise_tpu.utils import synth as JS, wav as JW
from project_desert_tortoise_tpu_torch.models import registry as TR
from project_desert_tortoise_tpu_torch.utils import config as TCFG
from project_desert_tortoise_tpu_torch.utils import synth as TS, wav as TW


def test_modes_equal_field_for_field():
    assert sorted(TCFG.MODES) == sorted(JCFG.MODES)
    for name, mode in JCFG.MODES.items():
        assert dataclasses.asdict(TCFG.MODES[name]) == dataclasses.asdict(mode)
        assert dataclasses.asdict(TR.get_mode(name)) == \
            dataclasses.asdict(JR.get_mode(name))
    with pytest.raises(KeyError, match="unknown mode"):
        TR.get_mode("nope")


@pytest.mark.parametrize("kind", ["poes", "argos"])
def test_recordings_identical(kind):
    if kind == "poes":
        kw = dict(n_frames=3, fs=50000.0)
        j, t = JS.make_poes_recording(**kw), TS.make_poes_recording(**kw)
    else:
        kw = dict(n_packets=2, invert_bits=True)
        j, t = JS.make_argos_recording(**kw), TS.make_argos_recording(**kw)
    assert np.array_equal(j[0], t[0])
    assert len(j[1]) == len(t[1])
    for a, b in zip(j[1], t[1]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("reader", ["load_iq_wav", "load_iq_wav_int16"])
def test_wav_written_by_port_reads_the_same(tmp_path, reader):
    iq, _ = TS.make_poes_recording(n_frames=1, fs=50000.0)
    iq = iq[:20000] / (np.abs(iq).max() * 1.2)
    path = str(tmp_path / "x.wav")
    TW.write_iq_wav(path, iq, 50000)
    j, t = getattr(JW, reader)(path), getattr(TW, reader)(path)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(JW.time_axis(1000, 50000.0, np.float32, t0=511.99),
                          TW.time_axis(1000, 50000.0, np.float32, t0=511.99))

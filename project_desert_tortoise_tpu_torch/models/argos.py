"""ARGOS platform-uplink demodulator (reference ARGOSdemod / ...PortAudio).

Twin of ``project_desert_tortoise_tpu/models/argos.py``: the exact chunked
chain with the ``argos`` mode, which runs in double precision as the
reference file app does (``ARGOSdemod/config.h`` USE_FLOATS=0): the chain's
kernels in their float64 instances on the card, unless ``device`` says
otherwise.  The JAX package turns on x64 for it; the port needs no switch.
"""
from project_desert_tortoise_tpu_torch.models.demodulator import (  # noqa: F401
    DemodResult, DemodSession, demodulate_wav)
from project_desert_tortoise_tpu_torch.utils.config import (  # noqa: F401
    ARGOS, ARGOS_REALTIME)


def demodulate(path: str, annotate_quality: bool = True,
               **kw) -> DemodResult:
    """Demodulate an ARGOS recording; packets carry quality/SNR annotations
    (closing the reference's README.md:42 TODO) unless disabled."""
    from project_desert_tortoise_tpu_torch.utils import wav as W
    iq, t, fs, _ = W.load_iq_wav(path, ARGOS.np_dtype())
    sess = DemodSession(ARGOS, fs, annotate_quality=annotate_quality, **kw)
    return sess.run(iq, t)

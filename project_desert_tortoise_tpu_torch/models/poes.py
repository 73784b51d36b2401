"""POES TIP telemetry demodulator (reference POESTIPdemod / ...PortAudio).

Twin of ``project_desert_tortoise_tpu/models/poes.py``: the exact chunked
chain with the ``poes_tip`` mode, on the card unless ``device`` says
otherwise."""
from project_desert_tortoise_tpu_torch.models.demodulator import (  # noqa: F401
    DemodResult, DemodSession, demodulate_raw, demodulate_wav)
from project_desert_tortoise_tpu_torch.utils.config import (  # noqa: F401
    POES_TIP, POES_TIP_REALTIME)


def demodulate(path: str, **kw) -> DemodResult:
    """Demodulate a POES TIP IQ recording (wav or SDR# raw)."""
    if path.lower().endswith(".raw"):
        rate = kw.pop("sample_rate_hz")
        return demodulate_raw(path, POES_TIP, rate, **kw)
    return demodulate_wav(path, POES_TIP, **kw)

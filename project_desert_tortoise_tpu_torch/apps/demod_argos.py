"""CLI: ARGOS file demodulator, PyTorch/CUDA port.

Twin of ``project_desert_tortoise_tpu/apps/demod_argos.py`` (the reference
``demodARGOS``, ``ARGOSdemod/main.c:121-164``): the flags of the port's
``demod_poes`` with the ``argos`` mode and ``packets_*.txt`` output.  The
reference accepts WAV input only; RAW input (with ``-s``) is accepted with
a notice.  The time axis loads in float64 (the mode's dtype).  Without
``--fast`` the exact chunked chain runs in float64, as the reference file
app does (its kernels' double instances on the card); the fast path casts
to float32.  ``--mode argos_realtime`` decodes the realtime variant
(float32, inverse sync), on either path.

    python -m project_desert_tortoise_tpu_torch.apps.demod_argos X.wav
    python -m project_desert_tortoise_tpu_torch.apps.demod_argos X.wav --fast
    python -m project_desert_tortoise_tpu_torch.apps.demod_argos X.wav \
        --mode argos_realtime
"""
from project_desert_tortoise_tpu_torch.apps.demod_poes import run


def main(argv=None):
    raise SystemExit(run(argv, default_mode="argos", prefix="packets"))


if __name__ == "__main__":
    main()

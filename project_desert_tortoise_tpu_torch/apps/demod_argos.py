"""CLI: ARGOS file demodulator, PyTorch/CUDA port.

Twin of ``project_desert_tortoise_tpu/apps/demod_argos.py`` (the reference
``demodARGOS``, ``ARGOSdemod/main.c:121-164``): the flags of the port's
``demod_poes`` with the ``argos`` mode and ``packets_*.txt`` output.  The
reference accepts WAV input only; RAW input (with ``-s``) is accepted with
a notice.  The time axis loads in float64 (the mode's dtype) and the fast
path casts it to float32.  ``--mode argos_realtime`` decodes the realtime
variant (float32, inverse sync).

    python -m project_desert_tortoise_tpu_torch.apps.demod_argos X.wav --fast
"""
from project_desert_tortoise_tpu_torch.apps.demod_poes import run


def main(argv=None):
    raise SystemExit(run(argv, default_mode="argos", prefix="packets"))


if __name__ == "__main__":
    main()

"""Project Desert Tortoise, PyTorch/CUDA port.

The block-parallel POES and ARGOS demodulator, the exact chunked chain
(``DemodSession``, the CLIs without ``--fast``, in every mode: float32,
and float64 for ``argos``), the telemetry products (``telemetry/``,
``apps/telemetry_explorer.py``), and streaming and multi-channel serving
(``models/streaming.py``, ``parallel/serving.py::ChannelBank``,
``demod_realtime``, ``demod_serve``, the native IQ ring in ``native/``) of
``project_desert_tortoise_tpu`` (the JAX reference, which stays in the
repository unchanged) rebuilt on PyTorch, with the chain's per-lane
recurrences as hand-written CUDA kernels for Hopper (``csrc/``): the fused
chain, the front half (PLL + FIR + AGC), the PLL, the AGC and Gardner
timing with the Manchester decision, windowed and over whole buffer
images (the last three also in double, for the float64 chain).  Module
paths and names follow the JAX package so each counterpart is easy to
find; this package imports torch and numpy, never jax and nothing of the JAX package
(it keeps its own copies of the jax-free modules it needs).
"""

__version__ = "0.1.0"

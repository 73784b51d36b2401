"""FIR design and application: the Blackman windowed-sinc lowpass of the
reference, the zero-stuffing interpolator and its output time axis.

Twins of ``project_desert_tortoise_tpu/ops/fir.py``: ``make_lpfir``
(``common/LowPassFilter.c:127-175``), ``fir_interp``, ``fir_apply``,
``fir_history_update`` and ``fir_out_times`` (``fir.py:59-111``).  ``fir_interp`` is one plain convolution over the
block, as XLA computes it in the JAX package (a conv with
``lhs_dilation``); the chain kernels apply the same filter in polyphase
form instead (``ops/kernels/chain_kernel.py::polyphase``).
"""

from __future__ import annotations

import numpy as np
import torch


def make_lpfir(order: int, cutoff_hz: float, fs_hz: float, interp: int,
               dtype=np.float32) -> np.ndarray:
    """Blackman windowed-sinc lowpass, gain-scaled by `interp`.

    `fs_hz` is the *output* (post-interpolation) rate, as at the reference
    call site ``POESTIPdemod/main.c:369``.
    """
    dtype = np.dtype(dtype)
    n = np.arange(order, dtype=np.float64)
    # The reference computes wc and tou in the stream dtype; round to match.
    wc = np.float64(dtype.type(2.0 * np.pi * cutoff_hz / fs_hz))
    tou = np.float64(dtype.type((order - 1.0) / 2.0))
    with np.errstate(invalid="ignore", divide="ignore"):
        hd = np.sin(wc * (n - tou)) / (np.pi * (n - tou))
    if order % 2 == 1:
        hd[(order - 1) // 2] = wc / np.pi  # center-tap fix (LowPassFilter.c:151)
    wn = (0.42 - 0.5 * np.cos(2 * np.pi * n / (order - 1))
          + 0.08 * np.cos(4 * np.pi * n / (order - 1)))
    return (hd * wn * float(interp)).astype(dtype)


def fir_interp(x, taps, interp: int, history=None):
    """Zero-stuffing 1:interp upsampler + FIR over one block.

    x: (..., n) real float32 (or float64) block; taps: values, or a
    tensor (the exact chain passes one already on the device: a copy from
    the host would wait for the work queued before it), taken in the dtype
    of `x` (float32 taps with a float64 x give the exact-sum reference);
    history: (..., H) previous real samples
    with H = ceil((N-1)/interp), or None for stream start (zeros).  Returns
    y of shape (..., n*interp): the JAX convolution's output, with its
    padding (the stuffed history's excess trimmed on the left, `interp - 1`
    zeros on the right).  The sums run in the dtype of `x`: cuDNN's TF32
    (10-bit mantissa) is switched off for the call on the card, through the
    process-wide cuDNN flags; their order is the convolution library's, not
    XLA's.
    """
    taps = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    n_taps = taps.shape[0]
    hist_len = -(-(n_taps - 1) // interp)  # ceil
    lead = tuple(x.shape[:-1])
    if history is None:
        history = torch.zeros(lead + (hist_len,), dtype=x.dtype,
                              device=x.device)
    xh = torch.cat([history, x], dim=-1).reshape(-1, 1, hist_len
                                                 + x.shape[-1])
    # zero-stuffed: the dilated input and its interp-1 right-pad zeros
    s = torch.zeros((xh.shape[0], 1, xh.shape[-1] * interp), dtype=x.dtype,
                    device=x.device)
    s[..., ::interp] = xh
    excess = hist_len * interp - (n_taps - 1)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = torch.nn.functional.conv1d(s[..., excess:],
                                       taps.reshape(1, 1, n_taps))
    return y.reshape(lead + (-1,))


def fir_apply(x, taps, history=None):
    """Plain streaming FIR (interp == 1), reference ``LowPassFilter.c:76``."""
    return fir_interp(x, taps, 1, history)


def fir_history_update(x, history, n_taps: int, interp: int):
    """The trailing history window after consuming block `x`."""
    hist_len = -(-(n_taps - 1) // interp)
    return torch.cat([history, x], dim=-1)[..., -hist_len:]


def fir_out_times(t_next, interp: int):
    """Output time axis: group i carries t[i+1] (LowPassFilter.c:68).

    `t_next` is the time axis shifted by one sample (t_next[i] = time of
    input sample i+1); each value is repeated for the group's `interp`
    outputs."""
    return torch.repeat_interleave(t_next, interp, dim=-1)

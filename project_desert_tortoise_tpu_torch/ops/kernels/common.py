"""Argument checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import torch


def check(name, t, shape, dtypes, device):
    """Raise unless tensor `t` lies on `device` with one of `dtypes` and
    the given shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")


def state_rows(pll_state, *extra):
    """The kernels' (6 + len(extra), B) float32 state rows: PLL phase,
    freq, locksig, avg_phase, sweep, locked as 0/1, then `extra`."""
    return torch.stack([*pll_state[:5], pll_state.locked.to(torch.float32),
                        *extra]).contiguous()


def launch(device, name: str, *args) -> None:
    """Call the library entry point `name` with `args` and the current
    stream of `device` (a CUDA device) as its last argument; raises if the
    launch reports a CUDA error."""
    from project_desert_tortoise_tpu_torch.ops.kernels import build
    with torch.cuda.device(device):
        rc = getattr(build.load(), name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")

"""Argument checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# what the decoupled kernels' *_config entry points report, in order
CONFIG_FIELDS = ("lanes_per_cta", "chunk", "threads", "smem_bytes",
                 "registers", "local_bytes")


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


def resolve_device(device) -> torch.device:
    """The torch device an entry point was asked for; raises if it is a
    CUDA device and no card is there (no quiet switch to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def on_card(name: str, device) -> bool:
    """True where `name` launches its kernel (a CUDA device), False where it
    runs its plain version (the CPU); raises for any other device."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    return device.type == "cuda"


def one_device(name: str, *tensors) -> torch.device:
    """The device that every one of `tensors` lies on; raises if they lie
    on more than one (a wrapper that chose its kernel or its plain version
    by one argument would otherwise run the wrong one)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}'s tensors lie on {sorted(map(str, devs))}"
                         ", not on one device")
    return devs.pop()


def state_rows(pll_state, *extra):
    """The kernels' (6 + len(extra), B) state rows in the state's dtype
    (float32, or float64): PLL phase, freq, locksig, avg_phase, sweep,
    locked as 0/1, then `extra`."""
    locked = pll_state.locked.to(pll_state.phase.dtype)
    return torch.stack([*pll_state[:5], locked, *extra]).contiguous()


# While a dict is set here, launch() records a pair of CUDA events on the
# stream around each launch, appended to the list under its entry point's
# name (chip_smoke.py times a whole run's kernels so); None records nothing.
launch_events = None


def launch(device, name: str, *args) -> None:
    """Call the library entry point `name` with `args` and the current
    stream of `device` (a CUDA device) as its last argument; raises if the
    launch reports a CUDA error."""
    from project_desert_tortoise_tpu_torch.ops.kernels import build
    events = launch_events
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if events is not None:
            pair = tuple(torch.cuda.Event(enable_timing=True)
                         for _ in range(2))
            pair[0].record(stream)
        rc = getattr(build.load(), name)(*args, stream.cuda_stream)
        if events is not None:
            pair[1].record(stream)
            events.setdefault(name, []).append(pair)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def kernel_config(device, name: str, *args, fields=CONFIG_FIELDS) -> dict:
    """Call the library's config entry point `name` with `args` and an
    int32 output array; returns its `fields`, as the card reports them for
    that kernel instantiation."""
    from project_desert_tortoise_tpu_torch.ops.kernels import build
    out = np.zeros(len(fields), np.int32)
    with torch.cuda.device(device):
        rc = getattr(build.load(), name)(
            *args, out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    return dict(zip(fields, map(int, out)))

"""Checkpoint / resume for streaming demod sessions.

Twin of ``project_desert_tortoise_tpu/utils/checkpoint.py``.  The
reference's only "resume" mechanism is its C static locals: processing can
stop and continue at any chunk boundary because all loop state persists.
Here that state is the explicit ``ChainState`` plus the host-side framer
and counters, so a session can be written to one ``.npz`` and resumed
later, on another host or device.

The file layout is the JAX package's: the state's arrays as ``leaf_<i>``
in the order ``jax.tree_util`` flattens a ``ChainState`` (the nested
NamedTuples' fields in order; the port's states have JAX's fields), the
framer's sync history, and the metadata as JSON bytes.  So a checkpoint
written by either package resumes in the other.
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

from project_desert_tortoise_tpu_torch import chain as chain_lib
from project_desert_tortoise_tpu_torch.models.demodulator import DemodSession


def _leaves(state) -> list:
    """The state's tensors in field order, depth first."""
    if isinstance(state, tuple):
        return [leaf for field in state for leaf in _leaves(field)]
    return [state]


def _rebuild(template, leaves):
    """`template` with its tensors replaced, in order, by `leaves`."""
    if isinstance(template, tuple):
        return type(template)(*(_rebuild(f, leaves) for f in template))
    return leaves.pop(0)


def save_session(sess: DemodSession, path: str):
    arrays = {f"leaf_{i}": v.cpu().numpy()
              for i, v in enumerate(_leaves(sess.state))}
    fr = sess.framer
    meta = {
        "mode": sess.cfg.name,
        "fs": sess.fs,
        "chunk_size": sess.chunk_size,
        "norm_factor": sess.norm_factor,
        "total_samples": sess.total_samples,
        "total_symbols": sess.total_symbols,
        "total_bits": sess.total_bits,
        "avg_phase": sess.avg_phase,
        "lock_freq_hz": sess.lock_freq_hz,
        "was_locked": sess._was_locked,
        "framer": {
            "shifting": fr.shifting,
            "inverted": fr.inverted,
            "bit_idx": fr.bit_idx,
            "byte": fr.byte,
            "frame": fr.frame,
            "frame_time": fr.frame_time,
        },
    }
    arrays["framer_history"] = fr.history
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_session(path: str, mode_cfg=None, *, device="cuda") -> DemodSession:
    """The session saved at `path` (by either package), on `device`.

    The file names its mode, and the registry's configuration of that
    name is used unless `mode_cfg` is given: the configuration a session
    was built with by hand (another clock, ``dataclasses.replace`` of a
    registered mode), whose name must be the saved one.  The state's
    leaves keep their saved shapes, the upsampling clocks' (2,) split
    pointers among them."""
    from project_desert_tortoise_tpu_torch.models.registry import get_mode

    z = np.load(path)
    meta = json.loads(bytes(z["meta_json"]).decode())
    if mode_cfg is not None and mode_cfg.name != meta["mode"]:
        raise ValueError(f"the checkpoint is of mode {meta['mode']!r}, "
                         f"not {mode_cfg.name!r}")
    cfg = mode_cfg or get_mode(meta["mode"])
    sess = DemodSession(cfg, meta["fs"], chunk_size=meta["chunk_size"],
                        norm_factor=meta["norm_factor"], quirks=False,
                        device=device)
    template = chain_lib.init_state(sess.params, meta["norm_factor"] or 1.0,
                                    sess.chunk_size, device=sess.device,
                                    dtype=sess.torch_dtype)
    # each leaf keeps its saved shape (the chunk-invariant chain's buffer
    # images carry a margin beyond the initial state's) and takes the
    # template's dtype, the mode's (float64 leaves for the argos mode)
    leaves = [torch.from_numpy(np.asarray(z[f"leaf_{i}"])).to(
        dtype=t.dtype, device=sess.device)
        for i, t in enumerate(_leaves(template))]
    sess.state = _rebuild(template, leaves)
    sess.total_samples = meta["total_samples"]
    sess.total_symbols = meta["total_symbols"]
    sess.total_bits = meta["total_bits"]
    sess.avg_phase = meta["avg_phase"]
    sess.lock_freq_hz = meta["lock_freq_hz"]
    sess._was_locked = meta["was_locked"]
    frm = meta["framer"]
    sess.framer.history = z["framer_history"].astype(np.uint8)
    sess.framer.shifting = frm["shifting"]
    sess.framer.inverted = frm["inverted"]
    sess.framer.bit_idx = frm["bit_idx"]
    sess.framer.byte = frm["byte"]
    sess.framer.frame = list(frm["frame"])
    sess.framer.frame_time = frm["frame_time"]
    return sess

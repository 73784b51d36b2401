#!/usr/bin/env python3
"""Upsample level vs decode success for the upsampling clock-recovery
variants.

Counterpart of the JAX package's ``tools/study_upsampling.py``: the
reproduction of the reference's
``standalone_matlab/Functionized/MM_interplevel_vs_success.png`` evidence.
It sweeps upsample level x kind (``cubic``, ``linear``) x clock
(``upsampling_gardner``, ``upsampling_mm``) over a synthesized POES
recording, runs each configuration through the port's exact chunked chain
(:class:`DemodSession`, one lane, on the card unless ``--device cpu``),
counts the frames whose payload is one of those sent, and writes
``upsampling_levels.json`` (the JAX tool's keys and rows) and
``upsampling_levels.png`` into ``--out-dir``.

    python -m project_desert_tortoise_tpu_torch.tools.study_upsampling \\
        [--frames 8] [--snr 16] [--levels 1,2,3,4,6,8] \\
        [--out-dir study_upsampling] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from project_desert_tortoise_tpu_torch.models.demodulator import DemodSession
from project_desert_tortoise_tpu_torch.utils import synth, wav as W
from project_desert_tortoise_tpu_torch.utils.config import FIRConfig, POES_TIP
from project_desert_tortoise_tpu_torch.utils.png import render_series_png

FS = 50000.0
NORM_FACTOR = 17.58
ALGORITHMS = ("upsampling_gardner", "upsampling_mm")
KINDS = ("cubic", "linear")


def study_config(alg: str, kind: str, level: int):
    """POES TIP with a plain lowpass at the input rate (interp 1) and the
    clock `alg` on the stream upsampled `level` x by `kind` (the JAX tool's
    configuration)."""
    return dataclasses.replace(
        POES_TIP,
        fir=FIRConfig(cutoff_hz=11000.0, base_order=26,
                      target_rate_hz=None, interp=1),
        gardner=dataclasses.replace(
            POES_TIP.gardner, algorithm=alg, upsample_level=level,
            upsample_kind=kind, gain=1.0, error_limit=2.0))


def run_case(alg: str, kind: str, level: int, iq, t, device="cuda"):
    """One configuration's session over the recording (``quirks=False``, the
    tool's fixed norm factor); returns its DemodResult."""
    return DemodSession(study_config(alg, kind, level), FS, quirks=False,
                        norm_factor=NORM_FACTOR, device=device).run(iq, t)


def frames_ok(res, sent) -> int:
    """The complete frames of `res` whose payload is one of `sent`."""
    sset = {bytes(f) for f in sent}
    return sum(1 for f in res.frames if f.complete
               and np.asarray(f.data, np.uint8).tobytes() in sset)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="study_upsampling")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--snr", type=float, default=16.0)
    ap.add_argument("--levels", default="1,2,3,4,6,8")
    ap.add_argument("--out-dir", default="study_upsampling")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    iq, sent = synth.make_poes_recording(n_frames=args.frames, fs=FS,
                                         snr_db=args.snr)
    t = W.time_axis(len(iq), FS, np.float32)
    levels = [int(x) for x in args.levels.split(",")]

    rows = []
    for alg in ALGORITHMS:
        for kind in KINDS:
            for lv in levels:
                ok = frames_ok(run_case(alg, kind, lv, iq, t, args.device),
                               sent)
                rows.append({"algorithm": alg, "kind": kind, "level": lv,
                             "frames_sent": args.frames,
                             "frames_ok": ok,
                             "success": round(ok / args.frames, 3)})
                print(json.dumps(rows[-1]), flush=True)

    os.makedirs(args.out_dir, exist_ok=True)
    meta = {"snr_db": args.snr, "fs": FS, "mode": "poes_tip interp=1",
            "note": "decode success vs upsample level; twin of "
                    "MM_interplevel_vs_success.png", "rows": rows}
    with open(os.path.join(args.out_dir, "upsampling_levels.json"),
              "w") as f:
        json.dump(meta, f, indent=1)

    series = {}
    for alg in ALGORITHMS:
        for kind in KINDS:
            pts = [(r["level"], r["success"]) for r in rows
                   if r["algorithm"] == alg and r["kind"] == kind]
            series[f"{alg.split('_')[1]}/{kind}"] = (
                [p[0] for p in pts], [p[1] for p in pts])
    render_series_png(os.path.join(args.out_dir, "upsampling_levels.png"),
                      series, title="decode success vs upsample level",
                      xlabel="upsample level L", ylabel="success fraction",
                      markers=True)
    print("wrote", args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

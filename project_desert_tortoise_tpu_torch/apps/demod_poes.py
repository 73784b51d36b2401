"""CLI: POES TIP file demodulator, PyTorch/CUDA port.

Same flags as ``project_desert_tortoise_tpu/apps/demod_poes.py`` (the
reference ``demodPOES``, ``POESTIPdemod/main.c:185-234``) plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain PyTorch versions).
Without ``--fast`` it runs the exact chunked chain
(``models/demodulator.py::DemodSession``) in the mode's dtype, with its
options ``-r``, ``-c``, ``--no-quirks`` and ``--timebase`` and the
reference's stderr progress line; ``--fast`` runs the block-parallel path
on its scan branch (``demodulate_blocked``'s default ``use_pallas=False``,
the branch the JAX CLI's ``--fast`` runs: the PLL, AGC and windowed
Gardner/Manchester kernels).  ``--products DIR`` then runs the telemetry explorer
(``apps/telemetry_explorer.py``) on the frames file, after either path.
``apps/demod_argos.py`` runs the same with the ARGOS modes.  Refused (exit
2, with a message): the exact chain's options together with ``--fast``.

    python -m project_desert_tortoise_tpu_torch.apps.demod_poes X.wav
    python -m project_desert_tortoise_tpu_torch.apps.demod_poes X.wav --fast
    python -m project_desert_tortoise_tpu_torch.apps.demod_poes X.wav \
        --products products/
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser(prog: str, default_mode: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("infile")
    p.add_argument("-s", dest="sample_rate_khz", type=float, default=0.0,
                   help="sample rate in kHz (required for .raw)")
    p.add_argument("-r", dest="raw_taps", action="store_true",
                   help="dump post-AGC raw debug stream to output.raw")
    p.add_argument("-n", dest="norm_factor", type=float, default=0.0,
                   help="static gain override")
    p.add_argument("-c", dest="chunk_size", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--fast", action="store_true",
                   help="block-parallel path on the scan branch "
                        "(frame-level parity)")
    p.add_argument("--no-quirks", action="store_true",
                   help="chunk-size-invariant exact mode")
    p.add_argument("--timebase", default="accumulated",
                   choices=["accumulated", "integer"],
                   help="'integer' (implies --no-quirks): exact n*Ts "
                        "timestamps from an int64 sample counter instead "
                        "of the reference's drifting f32 accumulated fold")
    p.add_argument("--mode", default=default_mode)
    p.add_argument("--products", default=None, metavar="DIR",
                   help="also run the telemetry explorer on the decoded "
                        "frames")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N; cpu runs the kernels' "
                        "plain versions)")
    return p


def run(argv=None, default_mode="poes_tip", prefix="minorFrames"):
    args = build_parser(f"demod_{default_mode}", default_mode).parse_args(argv)
    exact_only = [flag for flag, given in (
        ("-r", args.raw_taps), ("-c", args.chunk_size),
        ("--no-quirks", args.no_quirks),
        ("--timebase", args.timebase != "accumulated")) if given]
    if args.fast and exact_only:
        print(f"{', '.join(exact_only)}: options of the exact chunked "
              "chain, which runs without --fast", file=sys.stderr)
        return 2
    from project_desert_tortoise_tpu_torch.models.registry import get_mode
    from project_desert_tortoise_tpu_torch.utils import output as O
    from project_desert_tortoise_tpu_torch.utils import wav as W

    mode = get_mode(args.mode)
    t0 = time.time()
    if args.infile.lower().endswith(".raw"):
        if args.sample_rate_khz < 1:
            print("Sample Rate (in Khz) must be specified when using RAW files")
            return 1
        if mode.name.startswith("argos"):
            # the reference ARGOS app rejects RAW input
            # (ARGOSdemod/main.c:237-239); the shared RAW reader is
            # mode-agnostic, so it is accepted, with notice
            print("note: RAW input for ARGOS is a framework extension "
                  "(the reference demodARGOS accepts wav only)",
                  file=sys.stderr)
        iq, t, fs = W.load_iq_raw(args.infile, args.sample_rate_khz * 1000.0,
                                  mode.np_dtype())
    else:
        iq, t, fs, hdr = W.load_iq_wav(args.infile, mode.np_dtype(),
                                       args.sample_rate_khz)
        print(f"Sample Rate {fs/1000.0:.2f}KHz and {hdr.bits_per_sample} bits "
              f"per sample. Total samples {len(iq)}")

    out_path = args.out or O.default_output_name(prefix)
    if args.fast:
        from project_desert_tortoise_tpu_torch.parallel.blocked import (
            demodulate_blocked)
        frames = demodulate_blocked(iq, t, fs, mode,
                                    norm_factor=args.norm_factor or None,
                                    device=args.device)
        with O.FrameWriter(out_path,
                           inverted_mark=mode.framer.inverted_mark) as w:
            w.write_all(frames)
        print(f"\n{len(frames)} frames -> {out_path}")
    else:
        run_exact(args, mode, iq, t, fs, out_path)
    print(f"That took {time.time()-t0:.2f} seconds!")
    if args.products:
        from project_desert_tortoise_tpu_torch.apps import telemetry_explorer
        telemetry_explorer.run([out_path, "--outdir", args.products])
    return 0


def run_exact(args, mode, iq, t, fs: float, out_path: str) -> None:
    """The exact chunked chain over the recording, as the reference's
    chunk loop (``POESTIPdemod/main.c:373-492``): frames written as they
    complete, the progress line on stderr after each chunk."""
    from project_desert_tortoise_tpu_torch.models.demodulator import (
        DemodSession)
    from project_desert_tortoise_tpu_torch.utils import metrics as M
    from project_desert_tortoise_tpu_torch.utils import output as O

    sess = DemodSession(mode, fs, chunk_size=args.chunk_size or None,
                        norm_factor=args.norm_factor or None,
                        quirks=(not args.no_quirks
                                and args.timebase != "integer"),
                        timebase=args.timebase, device=args.device)
    raw_f = open("output.raw", "wb") if args.raw_taps else None
    sess.raw_tap = raw_f
    with O.FrameWriter(out_path, inverted_mark=mode.framer.inverted_mark) as w:
        n = len(iq)
        ts = mode.np_dtype().type(1.0) / mode.np_dtype().type(fs)
        t_ext = np.concatenate([t, [t[-1] + ts] if n else [ts]])
        chunk = sess.chunk_size
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            frames = sess.process(iq[start:end], t[start:end],
                                  t_ext[start + 1:end + 1].astype(sess.dtype))
            w.write_all(frames)
            q = M.quality_db(sess.avg_phase)
            sys.stderr.write("\r" + M.progress_line(
                100.0 * end / max(n, 1), end / 1000.0, float(t[end - 1]),
                sess.total_symbols, sess.total_bits, len(sess.framer.frames),
                q))
        tail = sess.framer.flush()
        if tail is not None:
            w.write(tail)
        sys.stderr.write("\n")
        if sess.lock_freq_hz is not None:
            print(f"PLL locked at {sess.lock_freq_hz:.2f}Hz")
    if raw_f is not None:
        raw_f.close()


def main():
    raise SystemExit(run())


if __name__ == "__main__":
    main()

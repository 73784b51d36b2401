"""CLI: POES TIP file demodulator, PyTorch/CUDA port.

Same flags as ``project_desert_tortoise_tpu/apps/demod_poes.py`` (the
reference ``demodPOES``, ``POESTIPdemod/main.c:185-234``) plus ``--device``
(default ``cuda``).  ``--fast`` runs the block-parallel path on the fused
CUDA kernel (its plain PyTorch version with ``--device cpu``);
``apps/demod_argos.py`` runs the same with the ARGOS mode.  The exact
chunked chain (no ``--fast``), its options (``-r``, ``-c``, ``--no-quirks``,
``--timebase``) and ``--products`` are not ported yet: they exit 2 with a
message.

    python -m project_desert_tortoise_tpu_torch.apps.demod_poes X.wav --fast
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser(prog: str, default_mode: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("infile")
    p.add_argument("-s", dest="sample_rate_khz", type=float, default=0.0,
                   help="sample rate in kHz (required for .raw)")
    p.add_argument("-r", dest="raw_taps", action="store_true",
                   help="dump post-AGC raw debug stream to output.raw "
                        "(exact chain only)")
    p.add_argument("-n", dest="norm_factor", type=float, default=0.0,
                   help="static gain override")
    p.add_argument("-c", dest="chunk_size", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--fast", action="store_true",
                   help="block-parallel path on the fused kernel "
                        "(frame-level parity)")
    p.add_argument("--no-quirks", action="store_true",
                   help="chunk-size-invariant exact mode")
    p.add_argument("--timebase", default="accumulated",
                   choices=["accumulated", "integer"],
                   help="exact-chain timestamp base")
    p.add_argument("--mode", default=default_mode)
    p.add_argument("--products", default=None, metavar="DIR",
                   help="also run the telemetry explorer on the decoded "
                        "frames")
    p.add_argument("--device", default="cuda",
                   help="torch device of the fast path (cuda, cuda:N, cpu)")
    return p


def run(argv=None, default_mode="poes_tip", prefix="minorFrames"):
    args = build_parser(f"demod_{default_mode}", default_mode).parse_args(argv)
    if not args.fast:
        print("the exact chunked chain is not ported to PyTorch yet; "
              "run with --fast (block-parallel path)", file=sys.stderr)
        return 2
    if args.products:
        print("--products (telemetry explorer) is not ported to PyTorch "
              "yet", file=sys.stderr)
        return 2
    exact_only = [flag for flag, given in (
        ("-r", args.raw_taps), ("-c", args.chunk_size),
        ("--no-quirks", args.no_quirks),
        ("--timebase", args.timebase != "accumulated")) if given]
    if exact_only:
        print(f"{', '.join(exact_only)}: options of the exact chunked chain, "
              "which is not ported to PyTorch yet", file=sys.stderr)
        return 2
    from project_desert_tortoise_tpu_torch.models.registry import get_mode
    from project_desert_tortoise_tpu_torch.parallel.blocked import (
        demodulate_blocked)
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
    frames = demodulate_blocked(iq, t, fs, mode,
                                norm_factor=args.norm_factor or None,
                                device=args.device)
    with O.FrameWriter(out_path, inverted_mark=mode.framer.inverted_mark) as w:
        w.write_all(frames)
    print(f"\n{len(frames)} frames -> {out_path}")
    print(f"That took {time.time()-t0:.2f} seconds!")
    return 0


def main():
    raise SystemExit(run())


if __name__ == "__main__":
    main()

"""CLI: process decoded minor frames into instrument products.

The port's own copy of
``project_desert_tortoise_tpu/apps/telemetry_explorer.py``: numpy only, as
the port imports nothing of the JAX package.

The downstream workflow of the MATLAB prototype (POES.m) as one command:

    pdt-telemetry minorFrames_*.txt --outdir products/

writes:
- ``summary.txt``      — parity score, spacecraft, day/T0, quality breakdown
- ``DCS_RAW.txt``      — all DCS-2 packets (POES.m:1030 format)
- ``DCS_summary.txt``  — per-TXID packet counts (POES.m:1298)
- ``<TXID>.txt``       — per-platform packet files (POES.m:1216)
- ``HIRS<n>.png``      — 20 channel images (POES.m:855)
- ``SEM_MEPED.txt`` / ``SEM_TED.txt`` / ``SBUV.txt`` — channel dumps
- ``analog.txt`` + figure PNGs — the MATLAB prototype's plot products
  rendered without matplotlib (utils/png.py): analog transmitter powers
  (POES.m:513), SEM MEPED/TED channel groups (POES.m:1314-1779), SBUV
  grating position / cloud cover (POES.m:1780-1972)
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def run(argv=None):
    p = argparse.ArgumentParser(prog="pdt-telemetry")
    p.add_argument("frames_txt")
    p.add_argument("--outdir", default="telemetry_products")
    p.add_argument("--no-per-txid", action="store_true",
                   help="skip the per-platform files (they can be many)")
    args = p.parse_args(argv)

    from project_desert_tortoise_tpu_torch.telemetry import tip
    from project_desert_tortoise_tpu_torch.telemetry.minorframes import (
        check_parity, daytime_decode)
    from project_desert_tortoise_tpu_torch.utils.output import (
        parse_frames_file)
    from project_desert_tortoise_tpu_torch.utils.png import (
        autoscale_u8, render_series_png, write_gray_png)

    rows = parse_frames_file(args.frames_txt)
    frames = np.array([r[2] for r in rows if len(r[2]) == 104], np.uint8)
    times = np.array([r[0] for r in rows if len(r[2]) == 104])
    if not len(frames):
        print("no complete 104-byte frames in input")
        return 1
    os.makedirs(args.outdir, exist_ok=True)

    good, errs = check_parity(frames)
    info = daytime_decode(frames, times)
    with open(os.path.join(args.outdir, "summary.txt"), "w") as f:
        f.write(f"{int(good.sum())} out of {len(frames)} Error Free Frames\n")
        f.write(f"Spacecraft: {info.spacecraft_id} => {info.spacecraft_name}\n")
        if info.julian_day is not None:
            f.write(f"Julian Day: {info.julian_day}\n")
        if info.t0_ms_best is not None:
            ms = info.t0_ms_best
            f.write(f"T0 Best Guess: {ms:.0f} ms "
                    f"({int(ms // 3600000)}:{int(ms % 3600000 // 60000)}:"
                    f"{ms % 60000 / 1000.0:.3f})\n")
        f.write(f"Parity group errors: {errs.sum(axis=0).tolist()}\n")
    print(f"{int(good.sum())} / {len(frames)} error-free frames; "
          f"{info.spacecraft_name}")

    # DCS
    packets = tip.dcs_extract(frames, times,
                              spacecraft=info.spacecraft_id)
    with open(os.path.join(args.outdir, "DCS_RAW.txt"), "w") as f:
        for i, pk in enumerate(packets):
            body = "".join(f"{b:02X} " for b in pk.data)
            f.write(f"{i + 1:04d} {pk.time:09.4f} {body}\n")
    groups = tip.dcs_by_txid(packets)
    with open(os.path.join(args.outdir, "DCS_summary.txt"), "w") as f:
        for txid, pks in groups.items():
            f.write(f"{txid} {len(pks)}\n")
    if not args.no_per_txid:
        for txid, pks in groups.items():
            with open(os.path.join(args.outdir, f"{txid}.txt"), "w") as f:
                for i, pk in enumerate(pks):
                    body = "".join(f"{b:02X} " for b in pk.data)
                    star = "" if pk.parity_ok else "*"
                    f.write(f"{i + 1:04d} {pk.time:09.4f} {body}"
                            f"{pk.counter_s:011.5f} {star}{pk.doppler:012.5f}\n")
    print(f"DCS: {len(packets)} packets from {len(groups)} platforms")

    # HIRS images
    h = tip.hirs_extract(frames, times)
    img = tip.hirs_images(h)
    for ch in range(20):
        write_gray_png(os.path.join(args.outdir, f"HIRS{ch + 1}.png"),
                       autoscale_u8(np.flipud(img[ch])))
    print(f"HIRS: {img.shape[1]} scan lines x 20 channels "
          f"({int(h.parity_ok.sum())} parity-clean frames)")

    # SEM + SBUV dumps
    meped, ted = tip.sem_extract(frames)
    with open(os.path.join(args.outdir, "SEM_MEPED.txt"), "w") as f:
        for ch in sorted(meped):
            f.write(f"{ch}: {tip.despike(meped[ch]).tolist()}\n")
    with open(os.path.join(args.outdir, "SEM_TED.txt"), "w") as f:
        for ch in sorted(ted):
            f.write(f"{ch}: {tip.despike(ted[ch]).tolist()}\n")
    sb = tip.sbuv_extract(frames, times)
    with open(os.path.join(args.outdir, "SBUV.txt"), "w") as f:
        for name, d in sb.items():
            f.write(f"{name}: w1={d['word1'].tolist()} "
                    f"w2={d['word2'].tolist()}\n")

    # analog subcom dump + figure products (the POES.m plot windows)
    analog = tip.analog_subcom(frames, times)
    with open(os.path.join(args.outdir, "analog.txt"), "w") as f:
        for name, tv in analog.items():
            f.write(f"{name}: t={tv[0].tolist()} v={tv[1].tolist()}\n")
    figs = {}

    def fig(fname, series, **kw):
        series = {k: v for k, v in series.items() if len(np.asarray(v[0]))}
        if series:
            render_series_png(os.path.join(args.outdir, fname), series, **kw)
            figs[fname] = len(series)

    fig("analog_telemetry.png",
        {k: (tv[0], tv[1]) for k, tv in analog.items()},
        title="Analog subcom (POES.m:513)", xlabel="time (s)",
        ylabel="counts")
    counts = lambda d, keys: {k: (np.arange(len(d[k])),
                                  tip.despike(d[k])) for k in keys if k in d}
    fig("SEM_MEPED_P0.png", counts(meped, [f"0P{i}" for i in range(1, 7)]),
        title="MEPED 0 deg protons", xlabel="subcom sample", ylabel="counts")
    fig("SEM_MEPED_P90.png", counts(meped, [f"9P{i}" for i in range(1, 7)]),
        title="MEPED 90 deg protons", xlabel="subcom sample", ylabel="counts")
    fig("SEM_MEPED_E.png",
        counts(meped, ["0E1", "0E2", "0E3", "9E1", "9E2", "9E3"]),
        title="MEPED electrons", xlabel="subcom sample", ylabel="counts")
    fig("SEM_MEPED_OMNI.png", counts(meped, ["P6", "P7", "P8", "P9"]),
        title="MEPED omni protons", xlabel="subcom sample", ylabel="counts")
    fig("SEM_TED_FLUX0.png", counts(ted, ["0EFL", "0PFL", "0EFH", "0PFH"]),
        title="TED 0 deg partial energy flux", xlabel="subcom sample",
        ylabel="counts")
    fig("SEM_TED_FLUX30.png", counts(ted, ["3EFL", "3PFL", "3EFH", "3PFH"]),
        title="TED 30 deg partial energy flux", xlabel="subcom sample",
        ylabel="counts")
    g = sb.get("grating_pos", {})
    if len(g.get("time", ())):
        fig("SBUV_grating.png",
            {"word 1": (g["time"], g["word1"]),
             "word 2": (g["time"], g["word2"])},
            title="SBUV grating position", xlabel="time (s)", ylabel="raw")
    c = sb.get("cloud_cover", {})
    if len(c.get("time", ())):
        fig("SBUV_cloud.png",
            {"word 1": (c["time"], c["word1"]),
             "word 2": (c["time"], c["word2"])},
            title="SBUV cloud cover radiometer", xlabel="time (s)",
            ylabel="raw")
    print(f"figures: {len(figs)} PNGs; products -> {args.outdir}/")
    return 0


def main():
    raise SystemExit(run())


if __name__ == "__main__":
    main()

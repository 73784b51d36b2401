"""TIP instrument dissectors: analog subcom, HIRS/4, DCS-2, SEM, SBUV/2.

The port's own copy of
``project_desert_tortoise_tpu/telemetry/tip.py``: numpy only, as
the port imports nothing of the JAX package.

Vectorized numpy twins of the MATLAB prototype's minor-frame payload
processing (``standalone_matlab/Functionized/POES.m:462-1972``) — the
downstream capabilities the C reference never got.  All byte positions below
are 0-based frame indices (the MATLAB source uses 1-based ``minorFrames(:,k+1)``
for byte k).

Inputs throughout: ``frames`` (n, 104) uint8 minor frames and optional
per-frame ``times`` (n,) — use telemetry.minorframes.frames_to_matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from project_desert_tortoise_tpu_torch.telemetry.minorframes import (
    daytime_decode)


def _minor_frame_ids(frames: np.ndarray) -> np.ndarray:
    f = frames.astype(np.uint16)
    return ((f[:, 4] & 1) << 8) | f[:, 5]


# --- analog telemetry subcom (POES.m:462-513) ------------------------------

_ANALOG_SUBCOM_1 = {  # byte 11, selected by 9-bit minor frame id
    "STX1": (48, 128, 208, 288),   # high-gain HRPT antenna power
    "STX2": (50, 130, 210, 290),   # OMNI HRPT antenna power
    "STX3": (40, 120, 200, 280),
}
_ANALOG_SUBCOM_2 = {  # byte 14
    "SARR_A": (114, 274),
    "SARR_B": (2, 162),
}


def analog_subcom(frames: np.ndarray, times: Optional[np.ndarray] = None
                  ) -> Dict[str, np.ndarray]:
    """16-second analog subcom telemetry points (transmitter powers)."""
    ids = _minor_frame_ids(frames)
    t = times if times is not None else np.arange(len(frames), dtype=float)
    out = {}
    for name, id_set in _ANALOG_SUBCOM_1.items():
        m = np.isin(ids, id_set)
        out[name] = np.stack([t[m], frames[m, 11].astype(float)])
    for name, id_set in _ANALOG_SUBCOM_2.items():
        m = np.isin(ids, id_set)
        out[name] = np.stack([t[m], frames[m, 14].astype(float)])
    return out


# --- HIRS/4 (POES.m:515-865) ----------------------------------------------

HIRS_BYTES = [16, 17, 22, 23, 26, 27, 30, 31, 34, 35, 38, 39, 42, 43,
              54, 55, 58, 59, 62, 63, 66, 67, 70, 71, 74, 75, 78, 79,
              82, 83, 84, 85, 88, 89, 92, 93]


@dataclasses.dataclass
class HIRSFrame:
    words: np.ndarray        # (n, 22) int16: word0/1 raw, 2..21 signed 12-bit
    parity_ok: np.ndarray    # (n,) bool: 288-bit odd parity
    scan_position: np.ndarray
    cal_level: np.ndarray
    element: np.ndarray      # 0-55 earth view
    times: np.ndarray


def hirs_extract(frames: np.ndarray,
                 times: Optional[np.ndarray] = None) -> HIRSFrame:
    """Unpack the embedded HIRS stream: 36 bytes/frame -> 22 13-bit words
    (+2 status bits), sign handling and odd-parity check per POES.m:641-697."""
    data = frames[:, HIRS_BYTES]                       # (n, 36)
    bits = np.unpackbits(data, axis=1)                 # (n, 288)
    n = len(frames)
    w13 = bits[:, :22 * 13].reshape(n, 22, 13)
    vals = np.zeros((n, 22), np.int64)
    for b in range(13):
        vals = (vals << 1) | w13[:, :, b]
    words = np.zeros((n, 22), np.int16)
    words[:, :2] = vals[:, :2].astype(np.int16)
    mag = (vals[:, 2:] & 4095).astype(np.int16)
    sign_bit = (vals[:, 2:] >> 12) & 1
    # POES.m:679-687: sign bit 0 -> negative magnitude, 1 -> positive
    words[:, 2:] = np.where(sign_bit == 0, -mag, mag)

    ones = bits[:, :287].sum(axis=1)                   # incl. data-valid bit
    parity_ok = ((ones % 2) == 0) & (bits[:, 287] == 1)

    t = times if times is not None else np.arange(n, dtype=float)
    scan_pos = (vals[:, 0] >> 5).astype(np.int32)
    cal_level = (vals[:, 0] & 31).astype(np.int32)
    element = ((vals[:, 1] >> 1) & 63).astype(np.int32)
    return HIRSFrame(words=words, parity_ok=parity_ok,
                     scan_position=scan_pos, cal_level=cal_level,
                     element=element, times=np.asarray(t))


def hirs_images(h: HIRSFrame, trusted_only: bool = False) -> np.ndarray:
    """Assemble per-channel scan images: (20, n_scans, 64) uint16.

    Rows are 6.4-second scan periods (POES.m:779); columns elements 0-63
    (0-55 earth view); channels are HIRS words 3..22 offset by +4096."""
    if len(h.times) == 0:
        return np.zeros((20, 0, 64), np.uint16)
    rows = np.floor((h.times - h.times[0] + 1.5) / 6.4).astype(int)
    n_rows = rows.max() + 1 if len(rows) else 0
    img = np.zeros((20, n_rows, 64), np.uint16)
    sel = h.parity_ok if trusted_only else np.ones(len(rows), bool)
    for i in np.nonzero(sel)[0]:
        e = h.element[i]
        if e < 64:
            img[:, rows[i], e] = (h.words[i, 2:22].astype(np.int32) + 4096
                                  ).astype(np.uint16)
    return img


# --- DCS-2 (POES.m:868-1311) ----------------------------------------------

DCS_BYTES = [18, 19, 24, 25, 28, 29, 32, 33, 40, 41, 44, 45, 52, 53,
             56, 57, 60, 61, 64, 65, 68, 69, 72, 73, 76, 77, 86, 87,
             90, 91, 94, 95]

_DCS_LEN_NIBBLE = {0x0: 16, 0x3: 20, 0x5: 24, 0x6: 28, 0x9: 32, 0xA: 36,
                   0xC: 40, 0xF: 44}


@dataclasses.dataclass
class DCSPacket:
    time: float              # stream-local time at the packet start
    txid: str                # 4-byte platform id, hex
    data: np.ndarray         # packet bytes starting at the 0xD6 header
    counter_s: float         # 20-bit platform time counter, seconds
    doppler: float           # 23-bit signed measurement word / 32
    parity_ok: bool


def dcs_unroll(frames: np.ndarray, times: Optional[np.ndarray] = None):
    """Interleave the 32 DCS bytes per frame into one stream (POES.m:948)."""
    stream = frames[:, DCS_BYTES].reshape(-1)
    if times is not None:
        tt = np.repeat(np.asarray(times), len(DCS_BYTES))
    else:
        tt = np.arange(len(stream), dtype=float)
    return stream, tt


def dcs_extract(frames: np.ndarray, times: Optional[np.ndarray] = None,
                spacecraft: Optional[int] = None) -> List[DCSPacket]:
    """Find 0xD6-headed DCS-2 packets and dissect them (POES.m:934-1289).

    A packet starts where a 0xD6 byte is followed by a byte below the
    channel-count bound (9 on NOAA-19 / ADCS spacecraft, 8 otherwise)."""
    if spacecraft is None:
        spacecraft = daytime_decode(frames).spacecraft_id
    byte2_max = 9 if spacecraft == 15 else 8
    stream, tt = dcs_unroll(frames, times)
    n = len(stream)

    is_d6 = stream == 0xD6
    follows = np.zeros(n, bool)
    follows[1:] = is_d6[:-1] & (stream[1:] < byte2_max)
    starts = np.nonzero(follows)[0] - 1      # position of the 0xD6 byte
    packets: List[DCSPacket] = []
    for k, p in enumerate(starts):
        nxt = starts[k + 1] if k + 1 < len(starts) else n
        if p + 10 > nxt or p + 10 > n:
            continue
        nibble = int(stream[p + 2]) >> 4
        numbytes = _DCS_LEN_NIBBLE.get(nibble, 44)
        end = min(p + numbytes, nxt, n)
        data = stream[p:end].copy()
        txid = "".join(f"{b:02X}" for b in stream[p + 6:p + 10])
        counter = (((int(stream[p + 3]) & 0x1F) << 16)
                   | (int(stream[p + 4]) << 8) | int(stream[p + 5]))
        counter_s = 0.9549 * counter / 100.0
        pw = 0
        if p + numbytes - 1 < n:
            last3 = ((int(stream[p + numbytes - 3]) << 16)
                     | (int(stream[p + numbytes - 2]) << 8)
                     | int(stream[p + numbytes - 1]))
            pw = bin(last3).count("1")
            doppler = ((last3 >> 1) - 2 ** 22) / 32.0
        else:
            doppler = float("nan")
        packets.append(DCSPacket(
            time=float(tt[max(p - 1, 0)]), txid=txid, data=data,
            counter_s=counter_s, doppler=doppler, parity_ok=(pw % 2 == 0)))
    return packets


def dcs_by_txid(packets: List[DCSPacket]) -> Dict[str, List[DCSPacket]]:
    """Group packets per transmitter, most active first (POES.m:1162-1311)."""
    out: Dict[str, List[DCSPacket]] = {}
    for p in packets:
        out.setdefault(p.txid, []).append(p)
    return dict(sorted(out.items(), key=lambda kv: -len(kv[1])))


# --- SEM: MEPED + TED (POES.m:1314-1779) -----------------------------------

def _sem_bytes(frames: np.ndarray) -> np.ndarray:
    # SEM bytes arrive inverted (POES.m:1317-1318)
    return 255 - frames[:, 20:22].astype(np.int32)


_MEPED_MOD20 = {  # subcom position -> (channel using byte0, channel using byte1)
    0: (None, "0P1"), 1: ("0P2", "0P3"), 2: ("0P4", "0P5"),
    3: ("0P6", "0E1"), 4: ("0E2", "0E3"), 5: ("9P1", "9P2"),
    6: ("9P3", "9P4"), 7: ("9P5", "9P6"), 8: ("9E1", "9E2"),
    9: ("9E3", "P6"), 10: ("P7", None),
}

_TED_MOD20 = {
    13: ("0EFL", "3EFL"), 14: ("0PFL", "3PFL"), 15: ("0EFH", "3EFH"),
    16: ("0PFH", "3PFH"), 19: ("3DEM", "3DPM"),
}


def sem_extract(frames: np.ndarray):
    """Demultiplex SEM MEPED and TED channels from the 20/40/80-frame subcom.

    Returns (meped, ted): dicts channel -> int array of counts in subcom
    order.  MEPED: directional proton (P1-P6) / electron (E1-E3) counts at 0
    and 90 degrees plus omni protons P6-P9; TED: partial energy fluxes,
    max differential flux + its energy, 4-point spectra, backgrounds."""
    ids = _minor_frame_ids(frames)
    sem = _sem_bytes(frames)
    meped: Dict[str, List[int]] = {}
    ted: Dict[str, List[int]] = {}

    def add(d, key, val):
        if key is not None:
            d.setdefault(key, []).append(int(val))

    for i, fid in enumerate(ids):
        fid = int(fid)
        m20 = fid % 20
        if m20 in _MEPED_MOD20:
            k0, k1 = _MEPED_MOD20[m20]
            add(meped, k0, sem[i, 0])
            add(meped, k1, sem[i, 1])
        if (fid - 10) % 40 == 0:
            add(meped, "P8", sem[i, 1])
        if (fid - 30) % 40 == 0:
            add(meped, "P9", sem[i, 1])

        if m20 in _TED_MOD20:
            k0, k1 = _TED_MOD20[m20]
            add(ted, k0, sem[i, 0])
            add(ted, k1, sem[i, 1])
        elif m20 == 17:
            add(ted, "0EM", (sem[i, 0] >> 4) & 0xF)
            add(ted, "0PM", sem[i, 0] & 0xF)
            add(ted, "0DEM", sem[i, 1])
        elif m20 == 18:
            add(ted, "0DPM", sem[i, 0])
            add(ted, "3EM", (sem[i, 1] >> 4) & 0xF)
            add(ted, "3PM", sem[i, 1] & 0xF)
        if (fid - 11) % 80 == 0:
            add(ted, "0DE1", sem[i, 0]); add(ted, "0DE2", sem[i, 1])
        if (fid - 31) % 80 == 0:
            add(ted, "3DE1", sem[i, 0]); add(ted, "3DE2", sem[i, 1])
        if (fid - 12) % 80 == 0:
            add(ted, "0DE3", sem[i, 0]); add(ted, "0DE4", sem[i, 1])
        if (fid - 32) % 80 == 0:
            add(ted, "3DE3", sem[i, 0]); add(ted, "3DE4", sem[i, 1])
        if fid in (51, 131, 211):
            add(ted, "0DP1", sem[i, 0]); add(ted, "0DP2", sem[i, 1])
        if fid in (71, 151, 231):
            add(ted, "3DP1", sem[i, 0]); add(ted, "3DP2", sem[i, 1])
        if fid in (52, 132, 212):
            add(ted, "0DP3", sem[i, 0]); add(ted, "0DP4", sem[i, 1])
        if fid in (72, 152, 232):
            add(ted, "3DP3", sem[i, 0]); add(ted, "3DP4", sem[i, 1])
        if fid == 291:
            add(ted, "0EBKL", sem[i, 0]); add(ted, "0EBKH", sem[i, 1])
        if fid == 292:
            add(ted, "0PBKL", sem[i, 0]); add(ted, "0PBKH", sem[i, 1])
        if fid == 311:
            add(ted, "3PBKL", sem[i, 1])
        if fid == 312:
            add(ted, "3PBKH", sem[i, 1])

    to_np = lambda d: {k: np.asarray(v, np.int32) for k, v in d.items()}
    return to_np(meped), to_np(ted)


def despike(x: np.ndarray, threshold: int = 20) -> np.ndarray:
    """SEM single-sample glitch filter (POES.m:1379-1490): zero samples that
    jump more than `threshold` from BOTH neighbors."""
    x = np.asarray(x).astype(np.int32)
    if len(x) < 3:
        return x.copy()
    out = x.copy()
    # sequential in-place semantics, as the MATLAB loops modify the array
    # they read from
    for i in range(1, len(out) - 1):
        if (abs(int(out[i - 1]) - int(out[i])) > threshold
                and abs(int(out[i + 1]) - int(out[i])) > threshold):
            out[i] = 0
    return out


# --- SBUV/2 (POES.m:1780-1972) ---------------------------------------------

SBUV_LINE_NAMES = ["status1", "status2", "analog_sub_mux", "memory_verify",
                   "status3", "status4", "grating_pos", "cloud_cover",
                   "radiometric_dc", "spare"]


def sbuv_extract(frames: np.ndarray, times: Optional[np.ndarray] = None):
    """Demux the two 16-bit SBUV words (bytes 36-37 and 80-81) over the
    10-minor-frame subcom.  Returns dict line-name -> (word1, word2, time,
    frame_index) arrays."""
    ids = _minor_frame_ids(frames)
    f = frames.astype(np.uint16)
    w1 = (f[:, 36] << 8) | f[:, 37]
    w2 = (f[:, 80] << 8) | f[:, 81]
    t = times if times is not None else np.arange(len(frames), dtype=float)
    out = {}
    for line in range(10):
        m = (ids % 10) == line
        out[SBUV_LINE_NAMES[line]] = {
            "word1": w1[m], "word2": w2[m], "time": np.asarray(t)[m],
            "frame_index": np.nonzero(m)[0],
        }
    return out

"""IQ ingest: 2-channel WAV and 32-bit-float RAW readers.

Behavioral twin of the reference reader (``common/wave.c``): canonical 44-byte
RIFF header parsed field-by-field little-endian (``wave.c:303-378``), I channel
first / Q second (``wave.c:159-166``), PCM normalized by 128 / 32768 / 2^31
(``wave.c:109-124``), and a synthesized time axis that starts at ``Ts`` and
accumulates in the stream dtype (``wave.c:167-168`` — ``time += Ts`` before the
first store, with float32 sequential accumulation when the mode runs float32).

Unlike the reference this reads whole files (or memory-mapped slices) in bulk;
the chunked-streaming behavior lives in the chain driver, which slices these
arrays.  This is the port's own copy of the JAX package's ``utils/wav.py``
(numpy only).

Deviations from the reference, on purpose:
- 32-bit PCM WAVs are converted correctly; the reference truncates each 32-bit
  sample through an ``int16_t`` (``wave.c:93`` vs ``wave.c:141``), which
  produces garbage for such files.
- Reads never trust ``data_size`` (the reference also reads to EOF).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np


@dataclasses.dataclass
class WavHeader:
    riff: bytes
    overall_size: int
    wave: bytes
    fmt_marker: bytes
    length_of_fmt: int
    format_type: int
    channels: int
    sample_rate: int
    byterate: int
    block_align: int
    bits_per_sample: int
    data_marker: bytes
    data_size: int

    @property
    def num_samples(self) -> int:
        return (8 * self.data_size) // (self.channels * self.bits_per_sample)

    @property
    def duration_s(self) -> float:
        return self.overall_size / self.byterate

    def describe(self) -> str:
        """Human-readable header dump (twin of ``wave.c:9`` printHeaderInfo)."""
        fmt = {1: "PCM", 6: "A-law", 7: "Mu-law"}.get(self.format_type, "?")
        dur = self.duration_s
        return "\n".join([
            f"(1-4): {self.riff.decode(errors='replace')}",
            f"(5-8) Overall size: bytes:{self.overall_size}, "
            f"Kb:{self.overall_size // 1024}",
            f"(21-22) Format type: {self.format_type} {fmt}",
            f"(23-24) Channels: {self.channels}",
            f"(25-28) Sample rate: {self.sample_rate}",
            f"(29-32) Byte Rate: {self.byterate}, Bit Rate:{self.byterate * 8}",
            f"(35-36) Bits per sample: {self.bits_per_sample}",
            f"(41-44) Size of data chunk: {self.data_size}",
            f"Number of samples:{self.num_samples}",
            f"Approx.Duration in seconds={dur:f}",
            f"Approx.Duration in h:m:s={seconds_to_time(dur)}",
        ])


def seconds_to_time(raw_seconds: float) -> str:
    """hh:mm:ss.ms formatting (twin of ``wave.c:386``)."""
    hours = int(raw_seconds) // 3600
    res = int(raw_seconds) % 3600
    minutes, seconds = res // 60, res % 60
    ms = int(round((raw_seconds - int(raw_seconds)) * 1000))
    return f"{hours}:{minutes}:{seconds}.{ms}"


def read_wav_header(raw: bytes) -> WavHeader:
    """Parse the fixed 44-byte canonical header, as ``wave.c:303`` does.

    Returns (header, data_offset) semantics via `data_offset_of`: the
    reference assumes the data chunk starts at byte 44; real SDR recorders
    often insert LIST/fact chunks, so `load_iq_wav` walks chunks when the
    canonical layout doesn't hold.
    """
    if len(raw) < 44:
        raise ValueError("file shorter than a canonical RIFF header")
    (riff, overall, wave, fmtm, lfmt, ftype, ch, rate, brate, balign, bps,
     datam, dsize) = struct.unpack("<4sI4s4sIHHIIHH4sI", raw[:44])
    return WavHeader(riff, overall, wave, fmtm, lfmt, ftype, ch, rate, brate,
                     balign, bps, datam, dsize)


def data_offset_of(raw: bytes, header: WavHeader) -> int:
    """Byte offset of IQ data.  Canonical files: 44 (what the reference
    assumes).  Otherwise walk RIFF chunks to the 'data' chunk and patch
    `header.data_size` accordingly."""
    if header.data_marker == b"data":
        return 44
    pos = 12
    while pos + 8 <= len(raw):
        tag = raw[pos:pos + 4]
        (size,) = struct.unpack("<I", raw[pos + 4:pos + 8])
        if tag == b"data":
            header.data_marker = b"data"
            header.data_size = size
            return pos + 8
        pos += 8 + size + (size & 1)
    raise ValueError("no 'data' chunk found in RIFF file")


def _pcm_to_float(data: np.ndarray, bits: int, dtype) -> np.ndarray:
    if bits == 16:
        return (data.view("<i2").astype(dtype)) / dtype.type(32768)
    if bits == 8:
        # wave.c:154 keeps the raw unsigned byte value and divides by 128.
        return (data.astype(dtype)) / dtype.type(128)
    if bits == 32:
        return (data.view("<i4").astype(dtype)) / dtype.type(2147483648)
    raise ValueError(f"unsupported bits_per_sample: {bits}")


def time_axis(n: int, fs: float, dtype, t0=None) -> np.ndarray:
    """Reference time base: t[i] = fold(t[i-1] + Ts) in stream dtype.

    ``np.add.accumulate`` is a strict sequential left fold, matching the C
    accumulation ``time += Ts`` (``wave.c:167``) rounding-for-rounding.
    """
    dtype = np.dtype(dtype)
    ts = dtype.type(1.0) / dtype.type(fs)
    steps = np.full(n, ts, dtype)
    if t0 is not None:
        if n == 0:
            return steps
        steps[0] = dtype.type(t0) + ts
    return np.add.accumulate(steps, dtype=dtype)


def load_iq_wav(path: str, dtype=np.float32, sample_rate_override: float = 0.0):
    """Read a 2-channel PCM WAV into (iq complex, time, fs, header)."""
    dtype = np.dtype(dtype)
    with open(path, "rb") as f:
        raw = f.read()
    header = read_wav_header(raw)
    if header.channels != 2:
        raise ValueError("complex read requires 2 channels (I and Q)")
    if header.format_type != 1:
        raise ValueError("only PCM is currently supported")
    if sample_rate_override > 1:
        header.sample_rate = int(sample_rate_override)
    bytes_per_frame = header.channels * header.bits_per_sample // 8
    body = raw[data_offset_of(raw, header):]
    n = len(body) // bytes_per_frame
    data = np.frombuffer(body, np.uint8, count=n * bytes_per_frame)
    data = data.reshape(n, 2, header.bits_per_sample // 8)
    vals = _pcm_to_float(data.reshape(n * 2, -1), header.bits_per_sample, dtype)
    vals = vals.reshape(n, 2)
    iq = np.empty(n, np.complex64 if dtype == np.float32 else np.complex128)
    iq.real = vals[:, 0]
    iq.imag = vals[:, 1]
    t = time_axis(n, header.sample_rate, dtype)
    return iq, t, float(header.sample_rate), header


def load_iq_wav_int16(path: str, sample_rate_override: float = 0.0):
    """Read a 2-channel 16-bit PCM WAV as RAW int16 planes (re, im, fs,
    header) — the native samples ``wave.c:117`` divides by 32768.

    PCM-sourced pipelines (the E2E flat path, int16-staged serving) ship
    these planes to the device and convert there, halving host->device
    bytes with bit-identical results.
    """
    with open(path, "rb") as f:
        raw = f.read()
    header = read_wav_header(raw)
    if header.channels != 2:
        raise ValueError("complex read requires 2 channels (I and Q)")
    if header.format_type != 1 or header.bits_per_sample != 16:
        raise ValueError("int16 plane read requires 16-bit PCM")
    if sample_rate_override > 1:
        header.sample_rate = int(sample_rate_override)
    body = raw[data_offset_of(raw, header):]
    n = len(body) // 4
    data = np.frombuffer(body, "<i2", count=n * 2).reshape(n, 2)
    re = np.ascontiguousarray(data[:, 0])
    im = np.ascontiguousarray(data[:, 1])
    return re, im, float(header.sample_rate), header


def load_iq_raw(path: str, sample_rate_hz: float, dtype=np.float32):
    """SDR# RAW: interleaved 32-bit IEEE float I/Q, no normalization
    (``wave.c:413-540``)."""
    dtype = np.dtype(dtype)
    body = np.fromfile(path, "<f4")
    n = len(body) // 2
    vals = body[: 2 * n].astype(dtype).reshape(n, 2)
    iq = np.empty(n, np.complex64 if dtype == np.float32 else np.complex128)
    iq.real = vals[:, 0]
    iq.imag = vals[:, 1]
    t = time_axis(n, sample_rate_hz, dtype)
    return iq, t, float(sample_rate_hz)


def write_iq_wav(path: str, iq: np.ndarray, fs: int, bits: int = 16):
    """Write a canonical 2-channel PCM WAV (test fixtures / interop)."""
    if bits != 16:
        raise ValueError("only 16-bit write supported")
    n = len(iq)
    pcm = np.empty((n, 2), "<i2")
    pcm[:, 0] = np.clip(np.round(np.real(iq) * 32767), -32768, 32767)
    pcm[:, 1] = np.clip(np.round(np.imag(iq) * 32767), -32768, 32767)
    body = pcm.tobytes()
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(body), b"WAVE", b"fmt ", 16, 1,
        2, int(fs), int(fs) * 4, 4, 16, b"data", len(body))
    with open(path, "wb") as f:
        f.write(hdr + body)

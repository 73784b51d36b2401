"""Typed DSP configuration.

The reference configures each app with compile-time macro blocks
(``POESTIPdemod/main.c:32-118``, ``ARGOSdemod/main.c:27-65``) plus a
float/double switch in per-app ``config.h``.  Here each stage gets a frozen
dataclass; the two shipped modes (POES TIP, ARGOS) are module-level presets.

Loop gains are stored in the reference's "radians per second" convention and
scaled by ``2*pi/Fs`` at chain-assembly time, exactly as the reference does at
its call sites (``POESTIPdemod/main.c:413,429``), so configurations are
sample-rate independent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class PLLConfig:
    """Costas carrier-tracking PLL (reference ``common/CarrierTrackingPLL.c``)."""

    max_carrier_deviation_hz: float  # frequency clamp, +/- Hz
    acq_gain_rad_s: float            # acquisition loop bandwidth (rad/s)
    track_gain_rad_s: float          # tracking loop bandwidth (rad/s)
    lock_alpha_rad_s: float          # lock-detector EWMA rate (rad/s)
    lock_threshold: float            # locksig level that ends acquisition
    sweep_threshold: float = 0.05    # |pi/2 - avgPhase| gate for freq sweep
    sweep_rad_s2: float = 0.2        # acquisition sweep rate (rad/s^2)
    damping: float = 0.999
    avg_phase_alpha: float = 0.00005  # per-sample quality EWMA rate


@dataclasses.dataclass(frozen=True)
class FIRConfig:
    """Dynamic windowed-sinc lowpass + 1:N zero-stuff interpolator
    (reference ``common/LowPassFilter.c:127`` MakeLPFIR)."""

    cutoff_hz: float
    base_order: int                   # taps before interpolation scaling
    target_rate_hz: Optional[float]   # if set, interp = rint(target/Fs)
    interp: Optional[int] = None      # explicit interpolation factor

    def interp_factor(self, fs: float) -> int:
        if self.interp is not None:
            return int(self.interp)
        assert self.target_rate_hz is not None
        # rint(150000/Fs): 9 samples/symbol target (POESTIPdemod/main.c:335)
        return int(np.rint(self.target_rate_hz / fs))

    def order(self, fs: float) -> int:
        return self.base_order * self.interp_factor(fs)


@dataclasses.dataclass(frozen=True)
class AGCConfig:
    """GNURadio-style attack/decay AGC (reference ``common/AGC.c:78``)."""

    attack_rate_rad_s: float
    decay_rate_rad_s: float
    reference_level: float = 1.0
    max_gain: float = 5000.0
    min_gain: float = 10e-5


@dataclasses.dataclass(frozen=True)
class GardnerConfig:
    """Timing recovery (reference ``common/GardenerClockRecovery.c`` /
    ``common/MMClockRecovery.c``)."""

    baud: float           # Manchester symbol rate (2x bit rate)
    error_limit: float    # TED output clamp (Gardner) / step range (M&M)
    gain: float           # TED proportional gain kp
    # "gardner" (the reference apps' choice — "gardner works better!",
    # POESTIPdemod/main.c:23), "mm" (Mueller & Muller, kept selectable),
    # or the MATLAB value-interpolating variants
    # "upsampling_gardner" / "upsampling_mm"
    # (standalone_matlab/Functionized/UpsamplingGardenerClockRecovery2.m,
    # UpsamplingMMClockRecovery*.m): the post-AGC stream is upsampled
    # upsample_level x with a smooth kernel before timing recovery.
    # Exact (scan) path with quirks=False only; error_limit/gain then act
    # in upsampled-sample units, the MATLAB stepSpread/kp convention.
    algorithm: str = "gardner"
    upsample_level: int = 4
    upsample_kind: str = "cubic"     # "cubic" (Catmull-Rom) | "linear"


@dataclasses.dataclass(frozen=True)
class ManchesterConfig:
    """Manchester decoder (reference ``common/ManchesterDecode.c``)."""

    resync_threshold: float


@dataclasses.dataclass(frozen=True)
class FramerConfig:
    """Sync-word framer (reference per-app ``ByteSync.c``)."""

    sync_word: str            # e.g. "1110110111100010000"
    frame_bytes: int          # 104 POES minor frame / 9 ARGOS packet line
    data_start_byte: int      # frameByteIdx at sync (2 for both modes)
    first_bit_index: int      # bitIdx at sync (3 POES, 0 ARGOS)
    prefix_bytes: tuple       # bytes emitted at sync ((0xED,0xE2) POES, () ARGOS)
    detect_inverted: bool     # also match the complemented sync word
    # POES tags inverted-sync frames with an "i" timestamp suffix
    # (POESTIPdemod/ByteSync.c:130); the ARGOS realtime framer prints the
    # bare timestamp for both polarities (ARGOSdemodPortAudio/ByteSync.c:127).
    inverted_mark: bool = True

    @property
    def sync_len(self) -> int:
        return len(self.sync_word)

    @property
    def payload_bits(self) -> int:
        """Bits consumed after the sync bit to finish a frame."""
        first = 8 - self.first_bit_index          # bits to finish first byte
        rest = self.frame_bytes - self.data_start_byte - 1
        return first + 8 * rest

    def sync_bits(self) -> np.ndarray:
        return np.frombuffer(self.sync_word.encode(), np.uint8) - ord("0")


@dataclasses.dataclass(frozen=True)
class SquelchConfig:
    threshold: float
    # where the squelch sits in the chain: "after_pll" (POES realtime,
    # POESTIPdemodPortAudio/main.c:367) or "after_agc" (both ARGOS apps,
    # ARGOSdemod/main.c:276)
    position: str = "after_pll"


@dataclasses.dataclass(frozen=True)
class ModeConfig:
    """A complete demodulator mode — one reference application."""

    name: str
    pll: PLLConfig
    fir: FIRConfig
    agc: AGCConfig
    gardner: GardnerConfig
    manchester: ManchesterConfig
    framer: FramerConfig
    squelch: Optional[SquelchConfig]  # None = no squelch stage (POES file app)
    dtype: str                        # "float32" | "float64" (config.h USE_FLOATS)
    chunk_size: int                   # default streaming chunk
    static_gain_level: float = 1.0    # StaticGain desiredLevel

    def np_dtype(self):
        return np.dtype(self.dtype)

    def scaled(self, rad_s: float, fs: float) -> float:
        """rad/s -> per-sample gain, as done at reference call sites."""
        return rad_s * (2.0 * math.pi / fs)


# --- shipped mode presets -------------------------------------------------

# POES TIP file demod (POESTIPdemod/main.c:32-104, config.h USE_FLOATS=1)
POES_TIP = ModeConfig(
    name="poes_tip",
    pll=PLLConfig(
        max_carrier_deviation_hz=4500.0,
        acq_gain_rad_s=127.3240,
        track_gain_rad_s=10.3451,
        lock_alpha_rad_s=0.3979,
        lock_threshold=0.08,
    ),
    fir=FIRConfig(cutoff_hz=11000.0, base_order=26, target_rate_hz=150000.0),
    agc=AGCConfig(attack_rate_rad_s=79.5775, decay_rate_rad_s=159.1549),
    gardner=GardnerConfig(baud=8320 * 2 + 0.3, error_limit=0.1, gain=3.0),
    # main.c:445 passes literal 1.0 despite DSP_MCHSTR_RESYNC_LVL 0.75
    manchester=ManchesterConfig(resync_threshold=1.0),
    framer=FramerConfig(
        sync_word="1110110111100010000",
        frame_bytes=104,
        data_start_byte=2,
        first_bit_index=3,
        prefix_bytes=(0xED, 0xE2),
        detect_inverted=True,
    ),
    squelch=None,
    dtype="float32",
    chunk_size=10000,
)

# POES TIP realtime (POESTIPdemodPortAudio/main.c:27-118): adds squelch on the
# PLL lock signal, fixed interp 3 / order 78, hotter acquisition gain.
POES_TIP_REALTIME = dataclasses.replace(
    POES_TIP,
    name="poes_tip_realtime",
    pll=dataclasses.replace(
        POES_TIP.pll, acq_gain_rad_s=198.9437, lock_threshold=0.10
    ),
    fir=FIRConfig(cutoff_hz=11000.0, base_order=26, target_rate_hz=None, interp=3),
    manchester=ManchesterConfig(resync_threshold=0.75),
    squelch=SquelchConfig(threshold=0.05, position="after_pll"),
    chunk_size=2400,
)

# ARGOS file demod (ARGOSdemod/main.c:27-65, config.h USE_FLOATS=0 -> double)
ARGOS = ModeConfig(
    name="argos",
    pll=PLLConfig(
        max_carrier_deviation_hz=550.0,
        acq_gain_rad_s=16.0,
        track_gain_rad_s=16.0,
        lock_alpha_rad_s=3.1831,
        lock_threshold=0.1,
    ),
    fir=FIRConfig(cutoff_hz=700.0, base_order=50, target_rate_hz=None, interp=1),
    agc=AGCConfig(attack_rate_rad_s=79.5775, decay_rate_rad_s=159.1549),
    gardner=GardnerConfig(baud=400 * 2.0, error_limit=0.1, gain=3.0),
    manchester=ManchesterConfig(resync_threshold=0.5),
    framer=FramerConfig(
        sync_word="0001011110000",
        frame_bytes=9,           # frameByteIdx runs 2..8 -> 7 data bytes
        data_start_byte=2,
        first_bit_index=0,
        prefix_bytes=(),         # E2 F0 prefix commented out (ByteSync.c:100)
        detect_inverted=False,   # file variant disables inverse sync
    ),
    squelch=SquelchConfig(threshold=0.15, position="after_agc"),
    dtype="float64",
    chunk_size=2400,
)

# ARGOS realtime (ARGOSdemodPortAudio): float32, inverse-sync enabled.
ARGOS_REALTIME = dataclasses.replace(
    ARGOS,
    name="argos_realtime",
    framer=dataclasses.replace(ARGOS.framer, detect_inverted=True,
                               inverted_mark=False),
    dtype="float32",
)

MODES = {m.name: m for m in (POES_TIP, POES_TIP_REALTIME, ARGOS, ARGOS_REALTIME)}

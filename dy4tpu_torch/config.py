"""Mode configuration for the TPU-native FM broadcast receiver.

The reference hard-codes per-mode constants in a switch statement
(``src/project.cpp:178-238``) and as module globals
(``model/fmMonoBlock.py:46-69``).  Here the mode table is a frozen
dataclass with derived quantities (up/down factors via gcd, block
geometry) and validators for the course constraints: every inter-module
packet must carry 22-44 ms of samples and every filter output must
accumulate roughly 75-125 partial products (constraints pdf p.1).

All sample counts are static Python ints so that every downstream jitted
program has static shapes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


def _gcd_ratio(target: float, source: float) -> tuple[int, int]:
    """Return (up, down) integer factors converting source rate -> target."""
    # Work in integer Hz to avoid float fuzz (all broadcast rates are ints).
    t, s = int(round(target)), int(round(source))
    g = math.gcd(t, s)
    return t // g, s // g


@dataclasses.dataclass(frozen=True)
class ModeConfig:
    """Static parameters for one receiver mode.

    Mirrors the reference mode table (``src/project.cpp:178-238``) but with
    everything derived and validated instead of hand-copied.
    """

    mode: int
    rf_fs: float            # RF (dongle) sample rate, S/s
    rf_decim: int            # RF front-end decimation
    audio_fs: float          # final audio sample rate, S/s
    audio_up: int            # audio polyphase upsample factor U
    audio_down: int          # audio polyphase downsample factor D

    # fixed across modes (reference values)
    rf_fc: float = 100e3     # RF LPF cutoff (project.cpp:147)
    audio_fc: float = 16e3   # audio LPF cutoff (project.cpp:151)
    num_taps: int = 101      # base tap count (project.cpp:142)

    pilot_fb: float = 18.5e3  # pilot BPF band (project.cpp:268-269)
    pilot_fe: float = 19.5e3
    stereo_fb: float = 22e3   # stereo BPF band (project.cpp:270-271)
    stereo_fe: float = 54e3

    pll_freq: float = 19e3    # stereo pilot PLL (project.cpp:99-102)
    pll_nco_scale: float = 2.0
    pll_bandwidth: float = 0.01

    # RDS constants (model/fmMonoBlock.py:60-67,444-447,489-502)
    rds_fb: float = 54e3
    rds_fe: float = 60e3
    rds_carrier_fb: float = 113.5e3
    rds_carrier_fe: float = 114.5e3
    rds_pll_freq: float = 114e3
    rds_pll_nco_scale: float = 0.5
    rds_pll_bandwidth: float = 0.001
    rds_fc: float = 3e3
    # samples per RDS symbol after resample; None = RDS unsupported in this
    # mode (constraints pdf p.1: SPS defined only for modes 0 (16) and 2 (27))
    rds_sps: Optional[int] = None
    rds_symbol_rate: float = 2375.0

    # ---- derived ----

    @property
    def if_fs(self) -> float:
        """Intermediate (post RF decimation) sample rate."""
        return self.rf_fs / self.rf_decim

    @property
    def audio_taps(self) -> int:
        return self.num_taps * self.audio_up

    @property
    def rds_fs(self) -> float:
        """RDS path rate after rational resampling (sps * 2375)."""
        return self.rds_sps * self.rds_symbol_rate

    @property
    def rds_up(self) -> int:
        return _gcd_ratio(self.rds_fs, self.if_fs)[0]

    @property
    def rds_down(self) -> int:
        return _gcd_ratio(self.rds_fs, self.if_fs)[1]

    @property
    def rds_taps(self) -> int:
        return self.num_taps * self.rds_up

    @property
    def rds_rrc_taps(self) -> int:
        return self.num_taps

    @property
    def if_alignment(self) -> int:
        """Smallest IF-sample count giving integer outputs at every stage."""
        a = self.audio_down // math.gcd(self.audio_up, self.audio_down)
        align = a
        if self.supports_rds:
            # integer resampler outputs AND an integer symbol count per block
            r = (self.rds_down * self.rds_sps
                 // math.gcd(self.rds_up, self.rds_down * self.rds_sps))
            align = align * r // math.gcd(align, r)
        return align

    @property
    def block_size(self) -> int:
        """IQ samples (I and Q interleaved) per block.

        Chosen as the smallest multiple of the per-stage alignment closest to
        a 32 ms packet — inside the course's 22-44 ms window whenever the
        alignment permits (constraints pdf p.1).  The reference instead
        hand-picks ``c1*D*rf_decim*2`` (``src/project.cpp:188-224``).
        """
        unit = self.if_alignment * self.rf_decim * 2
        target = 0.032 * self.rf_fs * 2  # 32 ms of interleaved IQ
        k = max(1, round(target / unit))
        return unit * k

    @property
    def iq_per_block(self) -> int:
        return self.block_size // 2

    @property
    def if_per_block(self) -> int:
        return self.iq_per_block // self.rf_decim

    @property
    def audio_per_block(self) -> int:
        return self.if_per_block * self.audio_up // self.audio_down

    @property
    def rds_per_block(self) -> int:
        return self.if_per_block * self.rds_up // self.rds_down

    @property
    def rds_symbols_per_block(self) -> int:
        return self.rds_per_block // self.rds_sps

    @property
    def supports_rds(self) -> bool:
        """RDS needs a configured SPS and 114.5 kHz below IF Nyquist."""
        return self.rds_sps is not None and self.if_fs / 2 > self.rds_carrier_fe

    def validate(self) -> None:
        """Course constraints (constraints pdf p.1)."""
        ms = 1000.0 * self.iq_per_block / self.rf_fs
        if not (22.0 <= ms <= 44.0):
            raise ValueError(
                f"mode {self.mode}: block carries {ms:.1f} ms; want 22-44 ms")
        ppo = self.num_taps  # partial products per output in the base filter
        if not (75 <= ppo <= 125):
            raise ValueError(f"mode {self.mode}: {ppo} partial products/output")
        assert self.iq_per_block % self.rf_decim == 0
        assert (self.if_per_block * self.audio_up) % self.audio_down == 0
        if self.supports_rds:
            assert (self.if_per_block * self.rds_up) % self.rds_down == 0
            assert self.rds_per_block % self.rds_sps == 0


# Reference mode table (src/project.cpp:178-238).  Mode 3 keeps the as-built
# deviation IF=384k (rf_decim 5) documented in the final report p.1.
MODES: dict[int, ModeConfig] = {
    0: ModeConfig(mode=0, rf_fs=2.4e6, rf_decim=10, audio_fs=48e3,
                  audio_up=1, audio_down=5, rds_sps=16),
    1: ModeConfig(mode=1, rf_fs=1.44e6, rf_decim=5, audio_fs=36e3,
                  audio_up=1, audio_down=8),
    2: ModeConfig(mode=2, rf_fs=2.4e6, rf_decim=10, audio_fs=44.1e3,
                  audio_up=147, audio_down=800, rds_sps=27),
    3: ModeConfig(mode=3, rf_fs=1.92e6, rf_decim=5, audio_fs=44.1e3,
                  audio_up=147, audio_down=1280),
}


def get_mode(mode: int) -> ModeConfig:
    try:
        cfg = MODES[mode]
    except KeyError:
        raise ValueError(f"mode must be 0-3, got {mode}") from None
    cfg.validate()
    return cfg

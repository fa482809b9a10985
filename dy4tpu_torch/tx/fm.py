"""FM stereo + RDS broadcast synthesiser (numpy + scipy copy of
``dy4tpu/tx/fm.py``), and the check that a receiver decoded it.

The port carries this copy because ``dy4tpu.tx.fm`` imports
``dy4tpu.ops``, whose ``__init__`` imports JAX.  It keeps the single-
station path (``synthesize`` with noise and the tuner-fault injection)
and the wideband multi-station synthesiser (``synthesize_wideband``);
multipath stays in dy4tpu.

Multiplex (FM broadcast standard):

    m(t) = a_mono*(L+R)/2 + a_pilot*cos(wp t) + a_st*(L-R)/2*cos(2 wp t)
         + a_rds*rds(t)*cos(3 wp t)          with wp = 2*pi*19 kHz

RDS baseband: bits at 1187.5 b/s -> differential encode -> biphase
(Manchester) halves at 2375 Hz -> impulse train at sps*2375 -> RRC pulse
shaping -> resample to the IF rate.

Host-side float64 numpy: runs once per test or smoke run.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sp

from dy4tpu_torch.config import ModeConfig
from dy4tpu_torch.rds import coding
from dy4tpu_torch.ops import firdes

# the broadcast that bench.py and chip_smoke.py decode
PI_CODE = 0x54A7
PS_NAME = "DY4TPU  "
# u8 codes per unit of signal: a capture holds round(128 + 100 x), so the
# receiver's (u8 - 128) / 128 sees x scaled by 100/128
U8_AMPLITUDE = 100.0


def rds_baseband(bits, cfg: ModeConfig, n_if: int) -> np.ndarray:
    """Shape an RDS bitstream into an IF-rate waveform of length n_if."""
    halves = coding.manchester_halves(coding.differential_encode(bits))
    sps = cfg.rds_sps
    rds_fs = cfg.rds_fs
    n_rds = int(np.ceil(n_if * rds_fs / cfg.if_fs)) + 8 * sps
    train = np.zeros(n_rds, np.float64)
    idx = np.arange(len(halves)) * sps
    idx = idx[idx < n_rds]
    train[idx] = halves[: len(idx)]
    h = firdes.rrc(rds_fs, cfg.rds_rrc_taps, cfg.rds_symbol_rate)
    shaped = sp.lfilter(h.astype(np.float64), 1.0, train)
    wave = sp.resample_poly(shaped, cfg.rds_down, cfg.rds_up)
    return wave[:n_if]


def multiplex(cfg: ModeConfig, n_blocks: int, *,
              left: np.ndarray | None = None,
              right: np.ndarray | None = None,
              rds_bits=None,
              a_mono: float = 0.45, a_pilot: float = 0.10,
              a_stereo: float = 0.45, a_rds: float = 0.06) -> np.ndarray:
    """The composite FM multiplex m(t) at the IF rate (length
    ``n_blocks * cfg.if_per_block``)."""
    n_if = n_blocks * cfg.if_per_block
    n_audio = n_blocks * cfg.audio_per_block

    def prep(a):
        if a is None:
            return np.zeros(n_audio)
        a = np.asarray(a, np.float64)[:n_audio]
        return np.pad(a, (0, n_audio - len(a)))

    l, r = prep(left), prep(right)
    # audio (audio_fs) -> IF rate
    up, down = cfg.audio_down, cfg.audio_up   # inverse of the RX resampler
    l_if = sp.resample_poly(l, up, down)[:n_if]
    r_if = sp.resample_poly(r, up, down)[:n_if]
    l_if = np.pad(l_if, (0, n_if - len(l_if)))
    r_if = np.pad(r_if, (0, n_if - len(r_if)))

    t = np.arange(n_if) / cfg.if_fs
    theta = 2 * np.pi * 19e3 * t
    m = (a_mono * (l_if + r_if) / 2
         + a_pilot * np.cos(theta)
         + a_stereo * ((l_if - r_if) / 2) * np.cos(2 * theta))
    if rds_bits is not None and cfg.supports_rds:
        m = m + a_rds * rds_baseband(rds_bits, cfg, n_if) * np.cos(3 * theta)
    return m


def synthesize(cfg: ModeConfig, n_blocks: int, *,
               left: np.ndarray | None = None,
               right: np.ndarray | None = None,
               rds_bits=None,
               a_mono: float = 0.45, a_pilot: float = 0.10,
               a_stereo: float = 0.45, a_rds: float = 0.06,
               kf: float = 75e3, noise: float = 0.0,
               seed: int = 0, dc_i: float = 0.0, dc_q: float = 0.0,
               iq_gain: float = 1.0, iq_phase_deg: float = 0.0
               ) -> np.ndarray:
    """Generate ``n_blocks`` blocks of interleaved u8 IQ for a mode.

    ``left``/``right``: audio at cfg.audio_fs (zero-padded/truncated to
    fit); None -> silence.  ``noise``: white Gaussian noise per I/Q
    sample, from ``seed``.  Returns uint8 [n_blocks * block_size].

    ``dc_i``/``dc_q``/``iq_gain``/``iq_phase_deg`` inject the tuner
    impairment model of ``ops/iqcorr.py`` (LO-leakage DC offsets in
    signal units, Q-branch gain and quadrature-phase error) after the
    channel noise: both ride the same analog front end.
    """
    m = multiplex(cfg, n_blocks, left=left, right=right,
                  rds_bits=rds_bits, a_mono=a_mono, a_pilot=a_pilot,
                  a_stereo=a_stereo, a_rds=a_rds)

    # IF -> RF rate, then FM modulate
    m_rf = sp.resample_poly(m, cfg.rf_decim, 1)
    n_rf = n_blocks * cfg.iq_per_block
    m_rf = np.pad(m_rf[:n_rf], (0, max(0, n_rf - len(m_rf))))
    phase = 2 * np.pi * kf / cfg.rf_fs * np.cumsum(m_rf)
    x = np.exp(1j * phase)
    i, q = x.real, x.imag
    if noise > 0:
        rng = np.random.default_rng(seed)
        i = i + noise * rng.standard_normal(n_rf)
        q = q + noise * rng.standard_normal(n_rf)
    if (dc_i, dc_q, iq_gain, iq_phase_deg) != (0.0, 0.0, 1.0, 0.0):
        from dy4tpu_torch.ops import iqcorr
        i, q = iqcorr.impair(i, q, dc_i=dc_i, dc_q=dc_q, gain=iq_gain,
                             phase_deg=iq_phase_deg)

    iq = np.empty(2 * n_rf, np.float64)
    iq[0::2], iq[1::2] = i, q
    return np.clip(np.round(iq * U8_AMPLITUDE + 128.0), 0, 255).astype(np.uint8)


def tone(freq: float, fs: float, n: int, amp: float = 1.0,
         phase: float = 0.0) -> np.ndarray:
    """Test tone (equivalent of generateSin, src/genfunc.cpp:13-24)."""
    return amp * np.sin(2 * np.pi * freq * np.arange(n) / fs + phase)


def synthesize_wideband(cfg: ModeConfig, channels: int, n_steps: int, *,
                        stations: dict[int, dict],
                        kf: float = 75e3, amp: float | None = None,
                        noise: float = 0.0, seed: int = 0) -> np.ndarray:
    """Multi-station wideband capture for ``ops/channelizer.py``.

    One complex stream at ``fs_w = channels * cfg.if_fs`` holding an FM
    station on carrier ``+c * cfg.if_fs`` for each entry of
    ``stations`` — ``{channel_index: multiplex kwargs}`` (left/right/
    rds_bits/a_*).  Returns interleaved u8 IQ of length
    ``2 * n_steps * channels * cfg.if_per_block``.  ``amp`` is the
    per-station amplitude (default ``0.9 / len(stations)``).

    A station dict may carry ``carrier_offset_hz`` (the carrier sits that
    far off the channel grid; the wideband AFC loop tracks it) and
    ``station_amp`` (its own amplitude instead of ``amp``), both popped
    before the multiplex.  ``noise``: complex white Gaussian noise per
    sample, from ``seed``.
    """
    n_if = n_steps * cfg.if_per_block
    n_w = n_if * channels
    fs_w = cfg.if_fs * channels
    if amp is None:
        amp = 0.9 / max(1, len(stations))

    x = np.zeros(n_w, np.complex128)
    n = np.arange(n_w)
    for c, kw in stations.items():
        if not 0 <= c < channels:
            raise ValueError(f"station channel {c} outside [0, {channels})")
        kw = dict(kw)
        df = kw.pop("carrier_offset_hz", 0.0)
        a_st = kw.pop("station_amp", amp)
        m = multiplex(cfg, n_steps, **kw)
        m_w = sp.resample_poly(m, channels, 1)
        m_w = np.pad(m_w[:n_w], (0, max(0, n_w - len(m_w))))
        phase = 2 * np.pi * kf / fs_w * np.cumsum(m_w)
        x = x + a_st * np.exp(1j * (phase + 2 * np.pi * c * n / channels
                                    + 2 * np.pi * df / fs_w * n))

    if noise > 0:
        rng = np.random.default_rng(seed)
        x = x + noise * (rng.standard_normal(n_w)
                         + 1j * rng.standard_normal(n_w))

    iq = np.empty(2 * n_w, np.float64)
    iq[0::2], iq[1::2] = x.real, x.imag
    return np.clip(np.round(iq * U8_AMPLITUDE + 128.0), 0, 255).astype(np.uint8)


def stereo_rds_broadcast(cfg: ModeConfig, n_blocks: int,
                         **fault) -> np.ndarray:
    """The broadcast of ``bench.py``: an 800 Hz tone on the left, 2400 Hz
    on the right, and RDS groups 0A carrying ``PI_CODE``/``PS_NAME``.
    ``fault``: ``synthesize``'s tuner-impairment keywords (``dc_i``,
    ``dc_q``, ``iq_gain``, ``iq_phase_deg``).  Returns uint8 [n_blocks,
    block_size]."""
    n_audio = n_blocks * cfg.audio_per_block
    bits = None
    if cfg.supports_rds:
        bits = coding.make_ps_bitstream(PI_CODE, 10, PS_NAME,
                                        repeats=max(2, n_blocks))
    iq = synthesize(cfg, n_blocks,
                    left=tone(800.0, cfg.audio_fs, n_audio, amp=0.7),
                    right=tone(2400.0, cfg.audio_fs, n_audio, amp=0.7),
                    rds_bits=bits, **fault)
    return iq.reshape(n_blocks, cfg.block_size)


def stereo_separation_db(cfg: ModeConfig, left: np.ndarray,
                         right: np.ndarray, skip_blocks: int = 3
                         ) -> tuple[float, float]:
    """Stereo separation of one channel's decode of
    ``stereo_rds_broadcast`` (800 Hz left, 2400 Hz right), in dB on the
    left and the right, after ``skip_blocks`` blocks of lock-in.
    ``left``/``right``: [blocks, audio_per_block]."""
    l = np.asarray(left)[skip_blocks:].ravel()
    r = np.asarray(right)[skip_blocks:].ravel()
    t = np.arange(len(l)) / cfg.audio_fs
    probe = lambda x, f: np.abs(x @ np.exp(-2j * np.pi * f * t)) / len(x)  # noqa: E731
    sep_l = 20 * np.log10(probe(l, 800.0) / max(probe(l, 2400.0), 1e-12))
    sep_r = 20 * np.log10(probe(r, 2400.0) / max(probe(r, 800.0), 1e-12))
    return float(sep_l), float(sep_r)


def check_reception(cfg: ModeConfig, left: np.ndarray, right: np.ndarray,
                    symbols: np.ndarray | None, resync: np.ndarray | None,
                    skip_blocks: int = 3) -> dict:
    """Hold one channel's decode of ``stereo_rds_broadcast`` to the bars
    of ``bench.py``'s ``_validate``: stereo separation above 15 dB on both
    sides, and (with RDS) PI recovered, and PS too from 24 blocks on.

    ``left``/``right``: [blocks, audio_per_block]; ``symbols``: [blocks,
    symbols_per_block] hard bits; ``resync``: [blocks].  Raises
    ``AssertionError`` when a bar is missed; returns what was measured.
    """
    from dy4tpu_torch.rds.app import ApplicationLayer
    from dy4tpu_torch.rds.decoder import RDSDecoder

    sep_l, sep_r = stereo_separation_db(cfg, left, right, skip_blocks)
    if not (sep_l > 15 and sep_r > 15):
        raise AssertionError(f"stereo separation failed: L={sep_l:.1f} dB "
                             f"R={sep_r:.1f} dB")
    got = {"sep_l_db": float(sep_l), "sep_r_db": float(sep_r)}
    if symbols is None:
        return got
    app = ApplicationLayer()
    dec = RDSDecoder(on_group=app.process)
    for b in range(len(symbols)):
        dec.push_block(np.asarray(symbols[b]), resync=bool(resync[b]))
    if app.info.pi_hex != f"{PI_CODE:04X}":
        raise AssertionError(f"PI not recovered: {app.info.pi_hex} "
                             f"(groups={app.info.groups_seen})")
    # PS needs all 4 segments decoded
    if (len(symbols) >= 24
            and (app.info.ps_name or "").strip() != PS_NAME.strip()):
        raise AssertionError(f"PS not recovered: {app.info.ps_name!r}")
    got.update(pi=app.info.pi_hex, ps=app.info.ps_name,
               groups=app.info.groups_seen)
    return got

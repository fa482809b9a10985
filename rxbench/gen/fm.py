"""FM stereo + RDS broadcast synthesis, a frozen copy of the port's
``tx/fm.py`` (``multiplex``, ``synthesize`` without channel faults,
``tone``), so that later changes to the port cannot move the inputs.

    m(t) = a_mono (L+R)/2 + a_pilot cos(wp t) + a_st (L-R)/2 cos(2 wp t)
         + a_rds rds(t) cos(3 wp t),        wp = 2 pi 19 kHz

RDS: biphase symbols at 2375 Hz as an impulse train at sps * 2375 Hz,
shaped by the root-raised cosine and resampled to the IF rate.  The
multiplex is resampled to the RF rate and frequency-modulated with a
75 kHz deviation; I and Q are stored as round(128 + 100 x) bytes.
Host float64 numpy and scipy, run once at set-up.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sp

from rxbench import firdes
from rxbench.gen import coding

U8_AMPLITUDE = 100.0


def tone(freq: float, fs: float, n: int, amp: float) -> np.ndarray:
    return amp * np.sin(2 * np.pi * freq * np.arange(n) / fs)


def rds_baseband(bits, g, cfg: dict, n_if: int) -> np.ndarray:
    halves = coding.biphase(bits)
    sps = g.sps
    rds_fs = sps * cfg["rds_symbol_rate"]
    if_fs = cfg["rf_fs"] / g.rf_decim
    n_rds = int(np.ceil(n_if * rds_fs / if_fs)) + 8 * sps
    train = np.zeros(n_rds)
    idx = np.arange(len(halves)) * sps
    idx = idx[idx < n_rds]
    train[idx] = halves[:len(idx)]
    h = firdes.rrc(rds_fs, int(cfg["num_taps"]), cfg["rds_symbol_rate"])
    shaped = sp.lfilter(h.astype(np.float64), 1.0, train)
    return sp.resample_poly(shaped, g.rds_down, g.rds_up)[:n_if]


def synthesize(g, cfg: dict, n_blocks: int, left: np.ndarray,
               right: np.ndarray, rds_bits=None, *, a_mono: float = 0.45,
               a_pilot: float = 0.10, a_stereo: float = 0.45,
               a_rds: float = 0.06, kf: float = 75e3) -> np.ndarray:
    """``n_blocks`` blocks of interleaved u8 I/Q [n_blocks * 2 * g.iq] of a
    station broadcasting ``left`` / ``right`` (audio-rate) and, with
    ``rds_bits``, RDS.  ``g``: the configuration's ``Geometry``."""
    n_if = n_blocks * g.n_if
    n_audio = n_blocks * g.n_audio
    if_fs = cfg["rf_fs"] / g.rf_decim

    def to_if(a):
        a = np.pad(np.asarray(a, np.float64)[:n_audio],
                   (0, max(0, n_audio - len(a))))
        a = sp.resample_poly(a, g.audio_down, g.audio_up)[:n_if]
        return np.pad(a, (0, n_if - len(a)))

    l_if, r_if = to_if(left), to_if(right)
    theta = 2 * np.pi * 19e3 * np.arange(n_if) / if_fs
    m = (a_mono * (l_if + r_if) / 2 + a_pilot * np.cos(theta)
         + a_stereo * ((l_if - r_if) / 2) * np.cos(2 * theta))
    if rds_bits is not None:
        m = m + a_rds * rds_baseband(rds_bits, g, cfg, n_if) * np.cos(
            3 * theta)
    m_rf = sp.resample_poly(m, g.rf_decim, 1)
    n_rf = n_blocks * g.iq
    m_rf = np.pad(m_rf[:n_rf], (0, max(0, n_rf - len(m_rf))))
    phase = 2 * np.pi * kf / cfg["rf_fs"] * np.cumsum(m_rf)
    iq = np.empty(2 * n_rf)
    iq[0::2], iq[1::2] = np.cos(phase), np.sin(phase)
    return np.clip(np.round(iq * U8_AMPLITUDE + 128.0), 0,
                   255).astype(np.uint8)

"""FIR designs of the COE3DY4 receiver, for the traffic generator and the
plain reference: a frozen copy of the port's ``ops/firdes.py`` (``lpf``,
``bpf``, ``rrc``), so that later changes to the port move neither the
inputs nor the reference.

Designs run in float64 numpy and return float32 taps:

- low-pass: windowed sinc with a ``sin^2(i*pi/N)`` Hann window, the gain
  scaled by the polyphase upsample factor (``src/filter.cpp:14-29``);
- band-pass: a sinc at half the pass width modulated by a cosine at the
  band centre, same window (``src/filter.cpp:31-49``);
- root-raised cosine: T = 1/2375 s, beta = 0.9, its two singular points
  in closed form (``model/fmRRC.py:13-49``).
"""

from __future__ import annotations

import numpy as np


def lpf(fs: float, fc: float, num_taps: int, up_factor: int = 1) -> np.ndarray:
    n = np.arange(num_taps, dtype=np.float64)
    norm_c = fc / (fs / 2.0)
    centre = (num_taps - 1) / 2.0
    arg = np.pi * norm_c * (n - centre)
    with np.errstate(invalid="ignore", divide="ignore"):
        h = norm_c * np.sin(arg) / arg
    h = np.where(n == (num_taps - 1) // 2, norm_c, h)
    h *= np.sin(n * np.pi / num_taps) ** 2 * float(up_factor)
    return h.astype(np.float32)


def bpf(fs: float, fb: float, fe: float, num_taps: int) -> np.ndarray:
    n = np.arange(num_taps, dtype=np.float64)
    norm_centre = ((fe + fb) / 2.0) / (fs / 2.0)
    norm_pass = (fe - fb) / (fs / 2.0)
    centre = (num_taps - 1) / 2.0
    arg = np.pi * norm_pass / 2.0 * (n - centre)
    with np.errstate(invalid="ignore", divide="ignore"):
        h = norm_pass * np.sin(arg) / arg
    h = np.where(n == (num_taps - 1) // 2, norm_pass, h)
    h *= np.cos((n - (num_taps - 1) // 2) * np.pi * norm_centre)
    h *= np.sin(n * np.pi / num_taps) ** 2
    return h.astype(np.float32)


def rrc(fs: float, num_taps: int, symbol_rate: float = 2375.0,
        beta: float = 0.90) -> np.ndarray:
    t_sym = 1.0 / symbol_rate
    k = np.arange(num_taps, dtype=np.float64)
    t = (k - num_taps / 2.0) / fs
    sing = t_sym / (4.0 * beta)
    with np.errstate(invalid="ignore", divide="ignore"):
        num = (np.sin(np.pi * t * (1 - beta) / t_sym)
               + 4 * beta * (t / t_sym) * np.cos(np.pi * t * (1 + beta)
                                                 / t_sym))
        den = np.pi * t * (1 - (4 * beta * t / t_sym) ** 2) / t_sym
        h = num / den
    h = np.where(t == 0.0, 1.0 + beta * (4.0 / np.pi - 1.0), h)
    edge = (beta / np.sqrt(2.0)) * (
        (1 + 2.0 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2.0 / np.pi) * np.cos(np.pi / (4 * beta)))
    h = np.where(np.isclose(np.abs(t), sing), edge, h)
    return h.astype(np.float32)

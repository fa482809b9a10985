"""FIR filter design (numpy copy of ``dy4tpu/ops/firdes.py``).

The port needs these designs without JAX, and ``dy4tpu.ops`` imports its
JAX modules eagerly, so the port carries its own copy.  The tests pin it
equal, element for element, to ``dy4tpu``'s.  Filter design runs once at
set-up: plain float64 numpy returning float32 arrays.

Semantics follow the reference designs:
  - low-pass: windowed sinc with a ``sin^2(i*pi/N)`` Hann window and the
    gain pre-scaled by the polyphase upsample factor
    (``src/filter.cpp:14-29``, ``model/fmMonoBlock.py:549-559``)
  - band-pass: sinc envelope at half the passband width modulated by a
    cosine at the band centre, same window (``src/filter.cpp:31-49``)
  - root-raised-cosine: T=1/2375 s, beta=0.9, closed form with the two
    singular points handled exactly (``model/fmRRC.py:13-49``)
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def lpf(fs: float, fc: float, num_taps: int, up_factor: int = 1) -> np.ndarray:
    """Windowed-sinc low-pass, reference convention (src/filter.cpp:14-29)."""
    n = np.arange(num_taps, dtype=np.float64)
    norm_c = fc / (fs / 2.0)
    centre = (num_taps - 1) / 2.0
    arg = np.pi * norm_c * (n - centre)
    with np.errstate(invalid="ignore", divide="ignore"):
        h = norm_c * np.sin(arg) / arg
    h = np.where(n == (num_taps - 1) // 2, norm_c, h)
    h *= np.sin(n * np.pi / num_taps) ** 2 * float(up_factor)
    return h.astype(_F32)


def bpf(fs: float, fb: float, fe: float, num_taps: int,
        up_factor: int = 1) -> np.ndarray:
    """Windowed-sinc band-pass, reference convention (src/filter.cpp:31-49)."""
    n = np.arange(num_taps, dtype=np.float64)
    norm_centre = ((fe + fb) / 2.0) / (fs / 2.0)
    norm_pass = (fe - fb) / (fs / 2.0)
    centre = (num_taps - 1) / 2.0
    arg = np.pi * norm_pass / 2.0 * (n - centre)
    with np.errstate(invalid="ignore", divide="ignore"):
        h = norm_pass * np.sin(arg) / arg
    h = np.where(n == (num_taps - 1) // 2, norm_pass, h)
    h *= np.cos((n - (num_taps - 1) // 2) * np.pi * norm_centre)
    h *= np.sin(n * np.pi / num_taps) ** 2 * float(up_factor)
    return h.astype(_F32)


def rrc(fs: float, num_taps: int, symbol_rate: float = 2375.0,
        beta: float = 0.90) -> np.ndarray:
    """Root-raised-cosine matched filter (model/fmRRC.py:13-49).

    ``fs`` must be an integer multiple of the symbol rate; the multiple is
    the number of samples per symbol.
    """
    t_sym = 1.0 / symbol_rate
    k = np.arange(num_taps, dtype=np.float64)
    t = (k - num_taps / 2.0) / fs
    sing = t_sym / (4.0 * beta)

    with np.errstate(invalid="ignore", divide="ignore"):
        num = (np.sin(np.pi * t * (1 - beta) / t_sym)
               + 4 * beta * (t / t_sym) * np.cos(np.pi * t * (1 + beta) / t_sym))
        den = (np.pi * t * (1 - (4 * beta * t / t_sym) ** 2) / t_sym)
        h = num / den

    h = np.where(t == 0.0, 1.0 + beta * (4.0 / np.pi - 1.0), h)
    edge = (beta / np.sqrt(2.0)) * (
        (1 + 2.0 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2.0 / np.pi) * np.cos(np.pi / (4 * beta)))
    h = np.where(np.isclose(np.abs(t), sing), edge, h)
    return h.astype(_F32)


def lpf_kaiser(fs: float, fc: float, num_taps: int, up_factor: int = 1,
               atten_db: float = 90.0) -> np.ndarray:
    """Kaiser-windowed sinc low-pass: the same geometry and ``x U`` gain
    convention as ``lpf``, with the Hann window replaced by a Kaiser window
    sized for ``atten_db``."""
    n = np.arange(num_taps, dtype=np.float64)
    norm_c = fc / (fs / 2.0)
    centre = (num_taps - 1) / 2.0
    arg = np.pi * norm_c * (n - centre)
    with np.errstate(invalid="ignore", divide="ignore"):
        h = norm_c * np.sin(arg) / arg
    h = np.where(np.isclose(n, centre), norm_c, h)
    beta = (0.1102 * (atten_db - 8.7) if atten_db > 50.0
            else 0.5842 * (atten_db - 21.0) ** 0.4
            + 0.07886 * (atten_db - 21.0) if atten_db > 21.0 else 0.0)
    h *= np.kaiser(num_taps, beta)
    # unity DC gain x U (the windowed-sinc's raw DC gain depends on the
    # window; normalise so passband level matches the polyphase contract)
    h *= float(up_factor) / np.sum(h)
    return h.astype(_F32)


def firwin_lpf(num_taps: int, cutoff_norm: float) -> np.ndarray:
    """Hann-windowed scipy-style LPF (model/fmMonoBlock.py:424)."""
    from scipy import signal
    return signal.firwin(num_taps, cutoff_norm, window="hann").astype(_F32)


def firwin_bpf(num_taps: int, low_norm: float, high_norm: float) -> np.ndarray:
    """Hann-windowed scipy-style BPF (model/fmMonoBlock.py:465-471)."""
    from scipy import signal
    return signal.firwin(num_taps, [low_norm, high_norm], window="hann",
                         pass_zero=False).astype(_F32)

"""FM de-emphasis: the counterpart of ``dy4tpu/ops/deemph.py``, the
receiver-side single-pole IIR (75 us in the Americas and Korea, 50 us
elsewhere)

    y[n] = a * y[n-1] + (1 - a) * x[n],      a = exp(-1 / (tau * fs)).

dy4tpu runs it as a ``lax.associative_scan`` outside any Pallas kernel, so
this is plain torch: a first-order linear recurrence is a scan over affine
maps (A, B) with (A1, B1) o (A2, B2) = (A1*A2, A2*B1 + B2), done here as a
log-depth doubling scan, ``ceil(log2 n)`` passes of whole-block torch ops
(a Python loop over the samples would be one launch per sample on the
card).  ``A`` stays a power of ``a`` that is only ever multiplied, never
divided by, so its underflow to 0 at long range is harmless (a ``cumprod``
of ``a`` divided out would not be).  The carried state is one sample per
stream, the previous output.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

#: standard time constants (seconds)
TAU_US_75 = 75e-6   # Americas / South Korea
TAU_EU_50 = 50e-6   # Europe / rest of world


def deemph_coeff(fs: float, tau: float = TAU_US_75) -> float:
    """Pole coefficient ``a`` for sample rate ``fs`` (impulse-invariant
    mapping of the analog RC pole; -3 dB at ~1/(2*pi*tau))."""
    return math.exp(-1.0 / (tau * fs))


def deemphasis_block(x: Tensor, y_prev: Tensor, a: float
                     ) -> tuple[Tensor, Tensor]:
    """Filter one block: ``y[n] = a*y[n-1] + (1-a)*x[n]``.

    ``x``: [..., n] float32 audio block; ``y_prev``: [...] the previous
    block's last output (0 at stream start).  Returns ``(y, y_last)``.
    Block boundaries are invisible: the carry enters the first sample's
    offset term."""
    a32 = np.float32(a)
    a_f = float(a32)
    b = (float(np.float32(1.0) - a32) * x).clone()
    b[..., 0] += a_f * y_prev
    n = x.shape[-1]
    coef = torch.full((n,), a_f, dtype=x.dtype, device=x.device)
    d = 1
    while d < n:
        # element k becomes the composition of elements (k-2d, k]
        b = torch.cat([b[..., :d], coef[d:] * b[..., :-d] + b[..., d:]],
                      dim=-1)
        coef = torch.cat([coef[:d], coef[d:] * coef[:-d]])
        d *= 2
    return b, b[..., -1]


def init_deemph_state(batch: tuple[int, ...] = (), *, stereo: bool,
                      dtype=torch.float32, device="cuda"):
    """Carried state: previous output sample per audio stream,
    ``(mono,)`` or ``(left, right)``, on ``device`` (the card unless the
    caller asks for the CPU)."""
    n = 2 if stereo else 1
    return tuple(torch.zeros(batch, dtype=dtype, device=device)
                 for _ in range(n))

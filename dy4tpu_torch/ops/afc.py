"""Automatic frequency control: residual-carrier tracking for IF inputs.
The counterpart of ``dy4tpu/ops/afc.py``, op for op.

A per-channel first-order loop that

1. rotates the IF-rate complex baseband by a carried NCO (``rotate``),
   and
2. integrates the FM discriminator's DC term into the frequency estimate
   (``update``).  The receiver's mono output is the audio LPF (unit DC
   gain) of the discriminator stream, so ``mean(mono_block)`` is the
   residual offset in rad/sample: that is what the wideband pipeline feeds
   back.

Every float32 operation runs in dy4tpu's order: ``phase + freq*k``, the
wrap with round-half-even, then ``trig.sincos``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dy4tpu_torch.ops import trig

Tensor = torch.Tensor

# python floats holding exact float32 values, as dy4tpu's np.float32 ones
_TWO_PI = float(np.float32(2.0 * np.pi))
_INV_TWO_PI = float(np.float32(1.0 / (2.0 * np.pi)))


class AFCState(NamedTuple):
    """Per-channel loop state (batch-shaped scalars)."""
    freq: Tensor   # residual-carrier estimate, rad per IF sample
    phase: Tensor  # NCO phase at the start of the next block, rad


def init_afc_state(batch: tuple[int, ...] = (), dtype=torch.float32,
                   device="cuda") -> AFCState:
    """Zero loop state on ``device`` (the card unless the caller asks for
    the CPU)."""
    z = lambda: torch.zeros(batch, dtype=dtype, device=device)  # noqa: E731
    return AFCState(freq=z(), phase=z())


def _wrap_pi(x: Tensor) -> Tensor:
    """Wrap to [-pi, pi] (``torch.round`` rounds half to even, as
    ``jnp.round``)."""
    return x - _TWO_PI * torch.round(x * _INV_TWO_PI)


def rotate(i_if: Tensor, q_if: Tensor, state: AFCState
           ) -> tuple[Tensor, Tensor, Tensor]:
    """De-rotate one IF block by the carried estimate:
    ``y = x * exp(-j*(phase + freq*k))``.

    ``i_if``/``q_if``: [..., N].  Returns ``(y_i, y_q, phase_next)`` with
    ``phase_next`` wrapped, so the NCO stays phase-continuous across
    blocks without unbounded growth."""
    n = i_if.shape[-1]
    k = torch.arange(n, dtype=torch.float32, device=i_if.device)
    theta = _wrap_pi(state.phase[..., None] + state.freq[..., None] * k)
    s, c = trig.sincos(theta)          # |theta| <= pi: in-domain
    y_i = i_if * c + q_if * s
    y_q = q_if * c - i_if * s
    phase_next = _wrap_pi(state.phase + state.freq * n)
    return y_i, y_q, phase_next


def update(state: AFCState, phase_next: Tensor, dc: Tensor,
           alpha: float = 0.5, max_freq: float | None = None,
           fs: float | None = None) -> AFCState:
    """One loop iteration from the block's discriminator DC term ``dc``
    (batch-shaped, rad/sample): ``freq += alpha * dc``, clamped to
    ``max_freq`` Hz (with ``fs``) when given."""
    freq = state.freq + float(np.float32(alpha)) * dc
    if max_freq is not None:
        if fs is None:
            raise ValueError("max_freq needs fs")
        lim = float(np.float32(2.0 * np.pi * max_freq / fs))
        freq = torch.clamp(freq, -lim, lim)
    return AFCState(freq=freq, phase=phase_next)


def freq_hz(state: AFCState, fs: float) -> Tensor:
    """The tracked residual carrier offset in Hz (diagnostics/UI)."""
    return state.freq * float(np.float32(fs / (2.0 * np.pi)))

"""Pointwise mixers, stereo matrix, delay line and quantisation: the
counterpart of ``dy4tpu/ops/mix.py`` (src/filter.cpp:229-301, the
output quantiser of project.cpp:313-316, and the stereo blend)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def delay_block(x: Tensor, state: Tensor) -> tuple[Tensor, Tensor]:
    """All-pass delay by ``len(state)`` samples (src/filter.cpp:229-251)."""
    d = state.shape[-1]
    out = torch.cat([state, x[..., :-d]], dim=-1)
    return out, x[..., -d:]


def mix(a: Tensor, b: Tensor, gain: float = 2.0) -> Tensor:
    """Pointwise product with mixer gain (src/filter.cpp:253-266)."""
    return a * b * gain


def stereo_matrix(mono: Tensor, stereo: Tensor) -> tuple[Tensor, Tensor]:
    """L = M+S, R = M-S (src/filter.cpp:267-290)."""
    return mono + stereo, mono - stereo


def interleave(left: Tensor, right: Tensor) -> Tensor:
    """Interleave L/R into a 2-channel stream (src/filter.cpp:291-301)."""
    return torch.stack([left, right], dim=-1).reshape(
        *left.shape[:-1], left.shape[-1] * 2)


def quantize_s16(x: Tensor, scale: float = 16384.0) -> Tensor:
    """NaN-guarded float -> s16 PCM (project.cpp:313-316).

    JAX's float -> int16 cast saturates and torch's wraps (2.5 * 16384
    gives 32767 in JAX and -24576 in torch), so clamp before the cast to
    give JAX's result.
    """
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.clamp(x * scale, -32768.0, 32767.0).to(torch.int16)


def squaring_nonlinearity(x: Tensor) -> Tensor:
    """x^2 carrier-recovery nonlinearity for RDS (fmMonoBlock.py:405-409)."""
    return x * x


def stereo_blend(left: Tensor, right: Tensor, pilot_snr_db: Tensor,
                 full_db: float = 14.0, mono_db: float = 4.0
                 ) -> tuple[Tensor, Tensor]:
    """Weak-signal stereo -> mono blend (dy4tpu's ``mix.stereo_blend``):
    the stereo difference fades out as the pilot-lock SNR
    (``StepOutputs.pilot_snr_db``) weakens, g=1 at ``full_db`` and above,
    g=0 at ``mono_db`` and below, linear in dB between, applied after the
    matrix: L' = M + g*S, R' = M - g*S with M=(L+R)/2, S=(L-R)/2."""
    g = torch.clamp((pilot_snr_db - mono_db) / (full_db - mono_db),
                    0.0, 1.0)[..., None]
    m = 0.5 * (left + right)
    s = 0.5 * (left - right)
    return m + g * s, m - g * s

"""The receiver's ``precision=``: dy4tpu's ``jax.lax.Precision`` by name.

    "highest"  float32 operands, float32 sums (dy4tpu's HIGHEST, the
               default everywhere);
    "high"     bf16 operands into the fused kernels; the channelizer's
               DFT in bf16_3x (dy4tpu's HIGH);
    "default"  bf16 operands into the fused kernels and the DFT (dy4tpu's
               DEFAULT, which its bench.py serves).

Below "highest" dy4tpu calls every fused kernel with ``mm_dtype=bf16``:
each filter's taps and its input stream are rounded to bf16 (round to
nearest even) where they enter the matrix unit, and the products are
summed in float32.  A bf16 x bf16 product is exact in float32, so the
port computes the same thing as float32 filters fed the rounded operands;
the kernels round their input streams where they stage them, the wrappers
round the taps (``bf16``).  The tails carried from block to block stay the
unrounded float32 values, so a state hands over between precisions.  The
names are ``bench.py``'s ``BENCH_PRECISION`` values.
"""

from __future__ import annotations

import torch

PRECISIONS = ("highest", "high", "default")


def rounds(precision: str) -> bool:
    """Whether ``precision`` rounds the kernels' operands to bf16 (dy4tpu's
    ``mm = float32 if precision == HIGHEST else bfloat16``).  Raises
    ``ValueError`` on a name not in ``PRECISIONS``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    return precision != "highest"


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (round to nearest even, as JAX's ``astype``)
    and back to float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def rounding(precision: str):
    """The rounding a plain version applies to a filter's input stream and
    history at ``precision``: ``bf16``, or none at "highest"."""
    return bf16 if rounds(precision) else (lambda t: t)


def taps(h, precision: str):
    """Filter taps as a kernel at ``precision`` multiplies them: ``h``
    itself at "highest", else ``bf16(h)``.  dy4tpu rounds its RF and
    channelizer taps as ``bf16(h / 128)`` with the u8 normalisation folded
    in; a power of two scales through the rounding, so that is
    ``bf16(h) / 128``.  None stays None."""
    return bf16(h) if h is not None and rounds(precision) else h

"""Bounded-domain fused sin/cos for NCO synthesis: the counterpart of
``dy4tpu/ops/trig.py``, op for op.

The PLL keeps its carried phases wrapped to [0, 4*pi), so the NCO
arguments are bounded (< 64 rad for every receiver configuration).  That
admits a small-quotient Cody-Waite reduction with the single-precision
Cephes ``sinf`` splits of pi/2 and the Cephes minimax kernel polynomials
on [-pi/4, pi/4]: about 1 ulp over the admissible domain.

Domain contract: |x| <= 2048 rad.  ``torch.round``, like
``jnp.round``, rounds half to even.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

# python floats holding exact float32 values: a float32 tensor op with
# one of these rounds exactly as dy4tpu's np.float32 constants do
_TWO_OVER_PI = float(np.float32(0.6366197723675814))
# pi/2 = PIO2_1 + PIO2_2 + PIO2_3 to ~1e-17 (Cephes DP1..3 * 2)
_PIO2_1 = float(np.float32(1.5703125))
_PIO2_2 = float(np.float32(4.837512969970703125e-4))
_PIO2_3 = float(np.float32(7.549789948768648e-8))

# Cephes single-precision kernels on [-pi/4, pi/4]
_S1 = float(np.float32(-1.6666654611e-1))
_S2 = float(np.float32(8.3321608736e-3))
_S3 = float(np.float32(-1.9515295891e-4))
_C1 = float(np.float32(4.166664568298827e-2))
_C2 = float(np.float32(-1.388731625493765e-3))
_C3 = float(np.float32(2.443315711809948e-5))


def sincos(x: Tensor) -> tuple[Tensor, Tensor]:
    """(sin x, cos x) for |x| <= 2048; the two share the range reduction
    and the r^2 powers."""
    x = x.to(torch.float32)
    q = torch.round(x * _TWO_OVER_PI)
    r = ((x - q * _PIO2_1) - q * _PIO2_2) - q * _PIO2_3
    m = q.to(torch.int32) & 3            # quadrant (two's complement mod)
    z = r * r
    s = r + r * z * (_S1 + z * (_S2 + z * _S3))
    c = 1.0 + z * (-0.5 + z * (_C1 + z * (_C2 + z * _C3)))
    swap = (m & 1) == 1
    s_sel = torch.where(swap, c, s)
    c_sel = torch.where(swap, s, c)
    # sin(r + m*pi/2): m=0:s 1:c 2:-s 3:-c ; cos: m=0:c 1:-s 2:-c 3:s
    s_out = torch.where(m >= 2, -s_sel, s_sel)
    c_out = torch.where((m == 1) | (m == 2), -c_sel, c_sel)
    return s_out, c_out


def sin(x: Tensor) -> Tensor:
    return sincos(x)[0]


def cos(x: Tensor) -> Tensor:
    return sincos(x)[1]


def nco_sincos(x: Tensor) -> tuple[Tensor, Tensor]:
    """The NCO-synthesis trig of ``pll.pll``: the bulk synthesis and the
    carried ``nco``/``nco_q`` go through this one function, so streaming
    and contiguous runs stay bit-identical."""
    return sincos(x)

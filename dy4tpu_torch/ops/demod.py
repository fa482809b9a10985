"""FM demodulator: the counterpart of ``dy4tpu/ops/demod.py``.

``fm_demod_diff`` is the arctan-free differentiator the reference runs in
real time (``fmDemodArctan`` src/filter.cpp:85-102, despite its name):

    fm[k] = (I[k]*(Q[k]-Q[k-1]) - Q[k]*(I[k]-I[k-1])) / (I[k]^2 + Q[k]^2)

with the previous block's last I/Q pair carried as state and a zero-power
guard mapping 0/0 to 0 (src/filter.cpp:88-92).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def fm_demod_diff(i: Tensor, q: Tensor, prev_i: Tensor, prev_q: Tensor
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """Differentiator FM demod over a block.

    ``i``/``q``: [..., N]; ``prev_i``/``prev_q``: [...] scalars per stream.
    Returns ``(fm, new_prev_i, new_prev_q)``.
    """
    i_prev = torch.cat([prev_i[..., None], i[..., :-1]], dim=-1)
    q_prev = torch.cat([prev_q[..., None], q[..., :-1]], dim=-1)
    power = i * i + q * q
    num = i * (q - q_prev) - q * (i - i_prev)
    zero = power == 0
    fm = torch.where(zero, 0.0, num / torch.where(zero, 1.0, power))
    return fm, i[..., -1], q[..., -1]

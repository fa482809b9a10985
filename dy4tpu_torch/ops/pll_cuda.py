"""PLL phase scan: the CUDA kernel (``csrc/pll.cu``) and its plain torch
version.

Replaces ``dy4tpu/ops/pll_pallas.py :: phase_scan`` (sign mode).  The
recurrence is serial in time and parallel only over streams (C channels
x 2 lanes at mode 0), so it is latency-bound: the kernel gives each
stream one thread with the carry in registers (see the note in
``csrc/pll.cu``).  Both versions emit the same bits: the kernel is built
without FMA contraction and performs ``pll._make_step``'s operations in
the same order.
"""

from __future__ import annotations

import ctypes

import torch

from dy4tpu_torch.ops import pll as _pll
from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 2
         + [ctypes.c_float] * 4 + [ctypes.c_void_p])


def phase_scan_plain(pll_in: Tensor, kp: Tensor, ki: Tensor,
                     dtheta: Tensor, carry: tuple[Tensor, Tensor, Tensor]
                     ) -> tuple[Tensor, tuple[Tensor, Tensor, Tensor]]:
    """``pll_in`` [..., N] -> (phis [..., N], carry at the end).  ``kp``/
    ``ki``/``dtheta`` and the carry fields broadcast to the batch dims.
    A Python loop over the N samples of the block."""
    step = _pll._make_step(kp, ki, dtheta)
    x_t = pll_in.movedim(-1, 0)                    # [N, ...] time-major
    target = torch.where(x_t < 0, _pll.PI, 0.0)
    is_zero = x_t == 0.0                           # zero-input guard
    phis = torch.empty_like(x_t)
    for t in range(x_t.shape[0]):
        carry, phis[t] = step(carry, target[t], is_zero[t])
    return phis.movedim(0, -1), carry


def phase_scan(pll_in: Tensor, kp: Tensor, ki: Tensor, dtheta: Tensor,
               carry: tuple[Tensor, Tensor, Tensor]
               ) -> tuple[Tensor, tuple[Tensor, Tensor, Tensor]]:
    """The kernel for a CUDA tensor, ``phase_scan_plain`` for a CPU one;
    same contract as ``phase_scan_plain``.  ``pll_in`` must be a contiguous
    float32 tensor."""
    if pll_in.device.type == "cpu":
        return phase_scan_plain(pll_in, kp, ki, dtheta, carry)
    batch = pll_in.shape[:-1]
    n = pll_in.shape[-1]
    dev = pll_in.device
    kernels.require(pll_in, "pll_in", pll_in.shape, device=dev)
    flat = lambda a: (torch.broadcast_to(a, batch)  # noqa: E731
                      .reshape(-1).to(dev, torch.float32).contiguous())
    kp_s, ki_s, dth_s = flat(kp), flat(ki), flat(dtheta)
    c_in = [flat(c) for c in carry]
    s = kp_s.numel()
    phi = torch.empty_like(pll_in)
    c_out = [torch.empty(s, dtype=torch.float32, device=dev)
             for _ in range(3)]
    fn = kernels.entry("pll", "dy4_pll_phase_scan", _ARGS)
    with torch.cuda.device(dev):
        status = fn(pll_in.data_ptr(), kp_s.data_ptr(), ki_s.data_ptr(),
                    dth_s.data_ptr(), *(c.data_ptr() for c in c_in),
                    phi.data_ptr(), *(c.data_ptr() for c in c_out), s, n,
                    _pll.PI, _pll.TWO_PI, _pll.INV_TWO_PI, _pll.WRAP,
                    kernels.stream_of(pll_in))
    kernels.check_launch(status, "pll phase_scan")
    phase_scan.launches += 1
    return phi, tuple(c.reshape(batch) for c in c_out)


phase_scan.launches = 0

"""PLL phase scans: the CUDA kernels (``csrc/pll.cu``) and their plain
torch versions.

``phase_scan`` (B2) replaces ``dy4tpu/ops/pll_pallas.py :: phase_scan``
in sign mode: the per-sample recurrence.  ``phase_scan_target`` (B9)
replaces the same Pallas kernel in target mode with ``emit_integ``: the
span PLL's one update per span, driven by span detector targets.  Both
recurrences are serial in time and parallel only over streams (C channels
x 2 lanes at mode 0), so they are latency-bound: each kernel gives each
stream one thread with the carry in registers (see the note in
``csrc/pll.cu``).  Kernel and plain version emit the same bits: the
kernels are built without FMA contraction and perform ``pll._make_step``'s
and ``pll._make_span_step``'s operations in the same order.
"""

from __future__ import annotations

import ctypes

import torch

from dy4tpu_torch.ops import pll as _pll
from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 2
         + [ctypes.c_float] * 4 + [ctypes.c_void_p])
_TARGET_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 2
                + [ctypes.c_float] * 5 + [ctypes.c_void_p])


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


def phase_scan_target_plain(targets: Tensor, kp: Tensor, ki: Tensor,
                            dtheta: Tensor,
                            carry: tuple[Tensor, Tensor, Tensor], *,
                            span: int
                            ) -> tuple[Tensor, Tensor,
                                       tuple[Tensor, Tensor, Tensor]]:
    """``targets`` [..., M] span detector targets (NaN: a dead span) ->
    ``(phi0, i0, carry at the end)``: the pre-update phase and the
    pre-update integrator of every span.  ``kp``/``ki``/``dtheta`` are
    the span's effective constants (``pll._span_consts``), broadcasting
    to the batch dims like the carry fields.  A Python loop over the M
    spans."""
    step = _pll._make_span_step(kp, ki, dtheta, float(span))
    t_t = targets.movedim(-1, 0)                   # [M, ...] time-major
    dead = t_t != t_t                              # NaN: error 0
    phi0 = torch.empty_like(t_t)
    i0 = torch.empty_like(t_t)
    for t in range(t_t.shape[0]):
        i0[t] = carry[0]
        carry, phi0[t] = step(carry, t_t[t], dead[t])
    return phi0.movedim(0, -1), i0.movedim(0, -1), carry


def phase_scan_target(targets: Tensor, kp: Tensor, ki: Tensor,
                      dtheta: Tensor, carry: tuple[Tensor, Tensor, Tensor],
                      *, span: int
                      ) -> tuple[Tensor, Tensor,
                                 tuple[Tensor, Tensor, Tensor]]:
    """The B9 kernel for a CUDA tensor, ``phase_scan_target_plain`` for a
    CPU one; same contract.  ``targets`` must be a contiguous float32
    tensor."""
    if targets.device.type == "cpu":
        return phase_scan_target_plain(targets, kp, ki, dtheta, carry,
                                       span=span)
    batch = targets.shape[:-1]
    m = targets.shape[-1]
    dev = targets.device
    kernels.require(targets, "targets", targets.shape, device=dev)
    flat = lambda a: (torch.broadcast_to(a, batch)  # noqa: E731
                      .reshape(-1).to(dev, torch.float32).contiguous())
    kp_s, ki_s, dth_s = flat(kp), flat(ki), flat(dtheta)
    c_in = [flat(c) for c in carry]
    s = kp_s.numel()
    phi0 = torch.empty_like(targets)
    i0 = torch.empty_like(targets)
    c_out = [torch.empty(s, dtype=torch.float32, device=dev)
             for _ in range(3)]
    fn = kernels.entry("pll", "dy4_pll_span_scan", _TARGET_ARGS)
    with torch.cuda.device(dev):
        status = fn(targets.data_ptr(), kp_s.data_ptr(), ki_s.data_ptr(),
                    dth_s.data_ptr(), *(c.data_ptr() for c in c_in),
                    phi0.data_ptr(), i0.data_ptr(),
                    *(c.data_ptr() for c in c_out), s, m, float(span),
                    _pll.PI, _pll.TWO_PI, _pll.INV_TWO_PI, _pll.WRAP,
                    kernels.stream_of(targets))
    kernels.check_launch(status, "pll phase_scan_target")
    phase_scan_target.launches += 1
    return phi0, i0, tuple(c.reshape(batch) for c in c_out)


phase_scan_target.launches = 0

"""PLL phase scans: the CUDA kernels (``csrc/pll.cu``) and their plain
torch versions.

``phase_scan`` (B2) replaces ``dy4tpu/ops/pll_pallas.py :: phase_scan``
in sign mode: the per-sample recurrence.  ``phase_scan_target`` (B9)
replaces the same Pallas kernel in target mode with ``emit_integ``: the
span PLL's one update per span, driven by span detector targets.
With ``expand=`` (the per-sample constants) ``phase_scan_target`` launches
B9-expand, the Pallas kernel's ``expand=K`` option: the same scan, emitting
the K within-span phases of every span (``pll._span_expand``'s operations
in its order) in place of ``phi0`` and ``i0``.
``phase_scan_coded`` (B8) replaces ``pll_pallas.py :: phase_scan_coded``
(the kernel in coded mode): the per-sample recurrence replayed from int8
sign codes, INVALID codes freezing the carry, with a carry snapshot after
``split_at`` samples.  The recurrences are serial in time and parallel
only over streams (C channels x 2 lanes at mode 0), so they are
latency-bound: each kernel gives each stream one thread with the carry in
registers, and all four run one tile loop: a warp scans 128-step tiles
from shared memory while data warps of its block copy the next tile in
and store what the last one emitted (B9-expand's data warps also build
its within-span phases; B8 cuts the tile that holds ``split_at`` into two
runs; see the note in ``csrc/pll.cu``).  Kernel and plain version
emit the same bits: the kernels are built without FMA contraction and
perform ``pll._make_step``'s and ``pll._make_span_step``'s operations in
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
_TARGET_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 2
                + [ctypes.c_float] * 5 + [ctypes.c_void_p])
_EXPAND_ARGS = ([ctypes.c_void_p] * 14 + [ctypes.c_longlong] * 2
                + [ctypes.c_int] + [ctypes.c_float] * 5 + [ctypes.c_void_p])
_CODED_ARGS = ([ctypes.c_void_p] * 14 + [ctypes.c_longlong] * 3
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


def phase_scan_target_plain(targets: Tensor, kp: Tensor, ki: Tensor,
                            dtheta: Tensor,
                            carry: tuple[Tensor, Tensor, Tensor], *,
                            span: int, expand=None):
    """``targets`` [..., M] span detector targets (NaN: a dead span) ->
    ``(phi0, i0, carry at the end)``: the pre-update phase and the
    pre-update integrator of every span.  ``kp``/``ki``/``dtheta`` are
    the span's effective constants (``pll._span_consts``), broadcasting
    to the batch dims like the carry fields.  A Python loop over the M
    spans.

    ``expand``: the per-sample ``(kp, ki, dtheta)``; then the result is
    ``(phis [..., M*span], carry at the end)``, ``pll._span_expand`` of
    the scan's output (B9-expand's plain version)."""
    step = _pll._make_span_step(kp, ki, dtheta, float(span))
    t_t = targets.movedim(-1, 0)                   # [M, ...] time-major
    dead = t_t != t_t                              # NaN: error 0
    phi0 = torch.empty_like(t_t)
    i0 = torch.empty_like(t_t)
    for t in range(t_t.shape[0]):
        i0[t] = carry[0]
        carry, phi0[t] = step(carry, t_t[t], dead[t])
    phi0, i0 = phi0.movedim(0, -1), i0.movedim(0, -1)
    if expand is None:
        return phi0, i0, carry
    return _pll._span_expand(phi0, i0, targets, *expand, span), carry


def phase_scan_target(targets: Tensor, kp: Tensor, ki: Tensor,
                      dtheta: Tensor, carry: tuple[Tensor, Tensor, Tensor],
                      *, span: int, expand=None):
    """The B9 kernel (B9-expand with ``expand``) for a CUDA tensor,
    ``phase_scan_target_plain`` for a CPU one; same contract.  ``targets``
    must be a contiguous float32 tensor.

    Launches are counted per variant: ``phase_scan_target.launches`` for
    B9, ``phase_scan_target.expand.launches`` for B9-expand."""
    if targets.device.type == "cpu":
        return phase_scan_target_plain(targets, kp, ki, dtheta, carry,
                                       span=span, expand=expand)
    batch = targets.shape[:-1]
    m = targets.shape[-1]
    dev = targets.device
    kernels.require(targets, "targets", targets.shape, device=dev)
    flat = lambda a: (torch.broadcast_to(a, batch)  # noqa: E731
                      .reshape(-1).to(dev, torch.float32).contiguous())
    kp_s, ki_s, dth_s = flat(kp), flat(ki), flat(dtheta)
    c_in = [flat(c) for c in carry]
    s = kp_s.numel()
    c_out = [torch.empty(s, dtype=torch.float32, device=dev)
             for _ in range(3)]
    consts = (_pll.PI, _pll.TWO_PI, _pll.INV_TWO_PI, _pll.WRAP)
    if expand is not None:
        per_sample = [flat(a) for a in expand]
        phis = torch.empty((*batch, m * span), dtype=torch.float32,
                           device=dev)
        fn = kernels.entry("pll", "dy4_pll_span_expand", _EXPAND_ARGS)
        with torch.cuda.device(dev):
            status = fn(targets.data_ptr(), kp_s.data_ptr(), ki_s.data_ptr(),
                        dth_s.data_ptr(), *(c.data_ptr() for c in c_in),
                        *(a.data_ptr() for a in per_sample), phis.data_ptr(),
                        *(c.data_ptr() for c in c_out), s, m, span,
                        float(span), *consts, kernels.stream_of(targets))
        kernels.check_launch(status, "pll phase_scan_target[expand]")
        phase_scan_target.expand.launches += 1
        return phis, tuple(c.reshape(batch) for c in c_out)
    phi0 = torch.empty_like(targets)
    i0 = torch.empty_like(targets)
    fn = kernels.entry("pll", "dy4_pll_span_scan", _TARGET_ARGS)
    with torch.cuda.device(dev):
        status = fn(targets.data_ptr(), kp_s.data_ptr(), ki_s.data_ptr(),
                    dth_s.data_ptr(), *(c.data_ptr() for c in c_in),
                    phi0.data_ptr(), i0.data_ptr(),
                    *(c.data_ptr() for c in c_out), s, m, float(span),
                    *consts, kernels.stream_of(targets))
    kernels.check_launch(status, "pll phase_scan_target")
    phase_scan_target.launches += 1
    return phi0, i0, tuple(c.reshape(batch) for c in c_out)


phase_scan_target.launches = 0
phase_scan_target.expand = kernels.Variant("phase_scan_target[expand]")


def phase_scan_coded_plain(codes: Tensor, kp: Tensor, ki: Tensor,
                           dtheta: Tensor,
                           carry: tuple[Tensor, Tensor, Tensor], *,
                           split_at: int
                           ) -> tuple[Tensor, tuple[Tensor, Tensor, Tensor],
                                      tuple[Tensor, Tensor, Tensor]]:
    """``codes`` [..., M] int8 sign codes (``pll.CODE_*``) -> ``(phis
    [..., M], carry after split_at samples, carry at the end)``, with
    0 <= split_at <= M.  ``kp``/``ki``/``dtheta`` and the carry fields
    broadcast to the batch dims.  A Python loop over the M samples of
    ``pll._make_step``; an INVALID code keeps the whole carry
    (``torch.where(valid, new, old)``) but its phase is still emitted."""
    step = _pll._make_step(kp, ki, dtheta)
    c_t = codes.movedim(-1, 0)                     # [M, ...] time-major
    target = torch.where(c_t == _pll.CODE_NEG, _pll.PI, 0.0)
    is_zero = c_t == _pll.CODE_ZERO
    valid = c_t != _pll.CODE_INVALID
    phis = torch.empty(c_t.shape, dtype=torch.float32, device=codes.device)
    mid = carry
    for t in range(c_t.shape[0]):
        if t == split_at:
            mid = carry
        new, phis[t] = step(carry, target[t], is_zero[t])
        carry = tuple(torch.where(valid[t], a, b) for a, b in zip(new, carry))
    if split_at == c_t.shape[0]:
        mid = carry
    return phis.movedim(0, -1), mid, carry


def phase_scan_coded(codes: Tensor, kp: Tensor, ki: Tensor, dtheta: Tensor,
                     carry: tuple[Tensor, Tensor, Tensor], *, split_at: int
                     ) -> tuple[Tensor, tuple[Tensor, Tensor, Tensor],
                                tuple[Tensor, Tensor, Tensor]]:
    """The B8 kernel for a CUDA tensor, ``phase_scan_coded_plain`` for a
    CPU one; same contract.  ``codes`` must be a contiguous int8 tensor."""
    batch = codes.shape[:-1]
    m = codes.shape[-1]
    if not 0 <= split_at <= m:
        raise ValueError(f"split_at {split_at} outside [0, {m}]")
    if codes.device.type == "cpu":
        return phase_scan_coded_plain(codes, kp, ki, dtheta, carry,
                                      split_at=split_at)
    dev = codes.device
    kernels.require(codes, "codes", codes.shape, torch.int8, dev)
    flat = lambda a: (torch.broadcast_to(a, batch)  # noqa: E731
                      .reshape(-1).to(dev, torch.float32).contiguous())
    kp_s, ki_s, dth_s = flat(kp), flat(ki), flat(dtheta)
    c_in = [flat(c) for c in carry]
    s = kp_s.numel()
    phi = torch.empty(codes.shape, dtype=torch.float32, device=dev)
    c_mid, c_out = ([torch.empty(s, dtype=torch.float32, device=dev)
                     for _ in range(3)] for _ in range(2))
    fn = kernels.entry("pll", "dy4_pll_phase_scan_coded", _CODED_ARGS)
    with torch.cuda.device(dev):
        status = fn(codes.data_ptr(), kp_s.data_ptr(), ki_s.data_ptr(),
                    dth_s.data_ptr(), *(c.data_ptr() for c in c_in),
                    phi.data_ptr(), *(c.data_ptr() for c in c_mid),
                    *(c.data_ptr() for c in c_out), s, m, split_at,
                    _pll.PI, _pll.TWO_PI, _pll.INV_TWO_PI, _pll.WRAP,
                    kernels.stream_of(codes))
    kernels.check_launch(status, "pll phase_scan_coded")
    phase_scan_coded.launches += 1
    return (phi, tuple(c.reshape(batch) for c in c_mid),
            tuple(c.reshape(batch) for c in c_out))


phase_scan_coded.launches = 0

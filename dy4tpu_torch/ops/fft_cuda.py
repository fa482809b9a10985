"""The batched FFT over the last axis: the CUDA kernel B10
(``csrc/fft.cu``) and its plain torch version, the four-step algorithm.

Replaces the Pallas kernel of ``dy4tpu/ops/fft_pallas.py :: fft_pallas``.
The kernel is a Stockham FFT with a register radix plan (``_plan``: radix
8 passes, then one of 4 or 2), its twiddles a host-built table
(``_plan_twiddles``); ``_fft_plan_model`` runs the same passes, twiddle
indices, butterflies and output order in torch, for the CPU tests only.
The plain version ``fft_four_step`` is dy4tpu's ``fft_four_step``, N = N1
x N2 with N2 = min(N, 128), as two complex64 einsums over the same
host-built constants (``_factor``, ``_consts``):

    X[k1 + N1*k2] = sum_n2 W_N2^(n2 k2) * W_N^(n2 k1)
                    * sum_n1 x[n1*N2 + n2] * W_N1^(n1 k1)

``fft`` takes CUDA tensors only and raises on any other: the choice of
route is ``ops/fft.py :: estimate_psd``'s (``impl="auto"``: this kernel
for a CUDA tensor, ``torch.fft.fft`` for a CPU one).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dy4tpu_torch.ops.fir import _no_tf32
from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

_MAX_N1 = 16          # dy4tpu's first-stage unroll bound: N <= 2048

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]


@functools.cache
def _factor(n: int) -> tuple[int, int]:
    if n & (n - 1) or n < 4:
        raise ValueError(f"N={n} must be a power of two >= 4")
    n2 = min(n, 128)                         # one lane tile
    n1 = n // n2
    if n1 > n2:
        raise ValueError(f"N={n} too large (N1={n1} > N2={n2})")
    return n1, n2


def kernel_supported(n: int) -> bool:
    """Whether B10 takes rows of length ``n``: the N that dy4tpu's
    ``pallas_supported`` takes, a power of two in 4..2048."""
    try:
        n1, _ = _factor(n)
    except ValueError:
        return False
    return n1 <= _MAX_N1


@functools.cache
def _consts(n: int):
    n1, n2 = _factor(n)
    f1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    f2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n)
    c64 = lambda a: a.astype(np.complex64)  # noqa: E731
    return c64(f1), c64(f2), c64(tw)        # F1, F2, TW[k1, n2]


def fft_four_step(x: Tensor) -> Tensor:
    """The four-step algorithm as plain torch ops (two complex64 einsums)
    over the last axis of ``x`` (real or complex, any device); complex64
    out in ``torch.fft.fft`` order.  TF32 is turned off first on a CUDA
    tensor, or the einsums keep only about three decimal digits."""
    _no_tf32(x)
    n = x.shape[-1]
    n1, n2 = _factor(n)
    f1, f2, tw = (torch.from_numpy(c).to(x.device) for c in _consts(n))
    a = x.to(torch.complex64).reshape(*x.shape[:-1], n1, n2)
    g = torch.einsum("kn,...nm->...km", f1, a)
    y = torch.einsum("...km,mj->...kj", g * tw, f2)
    return y.transpose(-1, -2).reshape(*x.shape[:-1], n)


@functools.cache
def _plan(n: int) -> tuple[int, ...]:
    """B10's radix sequence for rows of length ``n``: radix 8 passes, then
    one pass of 4 or 2 for the rest (``(4,)`` at N = 4), so the first
    radix is the kernel's elements per thread (8, or 4 at N = 4)."""
    if not kernel_supported(n):
        raise ValueError(f"B10 takes N a power of two in 4..2048, got N={n}")
    if n == 4:
        return (4,)
    plan, m = [], n
    while m % 8 == 0:
        plan.append(8)
        m //= 8
    if m > 1:
        plan.append(m)
    return tuple(plan)


def _plan_code(n: int) -> int:
    """``_plan(n)`` as the kernel takes it: log2 of each radix, 4 bits
    each from the lowest."""
    return sum((r.bit_length() - 1) << (4 * p)
               for p, r in enumerate(_plan(n)))


@functools.cache
def _plan_twiddles(n: int) -> np.ndarray:
    """The kernel's twiddle table, complex64 computed in float64: for each
    pass p >= 1 of radix R after radices of product Ns, W_{Ns R}^(k r) at
    [(r - 1) Ns + k], r = 1..R-1, k < Ns, the passes in order."""
    parts, ns = [], 1
    for p, r in enumerate(_plan(n)):
        if p:
            k = np.arange(ns)
            parts.append(np.exp(-2j * np.pi * np.outer(np.arange(1, r), k)
                                / (ns * r)).ravel())
        ns *= r
    if not parts:
        return np.zeros(0, np.complex64)
    return np.concatenate(parts).astype(np.complex64)


@functools.cache
def _twiddles(n: int, device: torch.device) -> Tensor:
    """``_plan_twiddles(n)`` on ``device``: the kernel's table."""
    return torch.from_numpy(_plan_twiddles(n)).to(device)


def _dft_radix(v: Tensor) -> Tensor:
    """The kernel's R-point DFT (R = 2, 4, 8) over the last axis of a
    complex64 ``v``, in its butterflies' order: radix 8 as two radix-4 DFTs
    of the even and odd elements and a radix-2 stage with W_8^k."""
    r = v.shape[-1]
    if r == 2:
        return torch.stack([v[..., 0] + v[..., 1], v[..., 0] - v[..., 1]], -1)
    if r == 4:
        a, b, c, d = v.unbind(-1)
        s0, d0, s1 = a + c, a - c, b + d
        d1 = (b - d) * -1j
        return torch.stack([s0 + s1, d0 + d1, s0 - s1, d0 - d1], -1)
    e = _dft_radix(v[..., 0::2])
    c = np.float32(0.70710678118654752)
    w = torch.tensor([1, complex(c, -c), -1j, complex(-c, -c)],
                     dtype=torch.complex64)
    o = _dft_radix(v[..., 1::2]) * w
    return torch.cat([e + o, e - o], -1)


def _fft_plan_model(x: Tensor) -> Tensor:
    """B10's algorithm as plain torch ops, for the CPU tests: the passes
    of ``_plan``, butterfly b of a radix-R pass reading elements
    b + r N/R, scaling element r by the table's W_{Ns R}^((b mod Ns) r),
    taking ``_dft_radix`` and writing (b / Ns) Ns R + b mod Ns + r Ns, so
    the last pass leaves the row in natural order.  ``x`` [..., N] real or
    complex on the CPU; complex64 out in ``torch.fft.fft`` order.  No path
    of the port calls it."""
    n = x.shape[-1]
    tw = torch.from_numpy(_plan_twiddles(n))
    v = x.to(torch.complex64).reshape(-1, n)
    ns, off = 1, 0
    for p, r in enumerate(_plan(n)):
        b = torch.arange(n // r)
        rr = torch.arange(r)
        g = v[:, b[:, None] + rr * (n // r)]                # [rows, N/R, R]
        if p:
            idx = off + (rr[1:] - 1) * ns + (b % ns)[:, None]
            g = torch.cat([g[..., :1], g[..., 1:] * tw[idx]], -1)
            off += (r - 1) * ns
        g = _dft_radix(g)
        dst = (b // ns) * ns * r + b % ns
        out = torch.empty_like(v)
        out[:, dst[:, None] + rr * ns] = g
        v, ns = out, ns * r
    return v.reshape(x.shape)


def fft(x: Tensor) -> Tensor:
    """The FFT over the last axis of ``x`` through the kernel.

    ``x`` [..., N]: a contiguous float32 or complex64 CUDA tensor, N a
    power of two in 4..2048 (``kernel_supported``).  Returns complex64
    [..., N] in ``torch.fft.fft`` order, as ``fft_four_step`` does.  A
    real ``x`` is read as it is (no imaginary plane is made).  Raises on
    an unsupported N, another dtype, a tensor that is not on a CUDA
    device, and a non-contiguous one.
    """
    n = x.shape[-1]
    if not kernel_supported(n):
        raise ValueError(f"B10 takes N a power of two in 4..2048, got "
                         f"N={n} (fft_four_step takes any power of two "
                         f"the four-step factors)")
    if x.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"B10 takes float32 or complex64, got {x.dtype}")
    kernels.require(x, "x", x.shape, x.dtype)
    rows = x.numel() // n
    out = torch.empty(x.shape, dtype=torch.complex64, device=x.device)
    if rows == 0:
        return out
    tw = _twiddles(n, x.device)
    fn = kernels.entry("fft", "dy4_fft", _ARGS)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), int(x.is_complex()), tw.data_ptr(),
                    tw.numel(), out.data_ptr(), rows, n, _plan_code(n),
                    kernels.stream_of(x))
    kernels.check_launch(status, "fft")
    fft.launches += 1
    return out


fft.launches = 0

"""The batched FFT over the last axis: the CUDA kernel B10
(``csrc/fft.cu``) and its plain torch version, the four-step algorithm.

Replaces the Pallas kernel of ``dy4tpu/ops/fft_pallas.py :: fft_pallas``.
The kernel is a radix-2 FFT of whole rows in shared memory; the plain
version ``fft_four_step`` is dy4tpu's ``fft_four_step``, N = N1 x N2 with
N2 = min(N, 128), as two complex64 einsums over the same host-built
constants (``_factor``, ``_consts``):

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

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


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
def _twiddles(n: int, device: torch.device) -> Tensor:
    """W_N^k for k < N/2, computed in float64 on the host, complex64 on
    ``device``: the kernel's table."""
    w = np.exp(-2j * np.pi * np.arange(n // 2) / n).astype(np.complex64)
    return torch.from_numpy(w).to(device)


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
                    out.data_ptr(), rows, n, kernels.stream_of(x))
    kernels.check_launch(status, "fft")
    fft.launches += 1
    return out


fft.launches = 0

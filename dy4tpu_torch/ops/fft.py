"""Fourier transforms and Bartlett PSD estimation in PyTorch: the
counterpart of ``dy4tpu/ops/fft.py``.

  * ``dft``/``idft``: the O(N^2) transforms (src/fourier.cpp:14-22,92-101)
    as one complex matmul.
  * ``fft_radix2``/``ifft_radix2``: iterative radix-2 DIT
    (src/fourier.cpp:189-211 ``FFT_optimized``) with the bit-reversal
    permutation precomputed once per N and every butterfly level one
    vectorised pass.
  * ``estimate_psd``: Hann-windowed Bartlett average in dB
    (src/fourier.cpp:35-88, fmSupportLib.py:86-161), its segment
    transforms through kernel B10 (``ops/fft_cuda.py``) on the card.

``NFFT = 512`` is the reference default (include/dy4.h:18).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dy4tpu_torch.ops import fft_cuda
from dy4tpu_torch.ops.fir import _no_tf32

Tensor = torch.Tensor

NFFT = 512

_IMPLS = ("auto", "kernel", "four_step", "torch")


def dft(x: Tensor) -> Tensor:
    """O(N^2) DFT as a complex matmul (src/fourier.cpp:14-22)."""
    n = x.shape[-1]
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n).astype(np.complex64)
    _no_tf32(x)
    return x.to(torch.complex64) @ torch.from_numpy(w).to(x.device)


def idft(xf: Tensor) -> Tensor:
    """O(N^2) inverse DFT (src/fourier.cpp:92-101)."""
    n = xf.shape[-1]
    k = np.arange(n)
    w = (np.exp(2j * np.pi * np.outer(k, k) / n) / n).astype(np.complex64)
    _no_tf32(xf)
    return xf.to(torch.complex64) @ torch.from_numpy(w).to(xf.device)


@functools.cache
def _bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int32)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def fft_radix2(x: Tensor) -> Tensor:
    """Iterative radix-2 DIT FFT (src/fourier.cpp:189-211), vectorised.

    ``x``: [..., N] real or complex, N a power of two.
    """
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"N={n} must be a power of two")
    batch = x.shape[:-1]
    rev = torch.from_numpy(_bit_reverse_indices(n)).long().to(x.device)
    out = x.to(torch.complex64)[..., rev]
    s = 1
    while s < n:
        tw = torch.from_numpy(np.exp(-2j * np.pi * np.arange(s) / (2 * s))
                              .astype(np.complex64)).to(x.device)
        v = out.reshape(*batch, n // (2 * s), 2, s)
        even, odd = v[..., 0, :], v[..., 1, :] * tw
        out = torch.cat([even + odd, even - odd], dim=-1).reshape(*batch, n)
        s *= 2
    return out


def ifft_radix2(xf: Tensor) -> Tensor:
    """Inverse via conjugation of the forward radix-2 transform."""
    n = xf.shape[-1]
    y = fft_radix2(torch.conj_physical(xf.to(torch.complex64)))
    return torch.conj_physical(y) / n


def hann_sq(n: int) -> np.ndarray:
    """The reference's sin^2 Hann window (src/fourier.cpp:47-49)."""
    i = np.arange(n)
    return (np.sin(i * np.pi / n) ** 2).astype(np.float32)


def estimate_psd(samples: Tensor, nfft: int = NFFT, fs: float = 1.0,
                 impl: str = "auto") -> tuple[np.ndarray, Tensor]:
    """Bartlett PSD estimate in dB (src/fourier.cpp:35-88).

    ``samples``: [..., M] with M >= nfft, real (float32) or complex; the
    trailing partial segment is dropped.  Returns ``(freq[nfft/2],
    psd[..., nfft/2])``, ``psd`` a float32 tensor on the samples' device.

    ``impl`` selects the segment transform: "kernel" (B10,
    ``fft_cuda.fft``: CUDA tensors and ``kernel_supported(nfft)`` only,
    raising otherwise), "four_step" (the same four-step algorithm as
    dy4tpu's, plain torch), "torch" (``torch.fft.fft``, dy4tpu's "jnp"),
    or "auto": for a CUDA tensor B10 where it takes ``nfft``, else
    "four_step" (dy4tpu's routing on its TPU); for a CPU tensor "torch".
    The dB reduction after the transform is plain torch, as dy4tpu leaves
    it to XLA.
    """
    if impl not in _IMPLS:
        raise ValueError(f"impl={impl!r}: expected one of {_IMPLS}")
    samples = torch.as_tensor(samples)
    samples = samples.to(torch.complex64 if samples.is_complex()
                         else torch.float32)
    m = samples.shape[-1]
    segs = m // nfft
    freq = np.arange(nfft // 2) * (fs / nfft)
    x = samples[..., :segs * nfft].reshape(
        *samples.shape[:-1], segs, nfft) * torch.from_numpy(
            hann_sq(nfft)).to(samples.device)
    if impl == "auto":
        if x.is_cuda:
            impl = ("kernel" if fft_cuda.kernel_supported(nfft)
                    else "four_step")
        else:
            impl = "torch"
    if impl == "kernel":
        xf = fft_cuda.fft(x)
    elif impl == "four_step":
        xf = fft_cuda.fft_four_step(x)
    else:
        xf = torch.fft.fft(x, dim=-1)
    xf = xf[..., : nfft // 2]
    psd = (2.0 / (fs * nfft / 2.0)) * xf.abs() ** 2
    psd_db = 10.0 * torch.log10(psd)
    return freq, psd_db.mean(dim=-2)


def vector_magnitude(xf: Tensor) -> Tensor:
    """|X|/N (src/fourier.cpp:25-32)."""
    return xf.abs() / xf.shape[-1]

"""B14, the decimating block FIR as a CUDA kernel (``csrc/fir.cu``), and
its plain torch version.

``block_fir_decim`` replaces ``dy4tpu/ops/fir_pallas.py ::
block_fir_decim_pallas``: ``x [..., N]`` float32 with ``N % D == 0``,
``h [K]``, ``state [..., K-1]`` -> ``y [..., N/D]`` and the last K-1
inputs as the new state, exactly.  Its plain version is ``fir.py``'s
conv1d (``fir.block_fir_decim(impl="plain")``), which is also the one
PyTorch call computing the same function.  dy4tpu's ``K/D <= 128`` limit
is a TPU window margin and is not copied.  No receiver route runs it, in
dy4tpu or here: ``fir.block_fir_decim(..., impl="kernel")`` does.
"""

from __future__ import annotations

import ctypes

import torch

from dy4tpu_torch.ops import fir
from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p]


def block_fir_decim_plain(x: Tensor, h: Tensor, state: Tensor,
                          decim: int) -> tuple[Tensor, Tensor]:
    """The plain version: ``fir.block_fir_decim``'s conv1d, any device."""
    return fir.block_fir_decim(x, h, state, decim, impl="plain")


def block_fir_decim(x: Tensor, h: Tensor, state: Tensor,
                    decim: int) -> tuple[Tensor, Tensor]:
    """B14 for CUDA tensors, ``block_fir_decim_plain`` for CPU ones; any
    leading batch dims on ``x`` and ``state`` (flattened to rows for the
    kernel).  Returns ``(y, new_state)``, both contiguous on the card."""
    if x.device.type == "cpu":
        return block_fir_decim_plain(x, h, state, decim)
    k = h.shape[0]
    n = x.shape[-1]
    batch = x.shape[:-1]
    if state.shape != (*batch, k - 1):
        raise ValueError(f"state: expected shape {(*batch, k - 1)}, got "
                         f"{tuple(state.shape)}")
    if n % decim:
        raise ValueError(f"block length {n} not divisible by {decim}")
    if n < k - 1:
        raise ValueError(f"block length {n} shorter than carried state "
                         f"{k - 1}; use a larger block")
    dev = x.device
    kernels.require(x, "x", x.shape, device=dev)
    kernels.require(h, "h", (k,), device=dev)
    kernels.require(state, "state", state.shape, device=dev)
    kernels.check_smem("fir", "dy4_fir_decim_smem", "block_fir_decim", decim,
                       k)
    rows = x.numel() // n
    y = torch.empty((*batch, n // decim), dtype=torch.float32, device=dev)
    new_state = torch.empty_like(state)
    fn = kernels.entry("fir", "dy4_fir_decim", _ARGS)
    with torch.cuda.device(dev):
        status = fn(x.data_ptr(), h.data_ptr(), state.data_ptr(),
                    y.data_ptr(), new_state.data_ptr(), rows, n, decim, k,
                    kernels.stream_of(x))
    kernels.check_launch(status, "fir block_fir_decim")
    block_fir_decim.launches += 1
    return y, new_state


block_fir_decim.launches = 0

"""The wideband channelizer's polyphase branch FIRs: the CUDA kernel B7
(``csrc/channelizer.cu``) and its plain torch version.

Replaces the Pallas kernel of ``dy4tpu/ops/channelizer.py ::
channelize_block_u8``: raw interleaved u8 -> normalize onto the carried
tail -> C branch FIRs of T taps, giving ``w [bands, M, 2C]`` with the I/Q
pair axis riding through (column ``2r' + leg`` holds branch ``C-1-r'``).
The length-C DFT across the branches is not the kernel's business: the
caller contracts ``w`` with the widened ``[C, 2C]`` DFT matrices
(``channelizer.channelize_block_u8``).

``channelize_branches`` takes CUDA tensors only and raises on any other:
the choice of route is ``channelize_block_u8``'s (``impl="auto"``: this
kernel for a CUDA tensor, the plain route for a CPU one).
"""

from __future__ import annotations

import ctypes

import torch

from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def branch_fir_interleaved(p: Tensor, tail_i: Tensor, tail_q: Tensor,
                           x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The branch FIRs over interleaved float32 IQ, the math of dy4tpu's
    ``channelize_block_interleaved`` before its DFT.

    ``p`` [C, T] (``p[r, q] = h[qC + r]``); ``tail_i``/``tail_q``
    [..., C*T-1] planar; ``x`` [..., 2 n_w] normalized, I even / Q odd,
    ``C | n_w``.  Returns ``(w [..., n_w/C, 2C], tail_i, tail_q)``, the new
    tails being the last C*T-1 complex samples of ``[tail || x]``."""
    c, t = p.shape
    k = c * t
    n2 = x.shape[-1]
    if n2 % (2 * c):
        raise ValueError(f"{n2} interleaved samples are not a multiple of "
                         f"2C = {2 * c}")
    m = n2 // (2 * c)
    tail = torch.stack([tail_i, tail_q], dim=-1)
    tail = tail.reshape(*tail.shape[:-2], 2 * (k - 1))
    ext = torch.cat([tail, x], dim=-1)                  # [..., 2(n_w+K-1)]
    seg = ext[..., : (m + t - 1) * 2 * c]
    seg = seg.reshape(*seg.shape[:-1], m + t - 1, 2 * c)
    # column j = 2r' + leg holds branch r = C-1-r': tap vector p[C-1-r', :]
    pcol = torch.repeat_interleave(p.flip(0), 2, dim=0)  # [2C, T]
    w = torch.zeros((*seg.shape[:-2], m, 2 * c), dtype=seg.dtype,
                    device=seg.device)
    for q in range(t):                                   # T multiply-adds
        w = w + pcol[:, q] * seg[..., t - 1 - q: t - 1 - q + m, :]
    new_tail = ext[..., -2 * (k - 1):]
    new_tail = new_tail.reshape(*new_tail.shape[:-1], k - 1, 2)
    return w, new_tail[..., 0], new_tail[..., 1]


def channelize_branches_plain(x_u8: Tensor, p: Tensor, tail_i: Tensor,
                              tail_q: Tensor
                              ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain torch version of ``channelize_branches`` (any leading batch
    dims, any device): ``(x - 128) / 128``, then
    ``branch_fir_interleaved``."""
    x = (x_u8.to(torch.float32) - 128.0) / 128.0
    return branch_fir_interleaved(p, tail_i, tail_q, x)


def channelize_branches(x_u8: Tensor, p: Tensor, tail_i: Tensor,
                        tail_q: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The branch FIRs of one wideband block through the kernel.

    ``x_u8`` [bands, 2 n_w] uint8 with ``C | n_w`` and ``n_w >= C``;
    ``p`` [C, T]; ``tail_i``/``tail_q`` [bands, C*T-1] float32, all
    contiguous CUDA tensors on one device.  Returns ``(w [bands, n_w/C,
    2C], tail_i, tail_q)`` as ``channelize_branches_plain`` does.  Raises
    on a tensor that is not on a CUDA device, on a geometry the kernel
    does not take, and when a thread block would need more shared memory
    than the card has.
    """
    if x_u8.dim() != 2 or p.dim() != 2:
        raise ValueError(f"expected x_u8 [bands, 2 n_w] and p [C, T], got "
                         f"{tuple(x_u8.shape)} and {tuple(p.shape)}")
    bands, n2 = x_u8.shape
    c, t = p.shape
    k = c * t
    if n2 % (2 * c) or n2 < 2 * c:
        raise ValueError(f"band rows of {n2} bytes: the kernel takes a "
                         f"positive multiple of 2C = {2 * c}")
    m = n2 // (2 * c)
    dev = x_u8.device
    kernels.require(x_u8, "x_u8", (bands, n2), torch.uint8, dev)
    kernels.require(p, "p", (c, t), device=dev)
    kernels.require(tail_i, "tail_i", (bands, k - 1), device=dev)
    kernels.require(tail_q, "tail_q", (bands, k - 1), device=dev)
    kernels.check_smem("channelizer", "dy4_channelizer_smem",
                       "channelize_branches", m, c, t)
    w = torch.empty(bands, m, 2 * c, dtype=torch.float32, device=dev)
    new_i = torch.empty(bands, k - 1, dtype=torch.float32, device=dev)
    new_q = torch.empty_like(new_i)
    fn = kernels.entry("channelizer", "dy4_channelizer", _ARGS)
    with torch.cuda.device(dev):
        status = fn(x_u8.data_ptr(), p.data_ptr(), tail_i.data_ptr(),
                    tail_q.data_ptr(), w.data_ptr(), new_i.data_ptr(),
                    new_q.data_ptr(), bands, n2, c, t,
                    kernels.stream_of(x_u8))
    kernels.check_launch(status, "channelizer channelize_branches")
    channelize_branches.launches += 1
    return w, new_i, new_q


channelize_branches.launches = 0

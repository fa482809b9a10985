"""Stateful block FIR filtering, decimation and rational resampling in
plain PyTorch: the counterpart of ``dy4tpu/ops/fir.py``.

The overlap-save recurrence is one 1-D convolution per call,

    y = conv(concat(state, x) zero-stuffed by U, flip(h), stride=D),

and the carried ``state`` is the last ``S`` *input* samples:

  * plain / decimating FIR: ``S = num_taps - 1``
  * polyphase resampler:   ``S = (num_taps - 1) // U``

All ops accept arbitrary leading batch dimensions on ``x``/``state``.
These are the plain versions the CUDA kernels are held against; the
kernels themselves live in the ``*_cuda`` modules (``block_fir_decim(...,
impl="kernel")`` reaches B14 in ``fir_cuda``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_IMPLS = ("auto", "plain", "kernel")


def state_len(num_taps: int, up: int = 1) -> int:
    """Carried-state length for a (resampling) block FIR."""
    return (num_taps - 1) // up


def init_state(num_taps: int, up: int = 1, batch: tuple[int, ...] = (),
               dtype=torch.float32, device="cuda") -> Tensor:
    """Zero carried state [*batch, S] on ``device`` (the card unless the
    caller asks for the CPU)."""
    return torch.zeros((*batch, state_len(num_taps, up)), dtype=dtype,
                       device=device)


def _no_tf32(x: Tensor) -> None:
    """Keep plain float32 work in float32 on the card.  A float32 conv1d
    goes through cuDNN in TF32 by default, and TF32 keeps only about three
    decimal digits; the receiver is float32 throughout (dy4tpu's
    ``precision=HIGHEST``), so both TF32 switches are turned off wherever
    a plain version runs on a CUDA tensor."""
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _conv1d(x: Tensor, h: Tensor, *, up: int, down: int, pad_lo: int,
            pad_hi: int, groups: int = 1) -> Tensor:
    """``x`` [B, G, N] (zero-stuffed by ``up``, padded ``pad_lo``/
    ``pad_hi``) correlated with flipped ``h`` [G, K] at stride ``down``,
    one filter per group -> [B, G, M]."""
    _no_tf32(x)
    if up > 1:
        b, g, n = x.shape
        z = x.new_zeros(b, g, (n - 1) * up + 1)
        z[..., ::up] = x
        x = z
    x = F.pad(x, (pad_lo, pad_hi))
    w = torch.flip(h, [-1]).reshape(groups, 1, h.shape[-1])
    return F.conv1d(x, w, stride=down, groups=groups)


def convolve_full(x: Tensor, h: Tensor) -> Tensor:
    """Single-pass linear convolution, output length N+K-1: the
    reference's validation path ``convolveFIR`` (src/filter.cpp:53-64).
    ``x`` [..., N], ``h`` [K]; float32 with TF32 off, as dy4tpu computes
    it at ``precision=HIGHEST``."""
    k = h.shape[0]
    n = x.shape[-1]
    y = _conv1d(x.reshape(-1, 1, n), h[None], up=1, down=1, pad_lo=k - 1,
                pad_hi=k - 1)
    return y.reshape(*x.shape[:-1], n + k - 1)


def block_fir_resample(x: Tensor, h: Tensor, state: Tensor, *,
                       up: int = 1, down: int = 1) -> tuple[Tensor, Tensor]:
    """Stateful polyphase FIR: upsample by ``up``, filter, keep every
    ``down``-th output.  Returns ``(y, new_state)``.

    ``x``: [..., N] with N*up divisible by down; ``state``: [..., S] where
    ``S = (len(h)-1)//up``.  Semantics match src/filter.cpp:142-173 with the
    state tail indexed in input-sample units.
    """
    k = h.shape[0]
    n = x.shape[-1]
    s = state.shape[-1]
    expected_s = state_len(k, up)
    if s != expected_s:
        raise ValueError(f"state length {s} != {expected_s} for K={k}, U={up}")
    if (n * up) % down != 0:
        raise ValueError(f"block length {n}*{up} not divisible by {down}")
    if n < expected_s:
        raise ValueError(f"block length {n} shorter than carried state "
                         f"{expected_s}; use a larger block")
    m = n * up // down
    batch = x.shape[:-1]
    x_ext = torch.cat([state, x], dim=-1)            # [..., S+N]
    # output m reads dilated window [S*up + m*down - (K-1), S*up + m*down]
    pad_lo = (k - 1) - s * up                        # in [0, up-1]
    dilated_len = (s + n - 1) * up + 1
    pad_hi = max(0, (m - 1) * down + k - pad_lo - dilated_len)
    y = _conv1d(x_ext.reshape(-1, 1, s + n), h[None], up=up, down=down,
                pad_lo=pad_lo, pad_hi=pad_hi)
    y = y.reshape(*batch, -1)[..., :m]
    new_state = x[..., n - expected_s:] if expected_s else state
    return y, new_state


def block_fir(x: Tensor, h: Tensor, state: Tensor) -> tuple[Tensor, Tensor]:
    """Same-length stateful FIR (overlap-save), src/filter.cpp:66-83."""
    return block_fir_resample(x, h, state)


def block_fir_decim(x: Tensor, h: Tensor, state: Tensor, decim: int, *,
                    impl: str = "auto") -> tuple[Tensor, Tensor]:
    """Decimating stateful FIR computing only kept outputs,
    src/filter.cpp:123-140.

    ``impl``: "auto" and "plain" run the plain conv1d on any device
    (dy4tpu's ``auto`` never picks its kernel either); "kernel" runs B14
    (``fir_cuda.block_fir_decim``), which takes CUDA tensors only: a CPU
    tensor raises."""
    if impl not in _IMPLS:
        raise ValueError(f"impl={impl!r}: expected one of {_IMPLS}")
    if impl == "kernel":
        if not x.is_cuda:
            raise ValueError(f"impl='kernel' needs a CUDA tensor, got "
                             f"{x.device}")
        from dy4tpu_torch.ops import fir_cuda  # it imports this module
        return fir_cuda.block_fir_decim(x, h, state, decim)
    return block_fir_resample(x, h, state, down=decim)


def block_fir_bank(x: Tensor, hs: Tensor, states: Tensor
                   ) -> tuple[Tensor, Tensor]:
    """Apply a bank of F same-length FIR filters to one input in one
    grouped convolution.

    ``hs``: [F, K]; ``states``: either [..., K-1] (ONE shared history —
    the filters all read the same stream, so its last K-1 samples serve
    every row; this is what ``ReceiverState`` carries) or [..., F, K-1]
    (independent per-filter histories).  Returns ``y: [..., F, N]`` and
    new states in the same form.
    """
    f, k = hs.shape
    n = x.shape[-1]
    batch = x.shape[:-1]
    s = k - 1
    shared = states.dim() == x.dim()         # [..., K-1]: one history
    if shared:
        states = states[..., None, :].expand(*batch, f, s)
    x_b = x[..., None, :].expand(*batch, f, n)
    x_ext = torch.cat([states, x_b], dim=-1)           # [..., F, S+N]
    y = _conv1d(x_ext.reshape(-1, f, s + n), hs, up=1, down=1, pad_lo=0,
                pad_hi=0, groups=f)
    y = y.reshape(*batch, f, n)
    new_states = x[..., n - s:] if shared else x_b[..., n - s:]
    return y, new_states


def downsample(x: Tensor, factor: int) -> Tensor:
    """Take every ``factor``-th sample (src/filter.cpp:104-110)."""
    return x[..., ::factor]


def upsample(x: Tensor, factor: int) -> Tensor:
    """Zero-stuff: each sample followed by ``factor-1`` zeros
    (src/filter.cpp:112-121)."""
    out = x.new_zeros(*x.shape, factor)
    out[..., 0] = x
    return out.reshape(*x.shape[:-1], x.shape[-1] * factor)

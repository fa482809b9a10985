"""Polyphase DFT filter bank: one wideband capture -> C station channels.
The counterpart of ``dy4tpu/ops/channelizer.py``.

A complex stream at ``fs_w = C * f_if`` becomes C critically-sampled
channels at ``f_if``, centred on the carriers ``+c * fs_w / C`` (standard
DFT filter bank; h = prototype LPF, K = C*T taps):

    y_c[m] = sum_{r<C} e^{+j 2pi c r / C} * w_r[m],
      w_r[m] = sum_{q<T} h[qC + r] x[(m-q)C - r]

i.e. C polyphase branch FIRs of T taps, then a length-C DFT across the
branch index per output step.  The channel axis lands on the receiver's
batch axis (``pipeline/wideband.py``).

``channelize_block_u8`` takes the raw interleaved u8 capture by one of two
routes:

  * the plain route (``impl="plain"``, and ``"auto"`` on a CPU tensor):
    B7's plain version (normalize, the branch FIRs), the DFT, then the
    post-bank IQ correction ``iqcorr.apply_channelized`` when ``corr`` is
    given;
  * the kernel route (``"auto"`` on a CUDA tensor): the branch FIRs through
    the hand-written kernel B7 (``ops/channelizer_cuda.py``), then the DFT
    as a float32 matmul with the widened matrices of
    ``_dft_mats_corrected``, the IQ correction folded into them.

``precision`` (``ops/precision.py``): at "highest" (the default, dy4tpu's
HIGHEST) everything is float32.  Below it the branch taps are rounded to
bf16 on both routes (dy4tpu's kernel rounds them), and the DFT takes
dy4tpu's einsum precision as the TPU computes it (``_matmul``): at
"default" bf16 operands, at "high" bf16_3x, the products summed in
float32.  The matmuls assume TF32 is off, PyTorch's default for float32
matmuls.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from dy4tpu_torch.ops import channelizer_cuda, firdes, iqcorr
from dy4tpu_torch.ops.precision import bf16, rounds

Tensor = torch.Tensor

_IMPLS = ("auto", "plain")


class ChannelizerParams(NamedTuple):
    """Static design: prototype taps + derived branch/DFT matrices."""
    h: Tensor         # [K] prototype LPF (K = C*T)
    p: Tensor         # [C, T] polyphase branches: p[r, q] = h[qC + r]
    e_r: Tensor       # [C, C] DFT real part,  E[c, r] = cos(2pi c r / C)
    e_i: Tensor       # [C, C] DFT imag part,  E[c, r] = sin(2pi c r / C)

    @property
    def channels(self) -> int:
        return self.p.shape[0]

    @property
    def taps_per_branch(self) -> int:
        return self.p.shape[1]


class ChannelizerState(NamedTuple):
    """Carried wideband tail (last K-1 complex input samples, planar)."""
    tail_i: Tensor    # [..., K-1]
    tail_q: Tensor    # [..., K-1]


def make_channelizer(channels: int, f_if: float, *,
                     taps_per_branch: int = 12, fc: float | None = None,
                     device="cuda") -> ChannelizerParams:
    """Design a C-channel critically-sampled bank for ``fs_w = C*f_if``
    (host-side numpy, as dy4tpu does) and put it on ``device`` (the card
    unless the caller asks for the CPU).

    ``fc``: prototype cutoff (default ``0.42 * f_if``)."""
    c, t = channels, taps_per_branch
    fs_w = c * f_if
    if fc is None:
        fc = 0.42 * f_if
    h = firdes.lpf(fs_w, fc, c * t)
    p = h.reshape(t, c).T                             # p[r, q] = h[qC+r]
    grid = 2.0 * np.pi * np.outer(np.arange(c), np.arange(c)) / c
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, np.float32), device=device)
    return ChannelizerParams(h=f32(h), p=f32(p), e_r=f32(np.cos(grid)),
                             e_i=f32(np.sin(grid)))


def init_channelizer_state(params: ChannelizerParams,
                           batch: tuple[int, ...] = (),
                           dtype=torch.float32) -> ChannelizerState:
    """Zero tails [*batch, K-1] on the params' device."""
    k = params.h.shape[0]
    z = lambda: torch.zeros((*batch, k - 1), dtype=dtype,  # noqa: E731
                            device=params.h.device)
    return ChannelizerState(tail_i=z(), tail_q=z())


def channelize_block(params: ChannelizerParams, state: ChannelizerState,
                     x_i: Tensor, x_q: Tensor, *, precision: str = "highest"
                     ) -> tuple[tuple[Tensor, Tensor], ChannelizerState]:
    """One block of planar wideband complex baseband -> C channel blocks.

    ``x_i``/``x_q``: [..., n_w] with ``C | n_w``.  Returns ``((y_i, y_q),
    new_state)`` with y_* shaped [..., C, n_w // C]: channel c is the band
    around carrier ``+c * fs_w / C`` (negative offsets alias to ``C - c``),
    downconverted and decimated to f_if.  ``precision``: the DFT's, as
    dy4tpu's einsum takes it (``_matmul``)."""
    c, t = params.channels, params.taps_per_branch
    k = c * t
    n_w = x_i.shape[-1]
    if n_w % c:
        raise ValueError(f"block of {n_w} samples is not a multiple of "
                         f"C = {c}")
    m = n_w // c

    def branches(x, tail):
        ext = torch.cat([tail, x], dim=-1)              # [..., n_w+K-1]
        seg = ext[..., : (m + t - 1) * c]
        seg = seg.reshape(*seg.shape[:-1], m + t - 1, c)
        # u[r, mm] = ext[mm*C + C-1 - r]
        u = seg.flip(-1).transpose(-1, -2)              # [..., C, M+T-1]
        w = torch.zeros((*u.shape[:-1], m), dtype=u.dtype, device=u.device)
        for q in range(t):                              # T multiply-adds
            w = w + params.p[:, q, None] * u[..., t - 1 - q: t - 1 - q + m]
        return w, ext[..., -(k - 1):]

    w_i, tail_i = branches(x_i, state.tail_i)
    w_q, tail_q = branches(x_q, state.tail_q)

    # complex DFT across branches: y = E @ w, E = exp(+j 2pi c r / C)
    mm = lambda a, b: _matmul(a, b, precision)  # noqa: E731
    y_i = mm(params.e_r, w_i) - mm(params.e_i, w_q)
    y_q = mm(params.e_r, w_q) + mm(params.e_i, w_i)
    return (y_i, y_q), ChannelizerState(tail_i=tail_i, tail_q=tail_q)


def dc_response(params: ChannelizerParams) -> tuple[Tensor, Tensor]:
    """The bank's response to a constant complex input 1 + 0j, per
    channel: ``g[c] = sum_r e^{+j 2pi c r / C} sum_q p[r, q]`` (steady
    state).  A wideband tuner's DC offset lands in the channels through
    this vector.  Returns planar ``(g_r [C], g_i [C])``."""
    br = torch.sum(params.p, dim=1)                     # [C] branch sums
    return params.e_r @ br, params.e_i @ br


def _matmul(a: Tensor, b: Tensor, precision: str = "highest") -> Tensor:
    """``a @ b`` as a TPU's matrix unit computes it at dy4tpu's
    ``precision``: float32 at "highest"; at "default" both operands
    rounded to bf16 (their products are exact in float32), summed in
    float32; at "high" bf16_3x, ``hi_a hi_b + hi_a lo_b + lo_a hi_b`` with
    ``hi = bf16(x)``, ``lo = bf16(x - hi)``."""
    if not rounds(precision):
        return torch.matmul(a, b)
    a_hi, b_hi = bf16(a), bf16(b)
    y = torch.matmul(a_hi, b_hi)
    if precision == "high":
        y = y + (torch.matmul(a_hi, bf16(b - b_hi))
                 + torch.matmul(bf16(a - a_hi), b_hi))
    return y


def _dft(g: Tensor, w: Tensor, precision: str = "highest") -> Tensor:
    """``einsum("...cj,...mj->...cm", g, w)`` at ``precision``:
    [..., C, M]."""
    return _matmul(g, w.transpose(-1, -2), precision)


def channelize_block_interleaved(params: ChannelizerParams,
                                 state: ChannelizerState, x: Tensor, *,
                                 precision: str = "highest"
                                 ) -> tuple[tuple[Tensor, Tensor],
                                            ChannelizerState]:
    """``channelize_block`` consuming interleaved float32 IQ, with no
    deinterleave: the I/Q pair axis rides through the branch FIR (taps
    are per branch, so each interleaved column repeats its branch's tap)
    and the DFT contracts over the widened 2C branch-pair axis,
    ``y[c] = sum_{r'} E[c, C-1-r'] (w[2r'] + j w[2r'+1])``.

    ``x``: [..., 2*n_w] normalized float32, I even / Q odd.
    ``precision``: the DFT's (``_matmul``), as dy4tpu's."""
    w, tail_i, tail_q = channelizer_cuda.branch_fir_interleaved(
        params.p, state.tail_i, state.tail_q, x)
    return (_dft_plain(params, w, precision),
            ChannelizerState(tail_i=tail_i, tail_q=tail_q))


def _dft_plain(params: ChannelizerParams, w: Tensor, precision: str
               ) -> tuple[Tensor, Tensor]:
    """The DFT of branch outputs ``w`` [..., M, 2C] with the widened
    matrices, no correction folded in."""
    g_i, g_q, _, _ = _dft_mats_corrected(params, None)
    return _dft(g_i, w, precision), _dft(g_q, w, precision)


def _dft_mats_corrected(params: ChannelizerParams, corr):
    """Widened-G DFT matrices with the pre-bank IQ correction folded in.

    The correction is the R-linear map ``z' = alpha z + beta conj(z) -
    kappa`` (``iqcorr.channel_affine``); pushed through the bank it
    becomes a complex reweighting of the DFT matrix,

        y'_c = sum_r E[c,r] [(1 - j s rho) w_i + j s w_q] - kappa g_c,

    i.e. two rebuilt [.., C, 2C] matrices per step plus the per-channel
    constant ``kappa * g_dc`` subtracted after the matmul.  ``corr`` may
    carry leading batch dims (per-band tuners).  Returns ``(g_i, g_q,
    kg_r, kg_i)``, the last two None without ``corr``.
    """
    c = params.channels
    e2_r = params.e_r.flip(-1)
    e2_i = params.e_i.flip(-1)

    def widen(a, b):                                 # [.., C, C] x2 -> 2C
        g = torch.stack([a, b], dim=-1)
        return g.reshape(*g.shape[:-3], c, 2 * c)

    if corr is None:
        return (widen(e2_r, -e2_i), widen(e2_i, e2_r), None, None)
    s = corr.s[..., None, None]
    sr = (corr.s * corr.rho)[..., None, None]
    g_i = widen(torch.broadcast_to(e2_r, sr.shape[:-2] + e2_r.shape)
                + sr * e2_i, -s * e2_i)
    g_q = widen(torch.broadcast_to(e2_i, sr.shape[:-2] + e2_i.shape)
                - sr * e2_r, s * e2_r)
    k_r = corr.dc_i
    k_i = corr.s * (corr.dc_q - corr.dc_i * corr.rho)
    gd_r, gd_i = dc_response(params)
    kg_r = k_r[..., None] * gd_r - k_i[..., None] * gd_i
    kg_i = k_r[..., None] * gd_i + k_i[..., None] * gd_r
    return g_i, g_q, kg_r, kg_i


def channelize_u8_folded(params: ChannelizerParams, state: ChannelizerState,
                         x_u8: Tensor, corr=None,
                         branches: Optional[Callable] = None,
                         precision: str = "highest"
                         ) -> tuple[tuple[Tensor, Tensor], ChannelizerState]:
    """The kernel route of ``channelize_block_u8``: ``branches`` (default
    the kernel, ``channelizer_cuda.channelize_branches``) over the band
    rows, then the DFT with the correction folded into its matrices, both
    at ``precision``.  ``branches=channelizer_cuda.channelize_branches_
    plain`` runs the same route on any device."""
    branches = branches or channelizer_cuda.channelize_branches
    c = params.channels
    batch = x_u8.shape[:-1]
    k1 = params.h.shape[0] - 1
    flat = lambda a: a.reshape(-1, a.shape[-1]).contiguous()  # noqa: E731
    w, tail_i, tail_q = branches(flat(x_u8), params.p, flat(state.tail_i),
                                 flat(state.tail_q), precision=precision)
    w = w.reshape(*batch, -1, 2 * c)
    g_i, g_q, kg_r, kg_i = _dft_mats_corrected(params, corr)
    y_i, y_q = _dft(g_i, w, precision), _dft(g_q, w, precision)
    if kg_r is not None:
        y_i = y_i - kg_r[..., :, None]
        y_q = y_q - kg_i[..., :, None]
    return ((y_i, y_q),
            ChannelizerState(tail_i=tail_i.reshape(*batch, k1),
                             tail_q=tail_q.reshape(*batch, k1)))


def channelize_block_u8(params: ChannelizerParams, state: ChannelizerState,
                        x_u8: Tensor, *, impl: str = "auto", corr=None,
                        precision: str = "highest"
                        ) -> tuple[tuple[Tensor, Tensor], ChannelizerState]:
    """``channelize_block_interleaved`` consuming the raw u8 block.

    ``x_u8``: [..., 2*n_w] interleaved u8 (I even, Q odd).  Returns the
    same ``((y_i, y_q) [..., C, M], state)`` as the float32 entry points.
    ``impl``: "auto" (the kernel route for a CUDA tensor, which runs B7 or
    raises, and the plain route for a CPU one) or "plain" (the plain
    route on any device).  ``corr``: optional ``iqcorr.IQCorrCoeffs``
    (leading dims = the band axes), the pre-bank tuner-fault correction.
    ``precision``: "highest" (default), "high" or "default" (the module
    docstring says what it rounds).
    """
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "auto" and x_u8.device.type != "cpu":
        return channelize_u8_folded(params, state, x_u8, corr,
                                    precision=precision)
    w, tail_i, tail_q = channelizer_cuda.channelize_branches_plain(
        x_u8, params.p, state.tail_i, state.tail_q, precision)
    y = _dft_plain(params, w, precision)
    if corr is not None:
        y = iqcorr.apply_channelized(y[0], y[1], corr, *dc_response(params))
    return y, ChannelizerState(tail_i=tail_i, tail_q=tail_q)


def rssi_dbfs(y_i: Tensor, y_q: Tensor) -> Tensor:
    """Per-channel received signal strength, dB full-scale.

    ``y_i``/``y_q``: [..., C, M] channelizer output for one block.
    Returns [..., C].  An FM carrier reads near 20*log10(amplitude); an
    empty channel reads the noise floor."""
    p = torch.mean(y_i * y_i + y_q * y_q, dim=-1)
    return 10.0 * torch.log10(torch.clamp(p, min=1e-12))

"""Blind I/Q impairment correction: the counterpart of
``dy4tpu/ops/iqcorr.py``, narrowband and wideband.

The tuner model is

    i_obs = i + d_i
    q_obs = g * (q*cos(phi) + i*sin(phi)) + d_q

The narrowband tracker (the receiver's own, ``ReceiverState.iqcorr``) fits
an ellipse: an FM carrier has constant modulus, so its clean samples lie on
a circle, and the impairment is an affine map that turns the circle into
an ellipse whose center is the DC offset and whose shape is the
imbalance.  ``coeffs`` solves the conic normal equations (a batched,
unrolled 5x5 Cholesky solve over the EMA'd moments) and reads the
correction out; ``apply`` applies it; ``estimate`` folds one block in.

A faulted wideband tuner images channel c into the mirrored channel
(-c mod C).  The wideband tracker keeps EMA'd raw moments E[i^p q^r]
(order <= 4, ``_POWERS`` order) of a contiguous prefix window of the raw
u8 stream (``wideband_moments``), reads them out with the second-order
Gaussian estimator (``coeffs_gaussian``: the multi-station sum is
near-circular Gaussian), and the correction is the R-linear map of
``channel_affine``, applied after the bank (``apply_channelized``) or
folded into its DFT matrices (``channelizer._dft_mats_corrected``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

# moment index layout of IQCorrState.m: E[i^p * q^r] at _POWERS[k]
_POWERS = ((4, 0), (3, 1), (2, 2), (1, 3), (0, 4),
           (3, 0), (2, 1), (1, 2), (0, 3),
           (2, 0), (1, 1), (0, 2), (1, 0), (0, 1))
_IDX = {pq: k for k, pq in enumerate(_POWERS)}


class IQCorrState(NamedTuple):
    """EMA'd raw moments E[i^p q^r] (order <= 4) of the observed stream,
    batch-shaped with a trailing [14] moment axis, plus a block count
    (gates the cold-start identity)."""
    m: Tensor       # [..., 14] float32
    count: Tensor   # [...] int32 blocks folded in


class IQCorrCoeffs(NamedTuple):
    """Correction ``i_c = i - dc_i; q_c = (q - dc_q - rho*i_c) * s``."""
    dc_i: Tensor
    dc_q: Tensor
    rho: Tensor
    s: Tensor


def init_iqcorr_state(batch: tuple[int, ...] = (), dtype=torch.float32,
                      device="cpu") -> IQCorrState:
    return IQCorrState(
        m=torch.zeros((*batch, len(_POWERS)), dtype=dtype, device=device),
        count=torch.zeros(batch, dtype=torch.int32, device=device))


def moments(i: Tensor, q: Tensor) -> Tensor:
    """The 14 conic-fit moments E[i^p q^r] of one block ([..., N] ->
    [..., 14], ``_POWERS`` order)."""
    i = i.to(torch.float32)
    q = q.to(torch.float32)
    return torch.stack(
        [torch.mean(i ** p * q ** r if r else i ** p, dim=-1)
         if p else torch.mean(q ** r, dim=-1)
         for p, r in _POWERS], dim=-1)


def fold(state: IQCorrState, mom: Tensor, *,
         alpha: float = 0.2) -> IQCorrState:
    """EMA one block's moments ([..., 14]) into the tracker state."""
    a = float(np.float32(alpha))
    return IQCorrState(m=state.m * float(np.float32(1.0 - a)) + a * mom,
                       count=state.count + 1)


def estimate(i: Tensor, q: Tensor, state: IQCorrState, *,
             alpha: float = 0.2) -> IQCorrState:
    """Fold one block of observed I/Q ([..., N]) into the moments."""
    return fold(state, moments(i, q), alpha=alpha)


def coeffs(state: IQCorrState, *, min_power: float = 1e-6,
           deadband_dc: float = 0.005, deadband: float = 0.02
           ) -> IQCorrCoeffs:
    """Correction coefficients from the accumulated moments: solve the
    conic normal equations for ``a x^2 + b xy + c y^2 + d x + e y = 1``
    (batched 5x5), then read the center and the shape:

        center:  [[2a, b], [b, 2c]] @ p0 = [-d, -e]
        rho = -b / (2c)             (= g sin(phi))
        s   = 1 / sqrt(a/c - rho^2) (= 1 / (g cos(phi)))

    The solve is an unrolled Cholesky in elementwise torch ops, in
    dy4tpu's op order, so that the deadband decisions follow dy4tpu's.
    Identity (dc=0, rho=0, s=1) until a block is folded in, under
    ``min_power``, or when the fit is not an ellipse or not finite; each
    component within its deadband of the identity snaps to it exactly,
    so a healthy tuner decodes bit-identically with the tracker on."""
    m = state.m
    g = lambda p, r: m[..., _IDX[(p, r)]]  # noqa: E731

    # normal equations for v = (x^2, xy, y^2, x, y), target 1:
    # E[v v^T] beta = E[v]; the EMA warm-up scale cancels here
    rows = [
        [g(4, 0), g(3, 1), g(2, 2), g(3, 0), g(2, 1)],
        [g(3, 1), g(2, 2), g(1, 3), g(2, 1), g(1, 2)],
        [g(2, 2), g(1, 3), g(0, 4), g(1, 2), g(0, 3)],
        [g(3, 0), g(2, 1), g(1, 2), g(2, 0), g(1, 1)],
        [g(2, 1), g(1, 2), g(0, 3), g(1, 1), g(0, 2)],
    ]
    h = [g(2, 0), g(1, 1), g(0, 2), g(1, 0), g(0, 1)]

    power = g(2, 0) - g(1, 0) ** 2
    ok = (state.count > 0) & (power > min_power)

    L = [[None] * 5 for _ in range(5)]
    for i in range(5):
        for j in range(i + 1):
            v = rows[i][j]
            for k in range(j):
                v = v - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(v, min=1e-20))
            else:
                L[i][j] = v / L[j][j]
    y = [None] * 5
    for i in range(5):
        v = h[i]
        for k in range(i):
            v = v - L[i][k] * y[k]
        y[i] = v / L[i][i]
    beta = [None] * 5
    for i in reversed(range(5)):
        v = y[i]
        for k in range(i + 1, 5):
            v = v - L[k][i] * beta[k]
        beta[i] = v / L[i][i]
    a, b, c, d, e = beta

    one = torch.ones_like(a)
    det2 = 4.0 * a * c - b * b
    safe = torch.where(torch.abs(det2) > 1e-20, det2, one)
    x0 = (-2.0 * c * d + b * e) / safe
    y0 = (-2.0 * a * e + b * d) / safe
    c_safe = torch.where(torch.abs(c) > 1e-20, c, one)
    rho = -b / (2.0 * c_safe)
    w22sq = a / c_safe - rho * rho
    s = 1.0 / torch.sqrt(torch.clamp(w22sq, min=1e-12))

    # trustworthy only when it is an ellipse and everything is finite
    fin = (torch.isfinite(x0) & torch.isfinite(y0) & torch.isfinite(rho)
           & torch.isfinite(s))
    ok = ok & fin & (a > 0.0) & (c > 0.0) & (det2 > 0.0) & (w22sq > 1e-6)

    zero = torch.zeros_like(rho)
    gate = lambda v, off, t: torch.where(          # noqa: E731
        torch.abs(v - off) > t, v, torch.full_like(v, off))
    return IQCorrCoeffs(
        dc_i=gate(torch.where(ok, x0, zero), 0.0, deadband_dc),
        dc_q=gate(torch.where(ok, y0, zero), 0.0, deadband_dc),
        rho=gate(torch.where(ok, rho, zero), 0.0, deadband),
        s=gate(torch.where(ok, s, one), 1.0, deadband))


def apply(i: Tensor, q: Tensor, c: IQCorrCoeffs, *,
          dc_scale: float | Tensor = 1.0) -> tuple[Tensor, Tensor]:
    """Apply the correction to an I/Q block ([..., N]; coeffs batch-
    shaped).  ``dc_scale``: DC gain between the estimation point and the
    application point (the 2x2 part commutes with any per-component LTI
    filter; only the offsets pick up the filter's DC gain)."""
    dci = (c.dc_i * dc_scale)[..., None]
    dcq = (c.dc_q * dc_scale)[..., None]
    i_c = i - dci
    q_c = (q - dcq - c.rho[..., None] * i_c) * c.s[..., None]
    return i_c, q_c


def coeffs_gaussian(state: IQCorrState, *, min_power: float = 1e-6,
                    deadband_dc: float = 0.005, deadband: float = 0.02
                    ) -> IQCorrCoeffs:
    """Second-order (Gaussian) readout of the accumulated moments, the
    wideband estimator:

        dc  = E[p],   C = cov(p) = [[v_i, c_iq], [c_iq, v_q]],
        rho = c_iq / v_i              (= g sin(phi))
        s   = 1 / sqrt(v_q/v_i - rho^2)   (= 1 / (g cos(phi)))

    Identity until a block is folded, under ``min_power``, or on a
    degenerate readout; each component within its deadband of the
    identity snaps to it exactly."""
    m = state.m
    g = lambda p, r: m[..., _IDX[(p, r)]]  # noqa: E731
    dc_i = g(1, 0)
    dc_q = g(0, 1)
    v_i = g(2, 0) - dc_i * dc_i
    v_q = g(0, 2) - dc_q * dc_q
    c_iq = g(1, 1) - dc_i * dc_q
    ok = (state.count > 0) & (v_i > min_power)
    one = torch.ones_like(v_i)
    rho = c_iq / torch.where(v_i > min_power, v_i, one)
    w22sq = v_q / torch.where(v_i > min_power, v_i, one) - rho * rho
    s = 1.0 / torch.sqrt(torch.clamp(w22sq, min=1e-12))
    fin = (torch.isfinite(dc_i) & torch.isfinite(dc_q)
           & torch.isfinite(rho) & torch.isfinite(s))
    ok = ok & fin & (w22sq > 1e-6)
    zero = torch.zeros_like(rho)
    gate = lambda v, off, t: torch.where(          # noqa: E731
        torch.abs(v - off) > t, v, torch.full_like(v, off))
    return IQCorrCoeffs(
        dc_i=gate(torch.where(ok, dc_i, zero), 0.0, deadband_dc),
        dc_q=gate(torch.where(ok, dc_q, zero), 0.0, deadband_dc),
        rho=gate(torch.where(ok, rho, zero), 0.0, deadband),
        s=gate(torch.where(ok, s, one), 1.0, deadband))


def channel_affine(c: IQCorrCoeffs):
    """The correction as an R-linear map on the complex stream, the form
    that commutes through a real-coefficient filter bank:

        z_c = alpha w + beta conj(w) - kappa,
        alpha = (1 + s - j s rho)/2,
        beta  = (1 - s - j s rho)/2,
        kappa = dc_i (1 - j s rho) + j s dc_q

    Returns planar ``(a_r, a_i, b_r, b_i, k_r, k_i)``, batch-shaped like
    the coeffs."""
    a_r = (1.0 + c.s) * 0.5
    b_r = (1.0 - c.s) * 0.5
    ab_i = -0.5 * c.s * c.rho
    k_r = c.dc_i
    k_i = c.s * (c.dc_q - c.dc_i * c.rho)
    return a_r, ab_i, b_r, ab_i, k_r, k_i


def apply_channelized(y_i: Tensor, y_q: Tensor, c: IQCorrCoeffs,
                      g_r: Tensor, g_i: Tensor) -> tuple[Tensor, Tensor]:
    """Apply the pre-bank correction in the channel domain:

        y'_c = alpha y_c + beta conj(y_{(-c) mod C}) - kappa g_dc[c]

    ``y_i``/``y_q``: [..., C, M] channelized streams; coeffs batch-shaped
    [...]; ``g_r``/``g_i``: [C] bank DC response (``channelizer.
    dc_response``).  Equals correcting the wideband stream before the
    bank (steady state)."""
    a_r0, a_i0, b_r0, b_i0, k_r0, k_i0 = channel_affine(c)
    a_r, a_i, b_r, b_i = (x[..., None, None]
                          for x in (a_r0, a_i0, b_r0, b_i0))
    kg_r = (k_r0[..., None] * g_r - k_i0[..., None] * g_i)[..., :, None]
    kg_i = (k_r0[..., None] * g_i + k_i0[..., None] * g_r)[..., :, None]
    n_c = y_i.shape[-2]
    mirror = torch.as_tensor((-np.arange(n_c)) % n_c, device=y_i.device)
    ym_i = torch.index_select(y_i, -2, mirror)
    ym_q = -torch.index_select(y_q, -2, mirror)      # conj
    out_i = a_r * y_i - a_i * y_q + b_r * ym_i - b_i * ym_q - kg_r
    out_q = a_r * y_q + a_i * y_i + b_r * ym_q + b_i * ym_i - kg_i
    return out_i, out_q


def wideband_moments(wb_u8: Tensor, n_est: int = 4096) -> Tensor:
    """Moments of the raw interleaved wideband u8 stream from a
    contiguous prefix window of ``n_est`` complex samples (a strided
    subsample would fold a channel's carrier line onto DC), for the
    ``coeffs_gaussian`` readout.  ``wb_u8``: [..., 2*n_w] -> [..., 14]."""
    w = wb_u8[..., :2 * n_est]
    pair = w.reshape(*w.shape[:-1], n_est, 2).to(torch.float32)
    i = (pair[..., 0] - 128.0) / 128.0
    q = (pair[..., 1] - 128.0) / 128.0
    return moments(i, q)


def image_rejection_db(gain: float, phase_deg: float) -> float:
    """IRR of the impairment model (test/diagnostic helper)."""
    e = gain * np.exp(1j * np.deg2rad(phase_deg))
    return float(10.0 * np.log10(np.abs(1 + e) ** 2 / np.abs(1 - e) ** 2))


def impair(i, q, *, dc_i: float = 0.0, dc_q: float = 0.0,
           gain: float = 1.0, phase_deg: float = 0.0):
    """Apply the impairment model (TX/test side; numpy arrays or
    tensors)."""
    phi = np.deg2rad(phase_deg)
    return (i + dc_i,
            gain * (q * np.cos(phi) + i * np.sin(phi)) + dc_q)

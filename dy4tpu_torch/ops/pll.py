"""Type-II software PLL + NCO: the counterpart of ``dy4tpu/ops/pll.py``
(the sign-detector path, the span PLL and ``pll_reference``, the
reference's literal per-sample loop).

Reference: ``fmPLL`` (src/filter.cpp:174-228) and the Python-model twin
with quadrature output (``fmPll`` model/fmMonoBlock.py:344-379).  Loop
constants Cp=2.666, Ci=3.555, Kp=bw*Cp, Ki=bw^2*Ci.

The phase detector ``atan2(-x*sin(phi), x*cos(phi))`` equals
``wrap(pi*[x < 0] - phi)``, so the input enters the recurrence only through
its sign, and the recurrence needs no transcendentals: a handful of adds
and multiplies per sample (``_make_step``).  The NCO cos/sin are applied
to the emitted phase sequence afterwards (``trig.nco_sincos``).  The
emitted block is the *pre-update* phase, so the NCO lags the input by one
sample, and the first NCO sample of a block is the carried one.

The carried phases wrap modulo 4*pi, which is exact for the NCO scales the
receiver uses (2.0 stereo, 0.5 RDS, 1.0) since scale*4*pi = 0 mod 2*pi.

``pll(impl=...)``: "plain" runs the recurrence as a torch loop over time,
"kernel" runs the CUDA kernel (``ops/pll_cuda.py``; CUDA tensors only),
"auto" takes the kernel for a CUDA tensor and the plain loop for a CPU
one.  Kernel and plain loop are bit-identical on the card.

``pll(span=K)`` with K > 1 is dy4tpu's decimated-feedback ("span") PLL, an
opt-in throughput mode that is not bit-exact against the per-sample loop:
one loop-filter update per K samples, driven by a span-averaged detector
target (``_span_targets``), with the within-span phases rebuilt
vectorized afterwards (``_span_expand``), so the serial chain is N/K steps
long.  ``pll(span_emit="kernel")`` has the scan emit those phases itself
(B9-expand, dy4tpu's ``DY4TPU_SPAN_EMIT=kernel``), bit for bit the same.
``span`` and ``span_emit`` are arguments: the library reads no environment
variable.

``encode_sign`` and ``phase_scan_coded`` are the coded replay of the exact
time-sharded receiver (``parallel/sharded.py``): the input enters the
recurrence only through its sign, so an int8 code stream stands in for the
float32 samples, and the replay from codes is bit-identical to ``pll``'s
scan over the samples they encode.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dy4tpu_torch.ops import trig

Tensor = torch.Tensor

_CP = 2.666
_CI = 3.555
_WRAP = 4.0 * np.pi  # exact modulus for ncoScale in {0.5, 1, 2}

# the step's constants as float32 values (python floats holding exact
# float32 values, so a float32 tensor op with them rounds as dy4tpu's
# dtype.type(...) constants do); the CUDA kernel receives the same ones
PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0 * np.pi))
INV_TWO_PI = float(np.float32(1.0 / (2.0 * np.pi)))
WRAP = float(np.float32(_WRAP))


class PLLState(NamedTuple):
    """Carried PLL state (project.cpp:46-53 + q_ncoState fmMonoBlock.py:441)."""
    feedback_i: Tensor    # [...], init 1.0
    feedback_q: Tensor    # [...], init 0.0
    integrator: Tensor    # [...], init 0.0
    phase_est: Tensor     # [...], init 0.0
    angle: Tensor         # [...], init 0.0 (2*pi*f/Fs*trigOffset, wrapped)
    nco: Tensor           # [...], init 1.0
    nco_q: Tensor         # [...], init 1.0 (quadrature, used by RDS)


def init_state(batch: tuple[int, ...] = (), dtype=torch.float32,
               device="cuda") -> PLLState:
    """Initial loop state on ``device`` (the card unless the caller asks
    for the CPU)."""
    z = torch.zeros(batch, dtype=dtype, device=device)
    o = torch.ones(batch, dtype=dtype, device=device)
    return PLLState(feedback_i=o, feedback_q=z, integrator=z, phase_est=z,
                    angle=z, nco=o, nco_q=o)


def _loop_consts(freq, fs, norm_bandwidth):
    """(kp, ki, dtheta) as float32 numpy values, computed in float32 in
    the order of dy4tpu's ``_loop_consts`` so they are bit-equal to it."""
    f32 = np.float32
    bw = np.asarray(norm_bandwidth, f32)
    kp = bw * f32(_CP)
    ki = bw * bw * f32(_CI)
    dtheta = f32(2.0 * np.pi) * np.asarray(freq, f32) / f32(fs)
    return kp, ki, dtheta


def _make_step(kp, ki, dtheta):
    """The per-sample recurrence of dy4tpu's ``pll._make_step``, op for op:
    ``step((integrator, phase_est, angle), target, is_zero)`` returns the
    new carry and the emitted (pre-update) phase.  The detector target is
    pi*[x < 0]; ``is_zero`` is the zero-input guard.

    Each torch op rounds once and nothing fuses into an FMA, so the CUDA
    kernel (csrc/pll.cu, built with -fmad=false) reproduces it bitwise.
    """
    def step(carry, tk, zk):
        integrator, phase_est, angle = carry
        phi = angle + phase_est
        # wrap(tk - phi) to [-pi, pi) == atan2 phase detector
        v = tk - phi + PI
        error_d = v - TWO_PI * torch.floor(v * INV_TWO_PI) - PI
        error_d = torch.where(zk, 0.0, error_d)
        integrator = integrator + ki * error_d
        pe = phase_est + kp * error_d + integrator
        pe = pe - torch.where(pe >= WRAP, WRAP, 0.0)
        phase_est = pe + torch.where(pe < 0.0, WRAP, 0.0)
        ang = angle + dtheta
        angle = ang - torch.where(ang >= WRAP, WRAP, 0.0)
        return (integrator, phase_est, angle), phi

    return step


def _span_consts(kp, ki, dtheta, span: int):
    """(k, kp_eff, ki_eff, dth_eff) of the span step as float32 numpy
    values, computed in the order of dy4tpu's ``_make_span_step``, so that
    the CUDA kernel and the plain scan take the same bits.  The per-span
    angle increment is pre-wrapped (``span*dtheta`` can exceed WRAP for
    the 114 kHz RDS carrier) so the in-loop conditional wrap stays total.
    """
    f32 = np.float32
    k = f32(span)
    wrap = f32(_WRAP)
    kp_eff = k * kp + ki * f32(span * (span + 1) / 2.0)
    ki_eff = k * ki
    dth = k * np.asarray(dtheta, f32)
    dth_eff = dth - wrap * np.floor(dth / wrap)
    return k, kp_eff, ki_eff, dth_eff


def _make_span_step(kp_eff, ki_eff, dth_eff, k: float):
    """One loop-filter update per span, op for op dy4tpu's
    ``_make_span_step`` (the error is held over the span and the loop
    evolved through it in closed form; note that the integrator update
    comes after ``pe`` here).  ``step(carry, target, dead)`` returns the
    new carry and the emitted pre-update phase; ``dead`` (a NaN target)
    zeroes the error.  The CUDA kernel (csrc/pll.cu) reproduces it
    bitwise."""
    def step(carry, tk, zk):
        integrator, phase_est, angle = carry
        phi = angle + phase_est
        v = tk - phi + PI
        error_d = v - TWO_PI * torch.floor(v * INV_TWO_PI) - PI
        error_d = torch.where(zk, 0.0, error_d)
        pe = phase_est + kp_eff * error_d + k * integrator
        integrator = integrator + ki_eff * error_d
        pe = pe - torch.where(pe >= WRAP, WRAP, 0.0)
        pe = pe + torch.where(pe < 0.0, WRAP, 0.0)
        ang = angle + dth_eff
        angle = ang - torch.where(ang >= WRAP, WRAP, 0.0)
        return (integrator, pe, angle), phi

    return step


def _span_targets(x: Tensor, dtheta: Tensor, span: int) -> Tensor:
    """Span-averaged phase-detector targets ([..., N] -> [..., N/span]),
    as dy4tpu's ``_span_targets``: the detector phasor sign(x_i) averaged
    over the span with the NCO's known within-span ramp compensated,
    ``T = arg(sum_i sign(x_i) exp(-j i dtheta))``.  Spans with no sign
    information (all-zero input, or full cancellation) give NaN, which
    the scan maps to a zero error."""
    xr = x.reshape(*x.shape[:-1], x.shape[-1] // span, span)
    sgn = torch.sign(xr)                                  # 0 drops a sample
    i = torch.arange(span, dtype=x.dtype, device=x.device)
    ramp = dtheta[..., None] * i                          # [(lanes), K]
    cosr = torch.cos(ramp)[..., None, :]                  # [(lanes), 1, K]
    sinr = torch.sin(ramp)[..., None, :]
    s_re = torch.sum(sgn * cosr, dim=-1)                  # [..., M]
    s_im = -torch.sum(sgn * sinr, dim=-1)
    t = torch.atan2(s_im, s_re)
    dead = s_re * s_re + s_im * s_im < float(np.float32(1e-6))
    return torch.where(dead, float("nan"), t)


def _span_expand(phi0: Tensor, i0: Tensor, targets: Tensor, kp: Tensor,
                 ki: Tensor, dtheta: Tensor, span: int) -> Tensor:
    """Within-span phase reconstruction, as dy4tpu's ``_span_expand``:
    per-span (phi0, I0, detector target) [..., M] -> [..., M*span] with
    ``out_j = phi0 + j*(dtheta + kp*err + I0) + j(j+1)/2 * ki*err``
    (the per-sample ``kp``/``ki``/``dtheta``, not the span's)."""
    v = targets - phi0 + PI
    err = v - TWO_PI * torch.floor(v * INV_TWO_PI) - PI
    err = torch.where(torch.isnan(targets), 0.0, err)
    lin = dtheta[..., None] + kp[..., None] * err + i0    # [..., M]
    quad = ki[..., None] * err
    j = torch.arange(span, dtype=phi0.dtype, device=phi0.device)
    tri = j * (j + 1.0) * 0.5
    out = phi0[..., None] + j * lin[..., None] + tri * quad[..., None]
    return out.reshape(*phi0.shape[:-1], phi0.shape[-1] * span)


# sign codes of the PLL input (dy4tpu's, value for value): the input enters
# the recurrence only through its sign and the zero guard, so an int8 code
# stream is a lossless stand-in for the float32 samples
CODE_POS = 0
CODE_NEG = 1
CODE_ZERO = 2
CODE_INVALID = 3   # pre-stream padding: freezes the carry entirely


def encode_sign(x: Tensor) -> Tensor:
    """float32 PLL input -> int8 sign codes (POS/NEG/ZERO)."""
    return torch.where(x == 0.0, CODE_ZERO,
                       torch.where(x < 0.0, CODE_NEG, CODE_POS)).to(
                           torch.int8)


def phase_scan_coded(codes: Tensor, carry: tuple[Tensor, Tensor, Tensor], *,
                     freq, fs: float, norm_bandwidth, split_at: int
                     ) -> tuple[Tensor, tuple[Tensor, Tensor, Tensor],
                                tuple[Tensor, Tensor, Tensor]]:
    """Run the PLL phase recurrence over an int8 sign-code stream.

    ``codes``: [..., M] int8; ``carry``: (integrator, phase_est, angle),
    each [...]; ``freq``/``norm_bandwidth`` as for ``pll``.
    ``CODE_INVALID`` samples leave the carry untouched, though their
    (pre-update) phase is still emitted.  Returns ``(phis [..., M],
    carry_at_split, carry_end)``, ``carry_at_split`` the carry after
    exactly ``split_at`` samples (0 <= split_at <= M): the state the next
    chunk's replay resumes from in the exact time-sharded receiver.

    B8 (``pll_cuda.phase_scan_coded``) for a CUDA tensor, its plain loop
    for a CPU one.  For valid codes the phases and carries equal those of
    ``pll``'s scan over the samples the codes encode, bit for bit.
    """
    from dy4tpu_torch.ops import pll_cuda  # its plain twin imports us

    dev = codes.device
    kp, ki, dtheta = (torch.as_tensor(v, device=dev)
                      for v in _loop_consts(freq, fs, norm_bandwidth))
    return pll_cuda.phase_scan_coded(codes, kp, ki, dtheta, tuple(carry),
                                     split_at=split_at)


def pll(pll_in: Tensor, state: PLLState, *, freq, fs: float,
        nco_scale=1.0, norm_bandwidth=0.01,
        impl: str = "auto", span: int = 1, span_emit: str = "torch"
        ) -> tuple[Tensor, Tensor, PLLState]:
    """Run the PLL over a block.

    ``pll_in``: [..., N] float32; state fields: [...].  Returns
    ``(nco_i, nco_q, new_state)`` with outputs shaped like the input.
    ``freq``/``nco_scale``/``norm_bandwidth`` may be scalars or per-lane
    arrays broadcastable to the batch dims (several loop configurations
    in one scan, e.g. the stereo pilot and the RDS carrier on a lane axis).

    ``span``: 1 (default) runs the exact per-sample loop (B2); K > 1 the
    span PLL (module docstring; B9), which needs ``N % K == 0``.
    ``span_emit`` (span > 1): "torch" (default) rebuilds the within-span
    phases with ``_span_expand`` after B9; "kernel" has B9-expand emit
    them (its plain version for ``impl="plain"`` or a CPU tensor, as
    ``impl`` picks for the scan).
    """
    from dy4tpu_torch.ops import pll_cuda  # its plain twin imports us

    dev = pll_in.device
    consts = _loop_consts(freq, fs, norm_bandwidth)
    kp, ki, dtheta = (torch.as_tensor(v, device=dev) for v in consts)
    scale = torch.as_tensor(np.asarray(nco_scale, np.float32), device=dev)
    carry0 = (state.integrator, state.phase_est, state.angle)
    if impl not in ("plain", "kernel", "auto"):
        raise ValueError(f"unknown pll impl {impl!r}")
    if impl == "kernel" and not pll_in.is_cuda:
        raise ValueError(f"impl='kernel' needs a CUDA tensor, got {dev}")
    if span_emit not in ("torch", "kernel"):
        raise ValueError(f"span_emit must be 'torch' or 'kernel', got "
                         f"{span_emit!r}")
    plain = impl == "plain"
    if span > 1:
        n = pll_in.shape[-1]
        if n % span:
            raise ValueError(f"block length {n} not divisible by pll span "
                             f"{span}")
        k, *eff = _span_consts(*consts, span)
        kp_e, ki_e, dth_e = (torch.as_tensor(v, device=dev) for v in eff)
        targets = _span_targets(pll_in, dtheta, span).contiguous()
        scan = (pll_cuda.phase_scan_target_plain if plain
                else pll_cuda.phase_scan_target)
        if span_emit == "kernel":
            phis, (integ, pe, ang) = scan(targets, kp_e, ki_e, dth_e,
                                          carry0, span=span,
                                          expand=(kp, ki, dtheta))
        else:
            phi0, i0, (integ, pe, ang) = scan(targets, kp_e, ki_e, dth_e,
                                              carry0, span=span)
            phis = _span_expand(phi0, i0, targets, kp, ki, dtheta, span)
    elif span == 1:
        scan = pll_cuda.phase_scan_plain if plain else pll_cuda.phase_scan
        phis, (integ, pe, ang) = scan(pll_in, kp, ki, dtheta, carry0)
    else:
        raise ValueError(f"pll span must be >= 1, got {span}")

    nco_q, nco_i = trig.nco_sincos(phis * scale[..., None])
    # the first output comes from the carried NCO (handles the reference's
    # inconsistent q_ncoState=1.0 init, fmMonoBlock.py:441)
    nco_i = torch.cat([state.nco[..., None], nco_i[..., 1:]], dim=-1)
    nco_q = torch.cat([state.nco_q[..., None], nco_q[..., 1:]], dim=-1)

    phi_end = ang + pe
    # the carried nco/nco_q become the NEXT block's first emitted sample,
    # so they ride the same trig as the bulk synthesis
    end_q, end_i = trig.nco_sincos(phi_end * scale)
    new_state = PLLState(
        feedback_i=torch.cos(phi_end), feedback_q=torch.sin(phi_end),
        integrator=integ, phase_est=pe, angle=ang, nco=end_i, nco_q=end_q)
    return nco_i, nco_q, new_state


def pll_reference(pll_in: Tensor, state: PLLState, *, freq: float,
                  fs: float, nco_scale: float = 1.0,
                  phase_adjust: float = 0.0, norm_bandwidth: float = 0.01
                  ) -> tuple[Tensor, Tensor, PLLState]:
    """Literal transcription of the reference loop (filter.cpp:174-228):
    one atan2 and a cos/sin pair per sample, a torch loop over time.  Kept
    as the cross-check of the sign-detector recurrence that ``pll`` runs
    (tests/test_torch_remnants.py), as dy4tpu keeps its own.  Returns
    ``(nco_i, nco_q, new_state)`` shaped like ``pll``'s."""
    kp = norm_bandwidth * _CP
    ki = norm_bandwidth * norm_bandwidth * _CI
    dtheta = 2.0 * np.pi * (freq / fs)
    carry = state
    nco_i, nco_q = [], []
    for k in range(pll_in.shape[-1]):
        xk = pll_in[..., k]
        error_i = xk * carry.feedback_i
        error_q = xk * -carry.feedback_q
        error_d = torch.where(error_i == 0.0, 0.0,
                              torch.atan2(error_q, error_i))
        integrator = carry.integrator + ki * error_d
        phase_est = torch.remainder(carry.phase_est + kp * error_d
                                    + integrator, _WRAP)
        angle = torch.remainder(carry.angle + dtheta, _WRAP)
        trig_arg = angle + phase_est
        out_arg = trig_arg * nco_scale + phase_adjust
        # emit the previous NCO sample: output k is the nco of step k-1
        nco_i.append(carry.nco)
        nco_q.append(carry.nco_q)
        carry = PLLState(
            feedback_i=torch.cos(trig_arg), feedback_q=torch.sin(trig_arg),
            integrator=integrator, phase_est=phase_est, angle=angle,
            nco=torch.cos(out_arg), nco_q=torch.sin(out_arg))
    return torch.stack(nco_i, -1), torch.stack(nco_q, -1), carry

"""Type-II software PLL + NCO: the counterpart of ``dy4tpu/ops/pll.py``
(sign-detector path).

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
               device="cpu") -> PLLState:
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


def pll(pll_in: Tensor, state: PLLState, *, freq, fs: float,
        nco_scale=1.0, norm_bandwidth=0.01,
        impl: str = "auto") -> tuple[Tensor, Tensor, PLLState]:
    """Run the PLL over a block.

    ``pll_in``: [..., N] float32; state fields: [...].  Returns
    ``(nco_i, nco_q, new_state)`` with outputs shaped like the input.
    ``freq``/``nco_scale``/``norm_bandwidth`` may be scalars or per-lane
    arrays broadcastable to the batch dims (several loop configurations
    in one scan, e.g. the stereo pilot and the RDS carrier on a lane axis).
    """
    from dy4tpu_torch.ops import pll_cuda  # its plain twin imports us

    dev = pll_in.device
    kp, ki, dtheta = (torch.as_tensor(v, device=dev)
                      for v in _loop_consts(freq, fs, norm_bandwidth))
    scale = torch.as_tensor(np.asarray(nco_scale, np.float32), device=dev)
    carry0 = (state.integrator, state.phase_est, state.angle)
    if impl == "plain":
        scan = pll_cuda.phase_scan_plain
    elif impl == "kernel" and not pll_in.is_cuda:
        raise ValueError(f"impl='kernel' needs a CUDA tensor, got {dev}")
    elif impl in ("kernel", "auto"):
        scan = pll_cuda.phase_scan
    else:
        raise ValueError(f"unknown pll impl {impl!r}")
    phis, (integ, pe, ang) = scan(pll_in, kp, ki, dtheta, carry0)

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

"""The rational-resampler back ends: two CUDA kernels and their plain
torch versions.

``fused_rds_backend`` (``csrc/rds_backend.cu``) replaces
``dy4tpu/ops/resample_pallas.py :: fused_rds_backend``: the quadrature mix
of the delayed RDS band with the RDS NCO pair, the rational U/D resampler
with its 3 kHz LPF (19/120 with 1919 taps at mode 0, 171/640 with 17271
taps at mode 2), and the RRC matched filter, for the I and Q legs with
four tails carried.  The kernel keeps the mixed and resampled streams of a
leg in shared memory and visits only the valid polyphase taps (see the
note in ``csrc/rds_backend.cu``).

``fused_audio_backend_rational`` (``csrc/audio_rational.cu``) replaces
``resample_pallas.fused_audio_backend_rational``: the audio back end of
the U>1 modes 2 and 3 (147/800 and 147/1280 with 14847 taps), the
``2 * nco * stereo_band`` mix, the mono and stereo rational resamplers and
the L/R matrix.

Both match their plain versions to float32 tolerance; the carried
resampler tails are exact.
"""

from __future__ import annotations

import ctypes

import torch

from dy4tpu_torch.ops import fir, mix
from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

_ARGS = ([ctypes.c_void_p] * 15 + [ctypes.c_longlong] + [ctypes.c_int] * 5
         + [ctypes.c_void_p])


def fused_rds_backend_plain(rds_delayed, nco_i, nco_q, h_lpf, h_rrc,
                            lpf_tail_i, lpf_tail_q, rrc_tail_i, rrc_tail_q,
                            up: int, down: int):
    """Plain torch version of ``fused_rds_backend`` (any leading batch
    dims, any device): the I and Q legs ride a stacked lane through one
    resampler call and one RRC call."""
    mixed = torch.stack([mix.mix(nco_i, rds_delayed, gain=1.0),
                         mix.mix(nco_q, rds_delayed, gain=1.0)], dim=-2)
    lpf_tails = torch.stack([lpf_tail_i, lpf_tail_q], dim=-2)
    lp, lpf_tails = fir.block_fir_resample(mixed, h_lpf, lpf_tails,
                                           up=up, down=down)
    rrc_tails = torch.stack([rrc_tail_i, rrc_tail_q], dim=-2)
    bb, rrc_tails = fir.block_fir(lp, h_rrc, rrc_tails)
    return (bb[..., 0, :], bb[..., 1, :], lpf_tails[..., 0, :],
            lpf_tails[..., 1, :], rrc_tails[..., 0, :], rrc_tails[..., 1, :])


def fused_rds_backend(rds_delayed, nco_i, nco_q, h_lpf, h_rrc, lpf_tail_i,
                      lpf_tail_q, rrc_tail_i, rrc_tail_q, up: int,
                      down: int):
    """Returns ``(bb_i, bb_q, new_lpf_tail_i, new_lpf_tail_q,
    new_rrc_tail_i, new_rrc_tail_q)``: the kernel for CUDA tensors, the
    plain version for CPU ones.

    ``rds_delayed``, ``nco_i``, ``nco_q``: [C, N]; ``h_lpf`` [K];
    ``h_rrc`` [K2]; LPF tails [C, (K-1)//up]; RRC tails [C, K2-1]; all
    float32 and contiguous.  ``bb_i``/``bb_q``: [C, N*up/down].
    """
    args = (rds_delayed, nco_i, nco_q, h_lpf, h_rrc, lpf_tail_i, lpf_tail_q,
            rrc_tail_i, rrc_tail_q)
    if rds_delayed.device.type == "cpu":
        return fused_rds_backend_plain(*args, up, down)
    c, n = rds_delayed.shape
    k, k2 = h_lpf.shape[0], h_rrc.shape[0]
    s = fir.state_len(k, up)
    m = n * up // down
    if (n * up) % down or n < s or m < k2 - 1:
        raise ValueError(f"block of {n} samples does not resample by "
                         f"{up}/{down} into at least {k2 - 1} outputs")
    dev = rds_delayed.device
    for t, name, shape in ((rds_delayed, "rds_delayed", (c, n)),
                           (nco_i, "nco_i", (c, n)), (nco_q, "nco_q", (c, n)),
                           (h_lpf, "h_lpf", (k,)), (h_rrc, "h_rrc", (k2,)),
                           (lpf_tail_i, "lpf_tail_i", (c, s)),
                           (lpf_tail_q, "lpf_tail_q", (c, s)),
                           (rrc_tail_i, "rrc_tail_i", (c, k2 - 1)),
                           (rrc_tail_q, "rrc_tail_q", (c, k2 - 1))):
        kernels.require(t, name, shape, device=dev)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=dev)
    outs = [new(c, m), new(c, m), new(c, s), new(c, s), new(c, k2 - 1),
            new(c, k2 - 1)]
    fn = kernels.entry("rds_backend", "dy4_rds_backend", _ARGS)
    with torch.cuda.device(dev):
        status = fn(*(t.data_ptr() for t in args),
                    *(t.data_ptr() for t in outs), c, n, up, down, k, k2,
                    kernels.stream_of(rds_delayed))
    kernels.check_launch(status, "rds_backend fused_rds_backend")
    fused_rds_backend.launches += 1
    return tuple(outs)


fused_rds_backend.launches = 0

_AUDIO_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong]
               + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def fused_audio_backend_rational_plain(fm_delayed, stereo_band, nco,
                                       h_audio, mono_tail, stereo_tail,
                                       up: int, down: int):
    """Plain torch version of ``fused_audio_backend_rational`` (any
    leading batch dims, any device): mix, one stacked rational resampler
    call over the mono and stereo legs, stereo matrix."""
    stereo_mixed = mix.mix(nco, stereo_band, gain=2.0)
    audio_in = torch.stack([fm_delayed, stereo_mixed], dim=-2)
    tails = torch.stack([mono_tail, stereo_tail], dim=-2)
    out, tails = fir.block_fir_resample(audio_in, h_audio, tails, up=up,
                                        down=down)
    mono, stereo_lp = out[..., 0, :], out[..., 1, :]
    left, right = mix.stereo_matrix(mono, stereo_lp)
    return mono, left, right, tails[..., 0, :], tails[..., 1, :]


def fused_audio_backend_rational(fm_delayed, stereo_band, nco, h_audio,
                                 mono_tail, stereo_tail, up: int,
                                 down: int):
    """Returns ``(mono, left, right, new_mono_tail, new_stereo_tail)``:
    the kernel for CUDA tensors, the plain version for CPU ones.

    ``fm_delayed``, ``stereo_band``, ``nco``: [C, N]; ``h_audio`` [K];
    tails [C, (K-1)//up]; all float32 and contiguous.  Outputs
    [C, N*up/down].
    """
    args = (fm_delayed, stereo_band, nco, h_audio, mono_tail, stereo_tail)
    if fm_delayed.device.type == "cpu":
        return fused_audio_backend_rational_plain(*args, up, down)
    c, n = fm_delayed.shape
    k = h_audio.shape[0]
    s = fir.state_len(k, up)
    if (n * up) % down or n < s:
        raise ValueError(f"block of {n} samples does not resample by "
                         f"{up}/{down} or is shorter than the {s}-sample "
                         f"tail")
    dev = fm_delayed.device
    for t, name, shape in ((fm_delayed, "fm_delayed", (c, n)),
                           (stereo_band, "stereo_band", (c, n)),
                           (nco, "nco", (c, n)), (h_audio, "h_audio", (k,)),
                           (mono_tail, "mono_tail", (c, s)),
                           (stereo_tail, "stereo_tail", (c, s))):
        kernels.require(t, name, shape, device=dev)
    kernels.check_smem("audio_rational", "dy4_audio_rational_smem",
                       "fused_audio_backend_rational", n, up, down, k)
    m = n * up // down
    outs = ([torch.empty(c, m, dtype=torch.float32, device=dev)
             for _ in range(3)]
            + [torch.empty(c, s, dtype=torch.float32, device=dev)
               for _ in range(2)])
    fn = kernels.entry("audio_rational", "dy4_audio_rational", _AUDIO_ARGS)
    with torch.cuda.device(dev):
        status = fn(*(t.data_ptr() for t in args),
                    *(t.data_ptr() for t in outs), c, n, up, down, k,
                    kernels.stream_of(fm_delayed))
    kernels.check_launch(status, "audio_rational "
                                 "fused_audio_backend_rational")
    fused_audio_backend_rational.launches += 1
    return tuple(outs)


fused_audio_backend_rational.launches = 0

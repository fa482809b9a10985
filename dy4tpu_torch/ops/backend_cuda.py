"""Audio back end of the U=1 modes: the CUDA kernel
(``csrc/audio_backend.cu``) and its plain torch version.

Replaces ``dy4tpu/ops/backend_pallas.py :: fused_audio_backend``: the
``2 * nco * stereo_band`` mix, the decimating audio LPF on the mono and
stereo legs with their tails, and the L/R matrix.  The kernel forms the
mixed stream in shared memory and computes both legs of an output in one
thread (see the note in ``csrc/audio_backend.cu``).  It matches the plain
version to float32 tolerance; the tails are exact.
"""

from __future__ import annotations

import ctypes

import torch

from dy4tpu_torch.ops import fir, mix
from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 3
         + [ctypes.c_void_p])


def fused_audio_backend_plain(fm_delayed, stereo_band, nco, h_audio,
                              mono_tail, stereo_tail, decim: int):
    """Plain torch version of ``fused_audio_backend`` (any leading batch
    dims, any device): mix, one stacked resampler call, stereo matrix."""
    stereo_mixed = mix.mix(nco, stereo_band, gain=2.0)
    audio_in = torch.stack([fm_delayed, stereo_mixed], dim=-2)
    tails = torch.stack([mono_tail, stereo_tail], dim=-2)
    out, tails = fir.block_fir_resample(audio_in, h_audio, tails,
                                        down=decim)
    mono, stereo_lp = out[..., 0, :], out[..., 1, :]
    left, right = mix.stereo_matrix(mono, stereo_lp)
    return mono, left, right, tails[..., 0, :], tails[..., 1, :]


def fused_audio_backend(fm_delayed, stereo_band, nco, h_audio, mono_tail,
                        stereo_tail, decim: int):
    """Returns ``(mono, left, right, new_mono_tail, new_stereo_tail)``:
    the kernel for CUDA tensors, the plain version for CPU ones.

    ``fm_delayed``, ``stereo_band``, ``nco``: [C, N]; ``h_audio`` [K];
    tails [C, K-1]; all float32 and contiguous.  Outputs [C, N/decim].
    """
    args = (fm_delayed, stereo_band, nco, h_audio, mono_tail, stereo_tail)
    if fm_delayed.device.type == "cpu":
        return fused_audio_backend_plain(*args, decim)
    c, n = fm_delayed.shape
    k = h_audio.shape[0]
    if n % decim or n < k - 1:
        raise ValueError(f"block of {n} samples does not decimate by "
                         f"{decim} or is shorter than the {k - 1}-sample "
                         f"tail")
    dev = fm_delayed.device
    for t, name, shape in ((fm_delayed, "fm_delayed", (c, n)),
                           (stereo_band, "stereo_band", (c, n)),
                           (nco, "nco", (c, n)), (h_audio, "h_audio", (k,)),
                           (mono_tail, "mono_tail", (c, k - 1)),
                           (stereo_tail, "stereo_tail", (c, k - 1))):
        kernels.require(t, name, shape, device=dev)
    m = n // decim
    outs = ([torch.empty(c, m, dtype=torch.float32, device=dev)
             for _ in range(3)]
            + [torch.empty(c, k - 1, dtype=torch.float32, device=dev)
               for _ in range(2)])
    fn = kernels.entry("audio_backend", "dy4_audio_backend", _ARGS)
    with torch.cuda.device(dev):
        status = fn(*(t.data_ptr() for t in args),
                    *(t.data_ptr() for t in outs), c, n, decim, k,
                    kernels.stream_of(fm_delayed))
    kernels.check_launch(status, "audio_backend fused_audio_backend")
    fused_audio_backend.launches += 1
    return tuple(outs)


fused_audio_backend.launches = 0

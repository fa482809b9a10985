"""Audio back end of the U=1 modes: the CUDA kernel and its plain torch
version.

Replaces ``dy4tpu/ops/backend_pallas.py :: fused_audio_backend``: the
``2 * nco * stereo_band`` mix, the decimating audio LPF on the mono and
stereo legs with their tails, and the L/R matrix.  The kernel is the
rational audio back end's (``csrc/audio_rational.cu`` over
``csrc/rational.cuh``) at U = 1: each cycle of its walk is a run of
consecutive outputs, a thread owns P consecutive outputs whose shifted
tap rows share each input read, and the plan comes from
``resample_cuda._tile_plan``.  It matches the plain version to float32
tolerance; the tails are exact.  ``precision`` rounds as
``resample_cuda``'s back ends do.
"""

from __future__ import annotations

from dy4tpu_torch.ops import resample_cuda


def fused_audio_backend_plain(fm_delayed, stereo_band, nco, h_audio,
                              mono_tail, stereo_tail, decim: int,
                              precision: str = "highest"):
    """Plain torch version of ``fused_audio_backend`` (any leading batch
    dims, any device): the rational back end's plain version at U = 1."""
    return resample_cuda.fused_audio_backend_rational_plain(
        fm_delayed, stereo_band, nco, h_audio, mono_tail, stereo_tail, 1,
        decim, precision)


def fused_audio_backend(fm_delayed, stereo_band, nco, h_audio, mono_tail,
                        stereo_tail, decim: int, precision: str = "highest"):
    """Returns ``(mono, left, right, new_mono_tail, new_stereo_tail)``:
    the kernel for CUDA tensors, the plain version for CPU ones.

    ``fm_delayed``, ``stereo_band``, ``nco``: [C, N]; ``h_audio`` [K];
    tails [C, K-1]; all float32 and contiguous.  Outputs [C, N/decim].
    ``precision``: "highest" (default), "high" or "default"
    (``ops/precision.py``).
    """
    args = (fm_delayed, stereo_band, nco, h_audio, mono_tail, stereo_tail)
    if fm_delayed.device.type == "cpu":
        return fused_audio_backend_plain(*args, decim, precision)
    outs = resample_cuda._audio_launch(args, 1, decim, precision=precision)
    fused_audio_backend.launches += 1
    return outs


fused_audio_backend.launches = 0

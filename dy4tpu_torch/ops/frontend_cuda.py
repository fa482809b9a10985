"""The LTI front half of the receiver: the CUDA kernel
(``csrc/frontend.cu``) and its plain torch version.

Replaces ``dy4tpu/ops/frontend_pallas.py :: fused_frontend_full``: raw u8
IQ -> normalize -> RF LPF decimating on both legs -> FM demod -> mono delay,
pilot/stereo/RDS-band bank, squaring + carrier BPF, RDS delay, with every
tail carried.  The kernel keeps all intermediate streams of a row in
shared memory, so only the u8 block and the five IF-rate outputs touch
device memory (see the note in ``csrc/frontend.cu``).  It matches the
plain version to float32 tolerance; the new ``iq_tail`` is exact.
"""

from __future__ import annotations

import ctypes

import torch

from dy4tpu_torch.ops import demod, fir, mix
from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

_ARGS = ([ctypes.c_void_p] * 23 + [ctypes.c_longlong] * 2
         + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def rf_demod_plain(iq_u8: Tensor, h_rf: Tensor, iq_tail: Tensor,
                   prev_i: Tensor, prev_q: Tensor, decim: int):
    """u8 [..., bs] -> (fm [..., bs/2/decim], iq_tail, prev_i, prev_q):
    normalize, deinterleave, decimating RF LPF on both legs, demod."""
    bs = iq_u8.shape[-1]
    x = (iq_u8.to(torch.float32) - 128.0) / 128.0
    iq = x.reshape(*x.shape[:-1], bs // 2, 2).movedim(-1, -2)  # I row 0
    iq_ds, iq_tail = fir.block_fir_decim(iq, h_rf, iq_tail, decim)
    fm, prev_i, prev_q = demod.fm_demod_diff(iq_ds[..., 0, :],
                                             iq_ds[..., 1, :], prev_i, prev_q)
    return fm, iq_tail, prev_i, prev_q


def band_stages_plain(fm: Tensor, h_bank: Tensor, h_carrier, bank_tail,
                      mono_delay, carrier_tail, rds_delay, *, rds: bool):
    """The post-demod stages: mono delay, band bank over fm, and (with
    ``rds``) squaring + carrier BPF and the RDS delay.  Returns
    ``(fm_delayed, pilot, stereo, carrier, rds_delayed, new_bank_tail,
    new_mono_delay, new_carrier_tail, new_rds_delay)``, the RDS entries
    None without ``rds``."""
    fm_delayed, mono_delay = mix.delay_block(fm, mono_delay)
    bands, bank_tail = fir.block_fir_bank(fm, h_bank, bank_tail)
    carrier = rds_delayed = carrier_tail_out = rds_delay_out = None
    if rds:
        rds_band = bands[..., 2, :]
        squared = mix.squaring_nonlinearity(rds_band)
        carrier, carrier_tail_out = fir.block_fir(squared, h_carrier,
                                                  carrier_tail)
        rds_delayed, rds_delay_out = mix.delay_block(rds_band, rds_delay)
    return (fm_delayed, bands[..., 0, :], bands[..., 1, :], carrier,
            rds_delayed, bank_tail, mono_delay, carrier_tail_out,
            rds_delay_out)


def fused_frontend_full_plain(iq_u8, h_rf, h_bank, h_carrier, iq_tail,
                              prev_i, prev_q, bank_tail, mono_delay,
                              carrier_tail, rds_delay, decim: int, *,
                              rds: bool = True):
    """Plain torch version of ``fused_frontend_full`` (any leading batch
    dims, any device)."""
    fm, iq_tail, prev_i, prev_q = rf_demod_plain(iq_u8, h_rf, iq_tail,
                                                 prev_i, prev_q, decim)
    (fmd, pilot, stereo, carrier, rdsdel, bank_tail, mono_delay,
     carrier_tail, rds_delay) = band_stages_plain(
        fm, h_bank, h_carrier, bank_tail, mono_delay, carrier_tail,
        rds_delay, rds=rds)
    return (fmd, pilot, stereo, carrier, rdsdel, iq_tail, prev_i, prev_q,
            bank_tail, mono_delay, carrier_tail, rds_delay)


def fused_frontend_full(iq_u8, h_rf, h_bank, h_carrier, iq_tail, prev_i,
                        prev_q, bank_tail, mono_delay, carrier_tail,
                        rds_delay, decim: int, *, rds: bool = True):
    """The whole front half of one block: the kernel for CUDA tensors,
    the plain version for CPU ones.

    ``iq_u8`` [C, bs] uint8; ``h_rf`` [K]; ``h_bank`` [3, Kb] (pilot,
    stereo, RDS band); ``h_carrier`` [Kb]; tails ``iq_tail`` [C, 2, K-1],
    ``prev_i``/``prev_q`` [C], ``bank_tail`` [C, Kb-1], ``mono_delay``
    [C, Kb//2], ``carrier_tail`` [C, Kb-1], ``rds_delay`` [C, Kb//2], all
    float32 and contiguous.  Returns ``(fm_delayed, pilot, stereo,
    carrier, rds_delayed, iq_tail, prev_i, prev_q, bank_tail, mono_delay,
    carrier_tail, rds_delay)``, the IF-rate streams [C, bs/2/decim].
    """
    args = (iq_u8, h_rf, h_bank, h_carrier, iq_tail, prev_i, prev_q,
            bank_tail, mono_delay, carrier_tail, rds_delay)
    if iq_u8.device.type == "cpu":
        return fused_frontend_full_plain(*args, decim, rds=rds)
    if not rds:
        raise NotImplementedError(
            "the CUDA front end always runs the RDS stages; with_rds=False "
            "on the kernel path waits for ROADMAP Queue A item 6 (modes "
            "1-3); pass frontend='plain'")
    c, bs = iq_u8.shape
    k = h_rf.shape[0]
    kb = h_bank.shape[-1]
    n_out = bs // 2 // decim
    if bs % (2 * decim) or n_out < kb:
        raise ValueError(f"block of {bs} bytes does not decimate by {decim} "
                         f"into at least {kb} IF samples")
    dev = iq_u8.device
    kernels.require(iq_u8, "iq_u8", (c, bs), torch.uint8, dev)
    for t, name, shape in (
            (h_rf, "h_rf", (k,)), (h_bank, "h_bank", (3, kb)),
            (h_carrier, "h_carrier", (kb,)),
            (iq_tail, "iq_tail", (c, 2, k - 1)), (prev_i, "prev_i", (c,)),
            (prev_q, "prev_q", (c,)), (bank_tail, "bank_tail", (c, kb - 1)),
            (mono_delay, "mono_delay", (c, kb // 2)),
            (carrier_tail, "carrier_tail", (c, kb - 1)),
            (rds_delay, "rds_delay", (c, kb // 2))):
        kernels.require(t, name, shape, device=dev)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=dev)
    outs = ([new(c, n_out) for _ in range(5)]
            + [new(c, 2, k - 1), new(c), new(c), new(c, kb - 1),
               new(c, kb // 2), new(c, kb - 1), new(c, kb // 2)])
    fn = kernels.entry("frontend", "dy4_frontend_full", _ARGS)
    with torch.cuda.device(dev):
        status = fn(*(t.data_ptr() for t in args),
                    *(t.data_ptr() for t in outs), c, bs, decim, k, kb,
                    kernels.stream_of(iq_u8))
    kernels.check_launch(status, "frontend fused_frontend_full")
    fused_frontend_full.launches += 1
    return tuple(outs)


fused_frontend_full.launches = 0

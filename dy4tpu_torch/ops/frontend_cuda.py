"""The LTI front half of the receiver: two CUDA kernels
(``csrc/frontend.cu``) and their plain torch versions.

``fused_frontend_full`` (B1) replaces ``dy4tpu/ops/frontend_pallas.py ::
fused_frontend_full``: raw u8 IQ -> normalize -> RF LPF decimating on both
legs -> FM demod -> mono delay, pilot/stereo(/RDS-band) bank, and with RDS
squaring + carrier BPF and the RDS delay, with every tail carried.

With ``corr=`` it launches B1's corr variant, dy4tpu's ``corr``
epilogue, the narrowband IQ tracker's tap: the kernel also returns the 14
conic-fit moments of the decimated I/Q before the correction
(``iqcorr.moments``) and corrects the I/Q before the demod
(``iqcorr.apply``).

``fused_frontend_if`` (B6) replaces ``frontend_pallas.fused_frontend_if``:
the same stages from the demod on, for float32 IF I/Q rows (the IF entry,
``receiver_step_if``); the RF ``iq_tail`` is not its business.

Both kernels keep all intermediate streams of a row in shared memory, so
only the block's input and the IF-rate outputs touch device memory (see
the note in ``csrc/frontend.cu``).  They match the plain versions to
float32 tolerance; B1's new ``iq_tail`` and B6's new ``prev_i``/``prev_q``
are exact.
"""

from __future__ import annotations

import ctypes

import torch

from dy4tpu_torch.ops import demod, fir, iqcorr, mix
from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

_ARGS = ([ctypes.c_void_p] * 23 + [ctypes.c_longlong] * 2
         + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_CORR_ARGS = ([ctypes.c_void_p] * 25 + [ctypes.c_longlong] * 2
              + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_IF_ARGS = ([ctypes.c_void_p] * 21 + [ctypes.c_longlong]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def rf_lpf_plain(iq_u8: Tensor, h_rf: Tensor, iq_tail: Tensor, decim: int):
    """u8 [..., bs] -> (i_ds, q_ds [..., bs/2/decim], iq_tail): normalize,
    deinterleave, decimating RF LPF on both legs."""
    bs = iq_u8.shape[-1]
    x = (iq_u8.to(torch.float32) - 128.0) / 128.0
    iq = x.reshape(*x.shape[:-1], bs // 2, 2).movedim(-1, -2)  # I row 0
    iq_ds, iq_tail = fir.block_fir_decim(iq, h_rf, iq_tail, decim)
    return iq_ds[..., 0, :], iq_ds[..., 1, :], iq_tail


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
                              rds: bool = True, corr=None):
    """Plain torch version of ``fused_frontend_full`` (any leading batch
    dims, any device): the RF LPF; with ``corr`` [..., 4] the moments of
    the decimated I/Q (``iqcorr.moments``) and the correction
    (``iqcorr.apply``), as dy4tpu's stock ``front_step(corr=...,
    corr_moments=True)``; then ``fused_frontend_if_plain``.  Returns B1's
    outputs, and ``mom`` last with ``corr``."""
    i_ds, q_ds, iq_tail = rf_lpf_plain(iq_u8, h_rf, iq_tail, decim)
    mom = ()
    if corr is not None:
        mom = (iqcorr.moments(i_ds, q_ds),)
        i_ds, q_ds = iqcorr.apply(i_ds, q_ds,
                                  iqcorr.IQCorrCoeffs(*corr.unbind(-1)))
    outs = fused_frontend_if_plain(i_ds, q_ds, prev_i, prev_q, h_bank,
                                   h_carrier, bank_tail, mono_delay,
                                   carrier_tail, rds_delay, rds=rds)
    return (*outs[:5], iq_tail, *outs[5:], *mom)


def _require_bands(h_bank, h_carrier, bank_tail, mono_delay,
                   carrier_tail, rds_delay, c: int, rds: bool, dev) -> None:
    """Check the band-stage taps and tails the kernels read.  Without
    ``rds`` the bank may keep its RDS row (only the first two rows are
    read) and the RDS entries are ignored."""
    kb = h_bank.shape[-1]
    rows = h_bank.shape[0] if h_bank.dim() == 2 else 0
    if rows < (3 if rds else 2):
        raise ValueError(f"h_bank: expected [{3 if rds else 2}, {kb}] "
                         f"(pilot, stereo{', RDS band' if rds else ''}), "
                         f"got {tuple(h_bank.shape)}")
    checks = [(h_bank, "h_bank", (rows, kb)),
              (bank_tail, "bank_tail", (c, kb - 1)),
              (mono_delay, "mono_delay", (c, kb // 2))]
    if rds:
        checks += [(h_carrier, "h_carrier", (kb,)),
                   (carrier_tail, "carrier_tail", (c, kb - 1)),
                   (rds_delay, "rds_delay", (c, kb // 2))]
    for t, name, shape in checks:
        kernels.require(t, name, shape, device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_full(args, decim: int, rds: bool, corr=None):
    """Check the inputs and launch B1 (with the corr epilogue when ``corr``
    is given).  ``args``: the eleven tensors of ``fused_frontend_full``.
    Returns the twelve outputs, and ``mom`` [C, 14] as a thirteenth with
    ``corr``."""
    iq_u8, h_rf, h_bank, h_carrier, iq_tail, prev_i, prev_q = args[:7]
    bank_tail, mono_delay, carrier_tail, rds_delay = args[7:]
    c, bs = iq_u8.shape
    k = h_rf.shape[0]
    kb = h_bank.shape[-1]
    n_out = bs // 2 // decim
    if bs % (2 * decim) or n_out < kb:
        raise ValueError(f"block of {bs} bytes does not decimate by {decim} "
                         f"into at least {kb} IF samples")
    dev = iq_u8.device
    kernels.require(iq_u8, "iq_u8", (c, bs), torch.uint8, dev)
    for t, name, shape in ((h_rf, "h_rf", (k,)),
                           (iq_tail, "iq_tail", (c, 2, k - 1)),
                           (prev_i, "prev_i", (c,)), (prev_q, "prev_q", (c,))):
        kernels.require(t, name, shape, device=dev)
    _require_bands(h_bank, h_carrier, bank_tail, mono_delay, carrier_tail,
                   rds_delay, c, rds, dev)
    with_corr = corr is not None
    if with_corr:
        kernels.require(corr, "corr", (c, 4), device=dev)
    kernels.check_smem("frontend", "dy4_frontend_smem",
                       "fused_frontend_full", bs // 2, decim, k, kb,
                       int(rds), int(with_corr))
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=dev)
    rds_new = lambda *shape: new(*shape) if rds else None  # noqa: E731
    outs = [new(c, n_out), new(c, n_out), new(c, n_out), rds_new(c, n_out),
            rds_new(c, n_out), new(c, 2, k - 1), new(c), new(c),
            new(c, kb - 1), new(c, kb // 2), rds_new(c, kb - 1),
            rds_new(c, kb // 2)]
    if not rds:
        args = args[:3] + (None,) + args[4:9] + (None, None)
    ptrs = [_ptr(t) for t in (*args, *outs)]
    if with_corr:
        mom = new(c, len(iqcorr._POWERS))
        fn = kernels.entry("frontend", "dy4_frontend_full_corr", _CORR_ARGS)
        ptrs += [corr.data_ptr(), mom.data_ptr()]
    else:
        fn = kernels.entry("frontend", "dy4_frontend_full", _ARGS)
    with torch.cuda.device(dev):
        status = fn(*ptrs, c, bs, decim, k, kb, int(rds),
                    kernels.stream_of(iq_u8))
    kernels.check_launch(status, "frontend fused_frontend_full")
    return (*outs, mom) if with_corr else tuple(outs)


def fused_frontend_full(iq_u8, h_rf, h_bank, h_carrier, iq_tail, prev_i,
                        prev_q, bank_tail, mono_delay, carrier_tail,
                        rds_delay, decim: int, *, rds: bool = True,
                        corr=None):
    """The whole front half of one block: the kernel for CUDA tensors,
    the plain version for CPU ones.

    ``iq_u8`` [C, bs] uint8; ``h_rf`` [K]; ``h_bank`` [3, Kb] (pilot,
    stereo, RDS band; [2, Kb] will do without ``rds``); ``h_carrier``
    [Kb]; tails ``iq_tail`` [C, 2, K-1], ``prev_i``/``prev_q`` [C],
    ``bank_tail`` [C, Kb-1], ``mono_delay`` [C, Kb//2], ``carrier_tail``
    [C, Kb-1], ``rds_delay`` [C, Kb//2], all float32 and contiguous.
    Returns ``(fm_delayed, pilot, stereo, carrier, rds_delayed, iq_tail,
    prev_i, prev_q, bank_tail, mono_delay, carrier_tail, rds_delay)``, the
    IF-rate streams [C, bs/2/decim].  Without ``rds`` the RDS inputs are
    not read (None will do) and the RDS outputs are None.

    ``corr`` [C, 4] float32 rows (dc_i, dc_q, rho, s) select the corr
    variant, the IQ tracker's epilogue: it corrects each row's decimated
    I/Q before the demod, ``i -= dc_i; q = (q - dc_q - rho*i) * s``, and
    returns ``mom`` [C, 14] as a thirteenth output, the means E[i^p q^r]
    of the I/Q before the correction in ``iqcorr._POWERS`` order.

    Launches are counted per variant: ``fused_frontend_full.launches``
    for the stock kernel, ``fused_frontend_full.corr.launches`` for the
    corr variant.
    """
    args = (iq_u8, h_rf, h_bank, h_carrier, iq_tail, prev_i, prev_q,
            bank_tail, mono_delay, carrier_tail, rds_delay)
    if iq_u8.device.type == "cpu":
        return fused_frontend_full_plain(*args, decim, rds=rds, corr=corr)
    outs = _launch_full(args, decim, rds, corr)
    (fused_frontend_full if corr is None
     else fused_frontend_full.corr).launches += 1
    return outs


class _Variant:
    """The launch count of one template variant of a kernel wrapper, read
    as a wrapper's own ``launches`` is."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


fused_frontend_full.launches = 0
fused_frontend_full.corr = _Variant("fused_frontend_full[corr]")


def fused_frontend_if_plain(i_if, q_if, prev_i, prev_q, h_bank, h_carrier,
                            bank_tail, mono_delay, carrier_tail, rds_delay,
                            *, rds: bool = True):
    """Plain torch version of ``fused_frontend_if`` (any leading batch
    dims, any device): the demod, then ``band_stages_plain``."""
    fm, prev_i, prev_q = demod.fm_demod_diff(i_if, q_if, prev_i, prev_q)
    (fmd, pilot, stereo, carrier, rdsdel, bank_tail, mono_delay,
     carrier_tail, rds_delay) = band_stages_plain(
        fm, h_bank, h_carrier, bank_tail, mono_delay, carrier_tail,
        rds_delay, rds=rds)
    return (fmd, pilot, stereo, carrier, rdsdel, prev_i, prev_q, bank_tail,
            mono_delay, carrier_tail, rds_delay)


def fused_frontend_if(i_if, q_if, prev_i, prev_q, h_bank, h_carrier,
                      bank_tail, mono_delay, carrier_tail, rds_delay, *,
                      rds: bool = True):
    """The IF-entry front half of one block: the kernel for CUDA tensors,
    the plain version for CPU ones.

    ``i_if``/``q_if`` [C, N] float32 IF samples; ``prev_i``/``prev_q``
    [C]; the bank and RDS taps and tails as for ``fused_frontend_full``.
    Returns ``(fm_delayed, pilot, stereo, carrier, rds_delayed, prev_i,
    prev_q, bank_tail, mono_delay, carrier_tail, rds_delay)``, the streams
    [C, N]; the RDS entries are None without ``rds``.
    """
    args = (i_if, q_if, prev_i, prev_q, h_bank, h_carrier, bank_tail,
            mono_delay, carrier_tail, rds_delay)
    if i_if.device.type == "cpu":
        return fused_frontend_if_plain(*args, rds=rds)
    c, n = i_if.shape
    kb = h_bank.shape[-1]
    if n < kb:
        raise ValueError(f"block of {n} IF samples is shorter than the "
                         f"{kb}-tap band filters")
    dev = i_if.device
    for t, name, shape in ((i_if, "i_if", (c, n)), (q_if, "q_if", (c, n)),
                           (prev_i, "prev_i", (c,)), (prev_q, "prev_q", (c,))):
        kernels.require(t, name, shape, device=dev)
    _require_bands(h_bank, h_carrier, bank_tail, mono_delay, carrier_tail,
                   rds_delay, c, rds, dev)
    kernels.check_smem("frontend", "dy4_frontend_smem", "fused_frontend_if",
                       n, 1, 0, kb, int(rds), 0)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=dev)
    rds_new = lambda *shape: new(*shape) if rds else None  # noqa: E731
    outs = [new(c, n), new(c, n), new(c, n), rds_new(c, n), rds_new(c, n),
            new(c), new(c), new(c, kb - 1), new(c, kb // 2),
            rds_new(c, kb - 1), rds_new(c, kb // 2)]
    ins = (i_if, q_if, h_bank, h_carrier if rds else None, prev_i, prev_q,
           bank_tail, mono_delay, carrier_tail if rds else None,
           rds_delay if rds else None)
    fn = kernels.entry("frontend", "dy4_frontend_if", _IF_ARGS)
    with torch.cuda.device(dev):
        status = fn(*(_ptr(t) for t in ins), *(_ptr(t) for t in outs), c, n,
                    kb, int(rds), kernels.stream_of(i_if))
    kernels.check_launch(status, "frontend fused_frontend_if")
    fused_frontend_if.launches += 1
    return tuple(outs)


fused_frontend_if.launches = 0

"""The front half of the receiver: five CUDA kernels (``csrc/frontend.cu``,
``csrc/frontend_rf.cu``) and their plain torch versions.

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

B1 and B6 run on a grid of (row, time tile): a thread block owns
``_tile_plan``'s tile of IF outputs of one row and recomputes a halo of
samples before it, so every intermediate stream stays in shared memory
and only the block's input and the IF-rate outputs touch device memory
(see the note in ``csrc/frontend.cu``).  They match the plain versions to
float32 tolerance; B1's new ``iq_tail`` and B6's new ``prev_i``/``prev_q``
are exact.

The RF stage alone, dy4tpu's A/B front ends (``front_step(frontend=
"fused-rf" | "fused-phase")``, which leave the band stages to
``band_stages_plain``), is one kernel on B1's RF stage (``csrc/rf_stage.cuh``)
then the demod, on a (row, tile) grid from ``_rf_plan`` (see the note in
``csrc/frontend_rf.cu``), with the contract ``(iq_u8, h, iq_tail, prev_i,
prev_q, decim) -> (fm, iq_tail', prev_i', prev_q')``:

  * ``fused_frontend_raw`` (B11) replaces ``frontend_pallas.py ::
    fused_frontend_raw``: it reads the interleaved u8 row as 16-bit I/Q
    pairs;
  * ``fused_frontend`` (B12) replaces ``frontend_pallas.py ::
    fused_frontend``, which reads 2D interleave/decimation phase planes
    that dy4tpu splits off outside Pallas, a TPU layout: the kernel's
    polyphase window in shared memory is that split, so B12 launches B11's
    kernel on the u8 row itself and no plane is made on the card; it
    keeps the ``(K-1) % D == 0`` check, and its plain version the planes;
  * ``fused_frontend_raw_pm`` (B13) replaces ``frontend_pallas.py ::
    fused_frontend_raw_pm``: the kernel reads the row as 32-bit words
    (``iq_u8.view(torch.int32)``, free), two I/Q pairs a word.  dy4tpu
    does not wire it into ``front_step``; neither does the port.

The three give the same bits as one another, under any plan, and as B1's
I/Q, demod and ``prev_i``/``prev_q`` (B1's ``fm_delayed`` is their fm
delayed by ``Kb // 2``).

dy4tpu's banded tap-parity matrices, its ``split`` window/dot interleave,
``mm_dtype``, ``bc_rows``, ``vmem_limit_bytes`` and its 128-lane geometry
gate are TPU (MXU and VMEM) devices: neither these wrappers nor their plain
versions take them, and every geometry runs.  fm matches the plain versions
to float32 tolerance where the decimated power is not near zero,
``iq_tail`` is exact.

Every wrapper and plain version takes dy4tpu's ``precision=``
(``ops/precision.py``), "highest" by default, the receiver's default (dy4tpu's
direct Pallas entries default to ``mm_dtype=bf16``; the port's wrappers do
not).  Below "highest" the taps are rounded to bf16, and B1 / B6's band
stage rounds fm before the bank and the squared RDS band before the carrier
BPF, as dy4tpu's ``mm_dtype=bf16`` kernels do; the delays and every carried
tail stay float32.  There B1 and B6 run their second design, on the tensor
cores (``csrc/mma_bf16.cuh``): the RF LPF (on the u8 window, exact in bf16),
the bank and the carrier BPF as bf16 ``mma.sync`` Toeplitz products with
float32 sums, under ``_tile_plan(..., bf16=True)``'s plan, the kernel
rounding the taps as it builds its fragments; B11-B13 stay the float32
stage fed taps their wrappers round.
"""

from __future__ import annotations

import ctypes
import typing

import torch
import torch.nn.functional as F

from dy4tpu_torch.ops import demod, fir, iqcorr, mix
from dy4tpu_torch.ops.precision import rounding, rounds, taps
from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

_ARGS = ([ctypes.c_void_p] * 23 + [ctypes.c_longlong] * 2
         + [ctypes.c_int] * 7 + [ctypes.c_void_p])
_CORR_ARGS = ([ctypes.c_void_p] * 27 + [ctypes.c_longlong] * 2
              + [ctypes.c_int] * 7 + [ctypes.c_void_p])
_IF_ARGS = ([ctypes.c_void_p] * 21 + [ctypes.c_longlong]
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_RF_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# the u8 block's way into the RF kernel (csrc/frontend_rf.cu's Source)
_PAIRS, _WORDS = 0, 1


# B1 / B6's tiling (csrc/frontend.cu): IF outputs a tile owns, threads a
# block, window samples the threads hold for an RF pass (rf_stage.cuh's
# kRound: one fetch round)
TILE, THREADS, PASS_SAMPLES = 1536, 256, 20 * 256
# the tensor-core design below "highest" (csrc/mma_bf16.cuh): outputs an
# MMA makes, rows of outputs, window samples a k-step; RF passes of
# TC_UNITS units, one a warp and leg
TC_UNIT, TC_ROW, TC_K, TC_UNITS = 128, 8, 16, THREADS // 32 // 2
# B11-B13's tiling (csrc/frontend_rf.cu): the most IF outputs a tile owns,
# window samples a pass takes (two fetch rounds)
RF_TILE, RF_PASS_SAMPLES = 2048, 2 * PASS_SAMPLES
MOMENTS = len(iqcorr._POWERS)


class TilePlan(typing.NamedTuple):
    """B1 / B6's grid over one row: ``n_tiles`` tiles of ``tile`` IF
    outputs (the last one ragged), each recomputing ``halo`` I/Q samples
    before its first output; B1's RF stage runs in passes of ``sub``
    outputs (0 for B6)."""
    tile: int
    n_tiles: int
    halo: int
    sub: int


class RfPlan(typing.NamedTuple):
    """B11-B13's grid over one row: ``n_tiles`` tiles of ``tile`` IF
    outputs (the last one ragged), each recomputing the I/Q sample before
    its first output; RF passes of ``sub`` outputs."""
    tile: int
    n_tiles: int
    sub: int


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _window_row(n: int) -> int:
    """A window row of ``n`` floats padded to 4 mod 32 (rf_stage.cuh)."""
    return n + (36 - n % 32) % 32


def _phase_taps(decim: int, k_rf: int) -> int:
    """RF taps a polyphase row of B1's window holds, padded to 4."""
    return _round4((k_rf - 1) // decim + 1) if k_rf else 0


def _round_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _ksteps(decim: int, taps: int) -> int:
    """k-steps of a Toeplitz MMA over rows of 8 outputs at ``decim``
    through ``taps`` taps (``tc::ksteps``)."""
    return -(-(7 * decim + taps) // TC_K)


def _tc_halo(kb: int, rds: bool) -> int:
    """The tensor-core design's halo: with RDS the bank starts kb-1
    samples before the tile, rounded down to a multiple of 8 (an MMA
    row), then kb more for the bank's history and the demod."""
    return (_round_to(kb - 1, TC_ROW) if rds else 0) + kb


def _tile_plan(n_out: int, decim: int, k_rf: int, kb: int, rds: bool,
               bf16: bool = False) -> TilePlan:
    """The kernels' plan for rows of ``n_out`` IF samples (``k_rf`` = 0
    for B6).  The halo is what one output needs before it: 2*(kb-1)+1
    with RDS (the carrier BPF over kb-1 RDS-band samples, the bank over
    kb-1 fm samples, the demod one I/Q sample), kb without; a tile is at
    least the halo, so only tile 0 reads the carried state.  B1's RF
    passes split the most RF outputs a tile makes (tile + halo) evenly
    into passes whose window (``sub`` + the phase taps, padded, times
    decim) fits the ``PASS_SAMPLES`` the threads prefetch.

    ``bf16``: the tensor-core design's plan (precision below "highest"),
    a rule: tiles of ``TILE`` (at least the halo, ``_tc_halo``, in rows
    of 8), RF passes of ``TC_UNITS`` MMA units, fewer where the ring of
    two pass windows would overflow the shared memory."""
    if bf16:
        halo = _tc_halo(kb, rds)
        tile = max(TILE, _round_to(halo, TC_ROW))
        sub = 0
        if k_rf:
            sub = TC_UNITS * TC_UNIT
            while sub > TC_UNIT and _smem_bytes(
                    TilePlan(tile, 1, halo, sub), decim, k_rf, kb, rds, True,
                    True) > kernels.SMEM_MAX:
                sub -= TC_UNIT
        return TilePlan(tile, -(-n_out // tile), halo, sub)
    halo = 2 * (kb - 1) + 1 if rds else kb
    tile = max(TILE, _round4(halo))
    n_tiles = -(-n_out // tile)
    sub = 0
    if k_rf:
        # a pass's window row is sub + phase taps, padded by up to 28
        w_max = (PASS_SAMPLES // decim - _phase_taps(decim, k_rf) - 28
                 ) // 4 * 4
        if w_max < 4:
            raise ValueError(f"B1 does not take decimation {decim} with "
                             f"{k_rf} RF taps")
        n_rf = min(n_out, tile) + halo
        passes = -(-n_rf // w_max)
        sub = _round4(-(-n_rf // passes))
    return TilePlan(tile, n_tiles, halo, sub)


def _smem_bytes(plan: TilePlan, decim: int, k_rf: int, kb: int, rds: bool,
                corr: bool, bf16: bool = False) -> int:
    """Shared memory one B1 / B6 block takes: ``dy4_frontend_smem``'s
    formula (``csrc/frontend.cu``), for the plan and the CPU tests."""
    if bf16:
        return _tc_smem_bytes(plan, decim, k_rf, kb, rds, corr)
    kp = _round4(kb)
    nq = _phase_taps(decim, k_rf)
    lp = _window_row(plan.sub + nq)
    taps = (decim * nq if k_rf else 0) + ((3 if rds else 2) + rds) * kp
    l_iq = _round4(plan.tile + plan.halo)
    l_fm = _round4(plan.tile + (kb - 1 if rds else 0)) + kp + 4
    win = 2 * decim * lp if k_rf else 0
    return 4 * (taps + 2 * l_iq + max(win, l_fm)
                + (MOMENTS * THREADS // 32 if corr else 0))


class TcLayout(typing.NamedTuple):
    """The tensor-core design's buffers (``make_geometry`` at bf16): k-steps
    of the RF and band products, floats of the two I/Q buffers, bf16 of
    the carrier BPF's input and of the bank's, bytes of one RF ring
    buffer."""
    ks_rf: int
    ks_b: int
    l_iq: int
    l_q: int
    l_sq: int
    l_fmb: int
    win_bytes: int


def _tc_layout(plan: TilePlan, decim: int, k_rf: int, kb: int,
               rds: bool) -> TcLayout:
    ks_rf = _ksteps(decim, k_rf) if k_rf else 0
    ks_b = _ksteps(1, kb)
    shift = _round_to(kb - 1, TC_ROW) if rds else 0
    l_iq = _round4(plan.tile + plan.halo)
    l_sq = _round_to(_round_to(plan.tile, TC_UNIT) - 8 + TC_K * ks_b, 8)
    win = (plan.sub - 8) * decim + TC_K * ks_rf if k_rf else 0
    return TcLayout(
        ks_rf, ks_b, l_iq, max(l_iq, _round4(-(-l_sq // 2))), l_sq,
        _round_to(_round_to(plan.tile + shift, TC_UNIT) - 8 + TC_K * ks_b,
                  8), _round_to(2 * win + 4, 16))


def _tc_smem_bytes(plan: TilePlan, decim: int, k_rf: int, kb: int,
                   rds: bool, corr: bool) -> int:
    """The tensor-core design's block (``smem_bytes_tc``): the B
    fragments (8 bytes a lane a k-step of each product), the two float32
    I/Q buffers (the second also the bf16 carrier input), the RF ring of
    two u8 pass windows or the bf16 bank input, the moment sums."""
    lay = _tc_layout(plan, decim, k_rf, kb, rds)
    frags = 256 * (lay.ks_rf + ((3 if rds else 2) + rds) * lay.ks_b)
    ring = 2 * lay.win_bytes if k_rf else 0
    return (frags + 4 * (lay.l_iq + lay.l_q) + max(ring, 2 * lay.l_fmb)
            + (4 * MOMENTS * THREADS // 32 if corr else 0))


def _rf_passes(n_rf: int, decim: int, k: int) -> int:
    """Outputs a pass for ``n_rf`` RF outputs: even passes, of whole units
    of 4 outputs, whose window holds at most ``RF_PASS_SAMPLES``, or one
    unit where no such pass has one (a long filter)."""
    w_max = max(4, (RF_PASS_SAMPLES // decim - _phase_taps(decim, k) - 28)
                // 4 * 4)
    return _round4(-(-n_rf // -(-n_rf // w_max)))


def _rf_plan(n_out: int, decim: int, k: int, *, tile: int | None = None,
             sub: int | None = None) -> RfPlan:
    """B11-B13's plan for rows of ``n_out`` IF samples through ``k`` taps
    (``tile`` / ``sub`` pin it).  The row splits evenly into the fewest
    tiles of at most ``RF_TILE`` outputs, a tile's RF outputs (the tile
    and its halo sample) evenly into passes (``_rf_passes``); where the
    block then overflows the shared memory, the tile halves until it fits
    (a tile of one output at the least).  Never raises: a geometry whose
    block cannot fit even so is the wrappers' ``check_smem``'s to refuse,
    and no geometry the first port's block fitted is one."""
    def plan_of(t: int) -> RfPlan:
        return RfPlan(t, -(-n_out // t), sub or _rf_passes(t + 1, decim, k))

    def even(most: int) -> int:       # even tiles of at most `most`
        return -(-n_out // -(-n_out // most))

    if tile is not None:
        return plan_of(tile)
    plan = plan_of(even(RF_TILE))
    while plan.tile > 1 and _rf_smem_bytes(plan, decim, k) > kernels.SMEM_MAX:
        plan = plan_of(even(-(-plan.tile // 2)))
    return plan


def _rf_smem_bytes(plan: RfPlan, decim: int, k: int) -> int:
    """Shared memory one B11-B13 block takes: ``dy4_frontend_rf_smem``'s
    formula (``csrc/frontend_rf.cu``), for the plan and the CPU tests."""
    nq = _phase_taps(decim, k)
    return 4 * (decim * nq + 2 * _round4(plan.tile + 1)
                + 2 * decim * _window_row(plan.sub + nq))


def rf_lpf_plain(iq_u8: Tensor, h_rf: Tensor, iq_tail: Tensor, decim: int,
                 precision: str = "highest"):
    """u8 [..., bs] -> (i_ds, q_ds [..., bs/2/decim], iq_tail): normalize,
    deinterleave, decimating RF LPF on both legs (its taps rounded below
    "highest")."""
    bs = iq_u8.shape[-1]
    x = (iq_u8.to(torch.float32) - 128.0) / 128.0
    iq = x.reshape(*x.shape[:-1], bs // 2, 2).movedim(-1, -2)  # I row 0
    iq_ds, iq_tail = fir.block_fir_decim(iq, taps(h_rf, precision), iq_tail,
                                         decim)
    return iq_ds[..., 0, :], iq_ds[..., 1, :], iq_tail


def band_stages_plain(fm: Tensor, h_bank: Tensor, h_carrier, bank_tail,
                      mono_delay, carrier_tail, rds_delay, *, rds: bool,
                      precision: str = "highest"):
    """The post-demod stages: mono delay, band bank over fm, and (with
    ``rds``) squaring + carrier BPF and the RDS delay.  Below "highest"
    the bank reads fm, its history and its taps rounded to bf16, the
    carrier BPF the squared band, its history and its taps; the delays and
    the new tails are float32.  Returns ``(fm_delayed, pilot, stereo,
    carrier, rds_delayed, new_bank_tail, new_mono_delay, new_carrier_tail,
    new_rds_delay)``, the RDS entries None without ``rds``."""
    rnd = rounding(precision)
    fm_delayed, mono_delay = mix.delay_block(fm, mono_delay)
    bands, _ = fir.block_fir_bank(rnd(fm), taps(h_bank, precision),
                                  rnd(bank_tail))
    bank_tail = fir.tail(fm, h_bank.shape[-1] - 1)
    carrier = rds_delayed = carrier_tail_out = rds_delay_out = None
    if rds:
        rds_band = bands[..., 2, :]
        squared = mix.squaring_nonlinearity(rds_band)
        carrier, _ = fir.block_fir(rnd(squared), taps(h_carrier, precision),
                                   rnd(carrier_tail))
        carrier_tail_out = fir.tail(squared, h_carrier.shape[-1] - 1)
        rds_delayed, rds_delay_out = mix.delay_block(rds_band, rds_delay)
    return (fm_delayed, bands[..., 0, :], bands[..., 1, :], carrier,
            rds_delayed, bank_tail, mono_delay, carrier_tail_out,
            rds_delay_out)


def fused_frontend_full_plain(iq_u8, h_rf, h_bank, h_carrier, iq_tail,
                              prev_i, prev_q, bank_tail, mono_delay,
                              carrier_tail, rds_delay, decim: int, *,
                              rds: bool = True, corr=None,
                              precision: str = "highest"):
    """Plain torch version of ``fused_frontend_full`` (any leading batch
    dims, any device): the RF LPF; with ``corr`` [..., 4] the moments of
    the decimated I/Q (``iqcorr.moments``) and the correction
    (``iqcorr.apply``), as dy4tpu's stock ``front_step(corr=...,
    corr_moments=True)``; then ``fused_frontend_if_plain``.  Returns B1's
    outputs, and ``mom`` last with ``corr``."""
    i_ds, q_ds, iq_tail = rf_lpf_plain(iq_u8, h_rf, iq_tail, decim,
                                       precision)
    mom = ()
    if corr is not None:
        mom = (iqcorr.moments(i_ds, q_ds),)
        i_ds, q_ds = iqcorr.apply(i_ds, q_ds,
                                  iqcorr.IQCorrCoeffs(*corr.unbind(-1)))
    outs = fused_frontend_if_plain(i_ds, q_ds, prev_i, prev_q, h_bank,
                                   h_carrier, bank_tail, mono_delay,
                                   carrier_tail, rds_delay, rds=rds,
                                   precision=precision)
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


def _launch_full(args, decim: int, rds: bool, corr=None,
                 precision: str = "highest"):
    """Check the inputs and launch B1 (with the corr epilogue when ``corr``
    is given) at ``precision``.  ``args``: the eleven tensors of
    ``fused_frontend_full``.  Returns the twelve outputs, and ``mom``
    [C, 14] as a thirteenth with ``corr``."""
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
    bf16 = rounds(precision)
    plan = _tile_plan(n_out, decim, k, kb, rds, bf16)
    kernels.check_smem("frontend", "dy4_frontend_smem",
                       "fused_frontend_full", plan.tile, plan.sub, decim, k,
                       kb, int(rds), int(with_corr), int(bf16))
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=dev)
    rds_new = lambda *shape: new(*shape) if rds else None  # noqa: E731
    outs = [new(c, n_out), new(c, n_out), new(c, n_out), rds_new(c, n_out),
            rds_new(c, n_out), new(c, 2, k - 1), new(c), new(c),
            new(c, kb - 1), new(c, kb // 2), rds_new(c, kb - 1),
            rds_new(c, kb // 2)]
    if not rds:
        args = args[:3] + (None,) + args[4:9] + (None, None)
    # below "highest" the kernel rounds the taps itself (its B fragments)
    ptrs = [_ptr(t) for t in (*args, *outs)]
    if with_corr:
        mom = new(c, MOMENTS)
        partial = new(c, plan.n_tiles, MOMENTS)       # per-tile sums
        count = torch.empty(c, dtype=torch.int32, device=dev)
        fn = kernels.entry("frontend", "dy4_frontend_full_corr", _CORR_ARGS)
        ptrs += [corr.data_ptr(), mom.data_ptr(), partial.data_ptr(),
                 count.data_ptr()]
    else:
        fn = kernels.entry("frontend", "dy4_frontend_full", _ARGS)
    with torch.cuda.device(dev):
        status = fn(*ptrs, c, bs, decim, k, kb, int(rds), int(bf16),
                    plan.tile, plan.sub, kernels.stream_of(iq_u8))
    kernels.check_launch(status, "frontend fused_frontend_full")
    return (*outs, mom) if with_corr else tuple(outs)


def fused_frontend_full(iq_u8, h_rf, h_bank, h_carrier, iq_tail, prev_i,
                        prev_q, bank_tail, mono_delay, carrier_tail,
                        rds_delay, decim: int, *, rds: bool = True,
                        corr=None, precision: str = "highest"):
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

    ``precision``: "highest" (default), "high" or "default"
    (``ops/precision.py``; the module docstring says what it rounds).

    Launches are counted per variant: ``fused_frontend_full.launches``
    for the stock kernel, ``fused_frontend_full.corr.launches`` for the
    corr variant.
    """
    args = (iq_u8, h_rf, h_bank, h_carrier, iq_tail, prev_i, prev_q,
            bank_tail, mono_delay, carrier_tail, rds_delay)
    if iq_u8.device.type == "cpu":
        return fused_frontend_full_plain(*args, decim, rds=rds, corr=corr,
                                         precision=precision)
    outs = _launch_full(args, decim, rds, corr, precision)
    (fused_frontend_full if corr is None
     else fused_frontend_full.corr).launches += 1
    return outs


fused_frontend_full.launches = 0
fused_frontend_full.corr = kernels.Variant("fused_frontend_full[corr]")


def fused_frontend_if_plain(i_if, q_if, prev_i, prev_q, h_bank, h_carrier,
                            bank_tail, mono_delay, carrier_tail, rds_delay,
                            *, rds: bool = True, precision: str = "highest"):
    """Plain torch version of ``fused_frontend_if`` (any leading batch
    dims, any device): the demod, then ``band_stages_plain``."""
    fm, prev_i, prev_q = demod.fm_demod_diff(i_if, q_if, prev_i, prev_q)
    (fmd, pilot, stereo, carrier, rdsdel, bank_tail, mono_delay,
     carrier_tail, rds_delay) = band_stages_plain(
        fm, h_bank, h_carrier, bank_tail, mono_delay, carrier_tail,
        rds_delay, rds=rds, precision=precision)
    return (fmd, pilot, stereo, carrier, rdsdel, prev_i, prev_q, bank_tail,
            mono_delay, carrier_tail, rds_delay)


def fused_frontend_if(i_if, q_if, prev_i, prev_q, h_bank, h_carrier,
                      bank_tail, mono_delay, carrier_tail, rds_delay, *,
                      rds: bool = True, precision: str = "highest"):
    """The IF-entry front half of one block: the kernel for CUDA tensors,
    the plain version for CPU ones.

    ``i_if``/``q_if`` [C, N] float32 IF samples; ``prev_i``/``prev_q``
    [C]; the bank and RDS taps and tails as for ``fused_frontend_full``.
    Returns ``(fm_delayed, pilot, stereo, carrier, rds_delayed, prev_i,
    prev_q, bank_tail, mono_delay, carrier_tail, rds_delay)``, the streams
    [C, N]; the RDS entries are None without ``rds``.  ``precision`` as
    for ``fused_frontend_full``.
    """
    args = (i_if, q_if, prev_i, prev_q, h_bank, h_carrier, bank_tail,
            mono_delay, carrier_tail, rds_delay)
    if i_if.device.type == "cpu":
        return fused_frontend_if_plain(*args, rds=rds, precision=precision)
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
    bf16 = rounds(precision)
    plan = _tile_plan(n, 1, 0, kb, rds, bf16)
    kernels.check_smem("frontend", "dy4_frontend_smem", "fused_frontend_if",
                       plan.tile, 0, 1, 0, kb, int(rds), 0, int(bf16))
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
                    kb, int(rds), int(bf16), plan.tile,
                    kernels.stream_of(i_if))
    kernels.check_launch(status, "frontend fused_frontend_if")
    fused_frontend_if.launches += 1
    return tuple(outs)


fused_frontend_if.launches = 0


def fused_frontend_raw_plain(iq_u8, h, iq_tail, prev_i, prev_q, decim: int,
                             precision: str = "highest"):
    """Plain torch version of B11 (any leading batch dims, any device):
    ``rf_lpf_plain`` then ``demod.fm_demod_diff``.  Returns ``(fm,
    iq_tail, prev_i, prev_q)``."""
    i_ds, q_ds, iq_tail = rf_lpf_plain(iq_u8, h, iq_tail, decim, precision)
    fm, prev_i, prev_q = demod.fm_demod_diff(i_ds, q_ds, prev_i, prev_q)
    return fm, iq_tail, prev_i, prev_q


def phase_planes(iq_u8: Tensor, decim: int) -> Tensor:
    """u8 [C, bs] -> the interleave/decimation phase planes x20 [2D, C,
    bs/2/D] u8: plane ``2r + leg`` holds decimation phase r of leg ``leg``
    (``frontend_pallas.py:1009-1010``)."""
    c, bs = iq_u8.shape
    return iq_u8.reshape(c, bs // (2 * decim), 2 * decim).permute(2, 0, 1)


def fused_frontend_plain(iq_u8, h, iq_tail, prev_i, prev_q, decim: int,
                         precision: str = "highest"):
    """Plain torch version of B12 (``iq_u8`` [C, bs], any device): the
    phase planes, each phase of each leg extended by its tail phase
    (``iq_tail.reshape(C, 2, S/D, D)``), then the decimating LPF as one
    correlation that sums over the D phases, tap ``q*D + r`` of phase r
    being ``h[S - q*D - r]``; then the demod.  Needs ``(K-1) % D == 0``.
    Returns ``(fm, iq_tail, prev_i, prev_q)``."""
    c, bs = iq_u8.shape
    k = h.shape[0]
    s = k - 1
    _require_phase_aligned(k, decim)
    h = taps(h, precision)
    x = (phase_planes(iq_u8, decim).to(torch.float32) - 128.0) / 128.0
    planes = x.reshape(decim, 2, c, -1).permute(2, 1, 0, 3)  # [C, 2, D, M]
    tail_ph = iq_tail.reshape(c, 2, s // decim, decim).movedim(-1, -2)
    ext = torch.cat([tail_ph, planes], dim=-1)      # [C, 2, D, S/D + M]
    q = torch.arange(s // decim + 1, device=h.device)
    r = torch.arange(decim, device=h.device)
    a = q[None, :] * decim + r[:, None]             # [D, Q]: a = qD + r
    rows = torch.where(a <= s, h[(s - a).clamp(min=0)], 0.0)
    fir._no_tf32(x)
    y = F.conv1d(ext.reshape(c * 2, decim, -1), rows[None])
    y = y.reshape(c, 2, -1)
    fm, prev_i, prev_q = demod.fm_demod_diff(y[:, 0], y[:, 1], prev_i,
                                             prev_q)
    new_tail = ((iq_u8[:, bs - 2 * s:].to(torch.float32) - 128.0) / 128.0
                ).reshape(c, s, 2).movedim(-1, -2)
    return fm, new_tail, prev_i, prev_q


def fused_frontend_raw_pm_plain(iq_u8, h, iq_tail, prev_i, prev_q,
                                decim: int, precision: str = "highest"):
    """Plain torch version of B13 (``iq_u8`` [C, bs], ``bs % 4 == 0``, any
    device): the row as int32 words, each word's four bytes taken apart
    (little-endian: bytes 0 and 2 are I, 1 and 3 are Q), then B11's plain
    version.  Returns ``(fm, iq_tail, prev_i, prev_q)``."""
    words = _words(iq_u8)
    parts = [(words >> (8 * b)) & 0xFF for b in range(4)]
    raw = torch.stack(parts, dim=-1).reshape(iq_u8.shape).to(torch.uint8)
    return fused_frontend_raw_plain(raw, h, iq_tail, prev_i, prev_q, decim,
                                    precision)


def _require_phase_aligned(k: int, decim: int) -> None:
    if (k - 1) % decim:
        raise ValueError(f"the phase-split front end needs phase-aligned "
                         f"taps ((taps-1) % decim == 0; taps={k}, "
                         f"decim={decim})")


def _words(iq_u8: Tensor) -> Tensor:
    """``iq_u8`` [C, bs] as int32 words [C, bs/4] (a view)."""
    if iq_u8.shape[-1] % 4 or not iq_u8.is_contiguous():
        raise ValueError(f"the word front end needs contiguous rows of a "
                         f"multiple of 4 bytes, got {tuple(iq_u8.shape)}")
    return iq_u8.view(torch.int32)


def _launch_rf(source: int, iq_u8: Tensor, h, iq_tail, prev_i, prev_q,
               decim: int, what: str, plan: RfPlan | None = None,
               precision: str = "highest"):
    """Check the inputs and launch the RF kernel on ``iq_u8``'s rows, read
    as 16-bit pairs (``_PAIRS``) or 32-bit words (``_WORDS``), under
    ``plan`` (``_rf_plan``'s by default), its taps rounded below "highest".
    Counts no launch.  Returns ``(fm, iq_tail, prev_i, prev_q)``."""
    c, bs = iq_u8.shape
    k = h.shape[0]
    n_out = bs // 2 // decim
    if bs % (2 * decim) or n_out < 1 or bs // 2 < k - 1:
        raise ValueError(f"{what}: block of {bs} bytes does not decimate by "
                         f"{decim}, or holds fewer than the {k - 1} samples "
                         f"of the RF tail")
    dev = iq_u8.device
    kernels.require(iq_u8, "iq_u8", (c, bs), torch.uint8, dev)
    for t, name, shape in ((h, "h", (k,)), (iq_tail, "iq_tail", (c, 2, k - 1)),
                           (prev_i, "prev_i", (c,)), (prev_q, "prev_q", (c,))):
        kernels.require(t, name, shape, device=dev)
    if plan is None:
        plan = _rf_plan(n_out, decim, k)
    kernels.check_smem("frontend_rf", "dy4_frontend_rf_smem", what,
                       plan.tile, plan.sub, decim, k)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=dev)
    outs = (new(c, n_out), new(c, 2, k - 1), new(c), new(c))
    h = taps(h, precision)
    fn = kernels.entry("frontend_rf", "dy4_frontend_rf", _RF_ARGS)
    with torch.cuda.device(dev):
        status = fn(source, iq_u8.data_ptr(), h.data_ptr(),
                    iq_tail.data_ptr(), prev_i.data_ptr(), prev_q.data_ptr(),
                    *(o.data_ptr() for o in outs), c, bs, decim, k,
                    plan.tile, plan.sub, kernels.stream_of(iq_u8))
    kernels.check_launch(status, what)
    return outs


def fused_frontend_raw(iq_u8, h, iq_tail, prev_i, prev_q, decim: int,
                       precision: str = "highest"):
    """B11, the RF stage from the interleaved u8 rows: the kernel for CUDA
    tensors, ``fused_frontend_raw_plain`` for CPU ones.

    ``iq_u8`` [C, bs] uint8; ``h`` [K]; ``iq_tail`` [C, 2, K-1];
    ``prev_i``/``prev_q`` [C]; all float32 and contiguous.  Returns ``(fm
    [C, bs/2/decim], iq_tail, prev_i, prev_q)``.  ``precision``: "highest"
    (default), "high" or "default", which round the taps to bf16."""
    if iq_u8.device.type == "cpu":
        return fused_frontend_raw_plain(iq_u8, h, iq_tail, prev_i, prev_q,
                                        decim, precision)
    outs = _launch_rf(_PAIRS, iq_u8, h, iq_tail, prev_i, prev_q, decim,
                      "fused_frontend_raw", precision=precision)
    fused_frontend_raw.launches += 1
    return outs


fused_frontend_raw.launches = 0


def fused_frontend(iq_u8, h, iq_tail, prev_i, prev_q, decim: int,
                   precision: str = "highest"):
    """B12, the RF stage of the phase-split front end: the kernel for CUDA
    tensors, ``fused_frontend_plain`` (the phase planes) for CPU ones; the
    contract of ``fused_frontend_raw``, with ``(K-1) % decim == 0``.  On
    the card it launches B11's kernel on the u8 rows themselves: no phase
    plane is made (see ``csrc/frontend_rf.cu``)."""
    if iq_u8.device.type == "cpu":
        return fused_frontend_plain(iq_u8, h, iq_tail, prev_i, prev_q, decim,
                                    precision)
    _require_phase_aligned(h.shape[0], decim)
    outs = _launch_rf(_PAIRS, iq_u8, h, iq_tail, prev_i, prev_q, decim,
                      "fused_frontend", precision=precision)
    fused_frontend.launches += 1
    return outs


fused_frontend.launches = 0


def fused_frontend_raw_pm(iq_u8, h, iq_tail, prev_i, prev_q, decim: int,
                          precision: str = "highest"):
    """B13, the RF stage from the rows as 32-bit words: the kernel for
    CUDA tensors, ``fused_frontend_raw_pm_plain`` for CPU ones; the
    contract of ``fused_frontend_raw``, with ``bs % 4 == 0``.  On no
    receiver route (as in dy4tpu): called directly."""
    if iq_u8.device.type == "cpu":
        return fused_frontend_raw_pm_plain(iq_u8, h, iq_tail, prev_i, prev_q,
                                           decim, precision)
    kernels.require(iq_u8, "iq_u8", iq_u8.shape, torch.uint8, iq_u8.device)
    _words(iq_u8)       # the kernel reads this view: bs % 4 == 0
    outs = _launch_rf(_WORDS, iq_u8, h, iq_tail, prev_i, prev_q, decim,
                      "fused_frontend_raw_pm", precision=precision)
    fused_frontend_raw_pm.launches += 1
    return outs


fused_frontend_raw_pm.launches = 0

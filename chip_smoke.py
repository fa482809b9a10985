"""Chip smoke of the PyTorch / CUDA port (``dy4tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's receiver on the card through its nine hand-written CUDA
kernels, in all four modes, through the IF entry, with the opt-in span PLL
and IQ tracker, through the wideband channelizer front door, and through
the receiver's command line:

0. requires a CUDA device; prints torch/CUDA versions and the card's name
   and power limit; turns TF32 off (the receiver is float32 throughout);
1. builds the kernels from ``dy4tpu_torch/csrc`` with nvcc;
2. per mode, holds each kernel of the mode's path against its plain torch
   version at that mode's shapes (C=512 channels, one 32 ms block) on the
   synthesized broadcast, mid-stream, over all rows, and times both with
   CUDA events.  Each channel takes the broadcast from its own offset (I/Q
   swapped on odd channels), so every row of every input, tail and carry
   differs.  The PLL must be bitwise equal; the others within 1e-5, with
   the carried tails exact.  The IF-entry front end (B6) is checked at
   mode 0 (RDS) and mode 1 (no RDS), on IF I/Q made from the u8 stream by
   the plain RF LPF; so are the span PLL's scan (B9, bitwise, on span
   targets of the broadcast with a dead span in every row) and B1 with
   the IQ tracker's corr epilogue (per-row coefficients from a seed; the
   moments within a relative 1e-5), mid-stream and on block 0 from a cold
   state (there elementwise within 1e-5 plus the demod's conditioning);
3. per mode, runs ``run_blocks`` over 24 blocks x 512 channels, checks
   that every kernel of the mode's path ran on every block (and no other
   kernel ran), decodes channel 0 (stereo separation, and RDS PI/PS in
   modes 0 and 2), compares four channels with an all-plain run over the
   first blocks, and times the chain.  At modes 0 and 1 it also runs the
   IF entry (``receiver_step_if``) over the same 24 blocks as IF I/Q, with
   the same checks, and holds it against the RF entry's kernel run; and
   it runs the chain with ``pll_span=8`` (B9 on every block, B2 on none)
   and with the IQ tracker (B1's corr variant on every block; at mode 0
   on a capture through test_iqcorr.py's tuner fault, whose parameters
   channel 0's tracker must read back and whose uncorrected decode must
   lose separation; at mode 1 on the clean broadcast, where it must read
   the identity), decoding channel 0 in both, and at mode 0 times span 8
   against span 1 (medians of 5);
4. the wideband front door at mode 0: phase 2 holds the channelizer kernel
   (B7) against its plain version at six bank geometries on 32 distinct
   band rows, and ``channelize_block_u8``'s kernel route (folded IQ
   correction) against its plain route (post-bank correction); phase 3
   runs ``run_wideband_blocks`` over 32 bands x 16 channels x 32 steps of
   ``bench.py``'s wideband capture (band b starts 74*b bytes in), checks
   that B7, B6, B2, B3 and B4 launched on every step and nothing else did,
   decodes channel 3 of bands 0 and 31, checks the RSSI scan, holds that
   channel of both bands to an all-plain run, and times the chain; phase
   3b runs AFC and the IQ tracker on 4 bands x 8 steps against the
   all-plain run;
5. phase 4, the CLI on the card: ``python -m dy4tpu_torch 0 sr --iqcorr
   --stereo-blend --deemphasis us --rds-json ... --stats`` over a 200-block
   mode-0 capture through the tuner fault, as a subprocess: PCM length,
   PI/PS in the JSON events, the real-time factor; then the same run cut
   by ``--checkpoint`` at 100 blocks and finished by ``--resume``, whose
   PCM must equal the uninterrupted run's.

Prints one JSON line of per-kernel results (one entry per kernel and
geometry: its error against the plain version, its time and the plain
version's, its launches on the main path, and its bound: the larger of
the bytes it must move over 3.35 TB/s and its float32 operations over 67
TFLOP/s; phase 2 also prints an estimate of the serial PLL scans'
dependency-chain floor), then, as its last line, ``{"ok": true, "device":
{...}}``.  Any failure raises
(nonzero exit); without a CUDA device it exits nonzero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

C = 512          # channels: the serving batch of one card
N_BLOCKS = 24    # 0.77 s of stream at mode 0; PS needs 24 blocks to decode
N_CHAIN_CHECK = {0: 4, 1: 3, 2: 3, 3: 3}   # blocks held to an all-plain run
CHAIN_ROWS = [0, 1, C // 2, C - 1]   # held against an all-plain run
SHIFT = 74       # bytes (37 complex samples) between neighbouring channels
CHAIN_TOL = 5e-2                     # audio and baseband, kernel vs plain
SYM_AGREE = 0.99                     # share of equal RDS symbols
B6_MODES = (0, 1)                    # IF-entry kernel checked at these
WB_C, WB_T = 16, 12                  # the wideband bench point: 16 channels
WB_BANDS, WB_STEPS = 32, 32          # ... x 32 bands (512 stations) x 32
WB_STATION = 3                       # the live channel of every band
WB_ROWS = [0, WB_BANDS - 1]          # bands decoded and held to all-plain
WB_GEOMS = ((16, 12), (8, 12), (32, 12), (4, 16), (64, 12), (128, 12))
WB_OPT_BANDS, WB_OPT_STEPS = 4, 8    # AFC + IQ tracker, kernel vs plain
AFC_TOL_HZ = 1000.0                  # on-grid station: |AFC estimate|
OPT_MODES = (0, 1)                   # span PLL (B9) and IQ tracker (B1 corr)
SPAN = 8                             # the span PLL's samples per update
FAULT = dict(dc_i=0.12, dc_q=-0.08, iq_gain=0.7, iq_phase_deg=25.0)
RATE_REPS = 5                        # chain rate: median of this many runs
CLI_BLOCKS, CLI_SPLIT = 200, 100     # phase 4: blocks, checkpoint point
HBM_BYTES_S = 3.35e12                # H100 SXM device memory, bytes/s
FP32_FLOP_S = 67e12                  # H100 SXM float32 outside tensor cores
FP32_LATENCY = 4                     # cycles from one dependent float op
# float operations per PLL step, counted in csrc/pll.cu's loop bodies:
# all of them (B2 17; B9 18 with k*integ), and those on the loop-carried
# chain pe -> pe (13 in both: ph, v's sub and add, the wrap's mul, floor,
# mul and two subs, kps*err, the two adds into p, the two wraps).  The
# compares and selects are not counted, so the chain floor they give is
# an estimate from below.
B2_STEP_OPS, B9_STEP_OPS, PLL_CHAIN_OPS = 17, 18, 13
U32 = 2.0 ** -24        # float32 unit roundoff
MOM_TOL = 1e-5         # tracker moments, relative to E[|i|^p |q|^r]
# the tracker's readout against the fault (test_iqcorr.py's bars) and the
# separation it must win back (test_e2e_stereo_recovery's)
TRACK_TOL_DC, TRACK_TOL_SHAPE, TRACK_GAIN_DB = 5e-3, 2e-2, 8.0
REPO = Path(__file__).resolve().parent


def _say(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch
    fn()                                        # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _max_err(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b) if x is not None)


def _channels(stream, cfg, dev):
    """[N_BLOCKS, C, block_size] u8 on ``dev``: channel c is the broadcast
    from byte ``SHIFT * c`` on, with I and Q swapped on odd channels, so
    that no two rows of any kernel's inputs, tails or carries are equal.
    Channel 0 is the broadcast itself.  ``stream``: [N_BLOCKS + 1,
    block_size] u8, the spare block covering the largest shift."""
    import torch
    flat = torch.from_numpy(stream.ravel()).to(dev)
    n = N_BLOCKS * cfg.block_size
    assert SHIFT * (C - 1) <= flat.numel() - n
    blocks = torch.empty(N_BLOCKS, C, cfg.block_size, dtype=torch.uint8,
                         device=dev)
    for c in range(C):
        blocks[:, c] = flat[SHIFT * c:SHIFT * c + n].view(N_BLOCKS, -1)
    odd = blocks[:, 1::2].view(N_BLOCKS, C // 2, -1, 2)
    blocks[:, 1::2] = odd.flip(-1).reshape(N_BLOCKS, C // 2, -1)
    return blocks


def _distinct_rows(name: str, *tensors) -> None:
    """Raise unless every two neighbouring rows (dim 0) of each tensor
    differ: a kernel that reads or writes the wrong row must not pass."""
    for t in tensors:
        if t is None:
            continue
        r = t.reshape(t.shape[0], -1)
        if not bool((r[1:] != r[:-1]).any(dim=1).all()):
            raise AssertionError(f"{name}: inputs with equal neighbouring "
                                 f"rows cannot show a row fault")


def _nbytes(*tensors) -> int:
    """Bytes of every tensor given (tuples and lists are walked; None is
    skipped): the inputs read once and the outputs written once."""
    n = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            n += _nbytes(*t)
        elif t is not None:
            n += t.numel() * t.element_size()
    return n


@functools.lru_cache(maxsize=1)
def _max_sm_clock_hz() -> float:
    """The card's maximum SM clock as ``nvidia-smi`` reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return float(out) * 1e6


@dataclasses.dataclass
class _Row:
    """One kernel checked at one geometry: what the JSON line reports.
    The plain version is timed by ``plain`` or, where it was timed by its
    comparison call, given as ``plain_ms``.  ``nbytes`` and ``flops`` are
    the work of this call (its bound); ``chain_steps`` the length of a
    serial recurrence (its dependency-chain floor, an estimate printed
    beside the bound and not put in the JSON line); ``library`` one
    PyTorch call that computes the same function, timed as a yardstick
    and used nowhere in the port; ``extra`` more keys for the JSON."""
    kernel: str
    geometry: str
    source: str
    replaces: str
    wrapper: Callable
    err: float
    tol: float
    kern: Callable
    plain: Optional[Callable] = None
    plain_ms: Optional[float] = None
    where: str = f"C={C}"
    nbytes: int = 0
    flops: float = 0.0
    chain_steps: int = 0
    library: Optional[Callable] = None
    extra: dict = dataclasses.field(default_factory=dict)

    def finish(self, smi: str, mode: int) -> dict:
        if not self.err <= self.tol:
            raise AssertionError(f"{self.kernel} ({self.geometry}): max "
                                 f"|kernel - plain| {self.err:.3g} above "
                                 f"the tolerance {self.tol:g}")
        if not (self.nbytes > 0 and self.flops > 0):
            raise AssertionError(f"{self.kernel}: no bytes or operations "
                                 f"for its bound")
        ms = _time_ms(self.kern, 20)
        plain_ms = (self.plain_ms if self.plain is None
                    else _time_ms(self.plain, 5))
        library_ms = (None if self.library is None
                      else _time_ms(self.library, 20))
        by_bytes = self.nbytes / HBM_BYTES_S * 1e3
        by_ops = self.flops / FP32_FLOP_S * 1e3
        bound_ms = max(by_bytes, by_ops)
        bound_by = "bytes" if by_bytes >= by_ops else "operations"
        note = ""
        if self.chain_steps:
            chain_ms = (self.chain_steps * PLL_CHAIN_OPS * FP32_LATENCY
                        / _max_sm_clock_hz() * 1e3)
            note = (f", dependency chain about {chain_ms:.4f} ms (an "
                    f"estimate: {self.chain_steps} steps x {PLL_CHAIN_OPS} "
                    f"dependent float ops x {FP32_LATENCY} cycles at "
                    f"{_max_sm_clock_hz() / 1e6:.0f} MHz)")
        _say(f"phase 2: {self.kernel} {self.geometry}: max |kernel - "
             f"plain| {self.err:.3g} (tolerance {self.tol:g}); kernel "
             f"{ms:.4f} ms, plain {plain_ms:.4f} ms"
             + ("" if library_ms is None else f", library {library_ms:.4f} "
                "ms") + f"; bound {bound_ms:.4f} ms by {bound_by} "
             f"({self.nbytes / 1e6:.1f} MB, {self.flops / 1e9:.2f} GFLOP)"
             f"{note} at {self.where} ({smi})")
        return dict(name=f"{self.kernel.split()[1]}:{self.geometry}",
                    route="cuda", source=self.source,
                    replaces=self.replaces, max_abs_err=self.err,
                    tolerance=self.tol, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms, mode=mode, wrapper=self.wrapper,
                    **self.extra)


def _front_flops(cfg, c: int, rds: bool, rf: bool, corr: bool = False):
    """Float operations of the front half per block: per IF sample the RF
    LPF on both legs (``rf``), the demod (about 9), the band bank and,
    with RDS, squaring and the carrier BPF; ``corr`` adds the 14 moments
    and the correction (about 30)."""
    kb = cfg.num_taps
    per = 9 + (3 if rds else 2) * kb * 2
    if rds:
        per += 1 + kb * 2
    if rf:
        per += 2 * cfg.num_taps * 2
    if corr:
        per += 30
    return c * cfg.if_per_block * per


def _front_corr_pair(label, fargs, corr, rds):
    """B1's corr variant and its plain version on ``fargs`` (the eleven
    tensors and the decimation of ``fused_frontend_full``); raises unless
    the new RF tails are equal.  Returns both output tuples."""
    import torch
    from dy4tpu_torch.ops import frontend_cuda
    k_out = frontend_cuda.fused_frontend_full(*fargs, rds=rds, corr=corr)
    p_out = frontend_cuda.fused_frontend_full_plain(*fargs, rds=rds,
                                                    corr=corr)
    torch.cuda.synchronize()
    if not torch.equal(k_out[5], p_out[5]):
        raise AssertionError(f"{label}: iq_tail differs from the plain "
                             f"version")
    return k_out, p_out


def _moments_rel_err(label, blk, params, cfg, iq_tail, k_mom, p_mom):
    """The tracker moments against a relative ``MOM_TOL`` of the mean
    magnitude of their terms, E[|i|^p |q|^r]: the scale of a float32
    sum's rounding (a moment near 0 has no scale of its own).  Raises
    beyond it; returns the largest relative departure."""
    import torch
    from dy4tpu_torch.ops import frontend_cuda, iqcorr
    i_ds, q_ds, _ = frontend_cuda.rf_lpf_plain(blk, params.rf_coeff,
                                               iq_tail, cfg.rf_decim)
    scale = torch.stack([
        (i_ds.double().abs() ** p * q_ds.double().abs() ** r).mean(-1)
        for p, r in iqcorr._POWERS], dim=-1)
    rel = float(((k_mom.double() - p_mom.double()).abs() / scale).max())
    _say(f"phase 2: {label}: moments [{C}, 14] within a relative {rel:.3g} "
         f"of the plain version's (tolerance {MOM_TOL:g})")
    if not rel <= MOM_TOL:
        raise AssertionError(f"{label}: moments depart from the plain "
                             f"version by a relative {rel:.3g}")
    return rel


def _check_corr_cold(cfg, params, blk, corr, dev) -> float:
    """B1's corr variant against its plain version on block 0 from a cold
    state (every tail and carry zero): the CLI's first block.

    The RF LPF starts from a zero tail, so the first IF samples ramp up
    from 0, and on the way the correction takes some rows' I/Q close to
    the origin.  There the demod, fm = (q i' - i q') / |z|^2, turns the
    float32 rounding of the I/Q (the kernel and the plain version sum the
    RF taps in other orders) into errors far above 1e-5.  So each stream
    is held elementwise to 1e-5 plus the demod's first-order error for I/Q
    that differ by at most the two routes' float32 rounding bounds,

        eta[m] = 2 (K + 4) u (1 + |rho|) max(1, |s|)
                 (A_i[m] + A_q[m] + |dc_i| + |dc_q|),
        |d fm[m]| <= 2 sqrt(2) max(eta[m-1], eta[m])
                     (|z[m-1]| + |z[m]| + 2 |fm[m]| |z[m]|) / |z[m]|^2,

    (K RF taps and the correction's four operations, u the float32 unit
    roundoff, A = sum_j |h_j| |x_j| the RF LPF's absolute sum on each
    leg), carried through the band filters by their absolute taps, with
    A, z, fm and the RDS band from a float64 route.  The tails (the block's last
    samples, far from the ramp) within 1e-5, the RF tail exact, the
    moments as mid-stream.  Returns the largest |kernel - plain| over the
    streams."""
    import torch
    from dy4tpu_torch.ops import demod, fir, iqcorr
    from dy4tpu_torch.pipeline import receiver as rx

    rds = cfg.supports_rds
    label = f"B1 corr mode{cfg.mode} cold start"
    fs = rx.front_state_of(rx.init_state(cfg, (C,), device=dev))
    fargs = (blk, params.rf_coeff, params.bank_coeff,
             params.rds_carrier_coeff, fs.rf.iq_tail, fs.rf.prev_i,
             fs.rf.prev_q, fs.bank_tail, fs.mono_delay, fs.carrier_tail,
             fs.rds_delay, cfg.rf_decim)
    k_out, p_out = _front_corr_pair(label, fargs, corr, rds)
    _moments_rel_err(label, blk, params, cfg, fs.rf.iq_tail, k_out[12],
                     p_out[12])
    tails = _max_err(k_out[6:12], p_out[6:12])
    if not tails <= 1e-5:
        raise AssertionError(f"{label}: tails depart from the plain version "
                             f"by {tails:.3g}")

    # the float64 route: corrected I/Q, fm, the RDS band; the rounding
    # bound eta of the corrected I/Q
    f64 = lambda t: t.double()  # noqa: E731
    prev = lambda t: torch.cat([torch.zeros_like(t[:, :1]),  # noqa: E731
                                t[:, :-1]], -1)    # zero before a cold start
    x = ((blk.double() - 128.0) / 128.0).reshape(C, -1, 2).movedim(-1, -2)
    h_rf = f64(params.rf_coeff)
    iq_ds, _ = fir.block_fir_decim(x, h_rf, f64(fs.rf.iq_tail),
                                   cfg.rf_decim)
    a_abs, _ = fir.block_fir_decim(x.abs(), h_rf.abs(), f64(fs.rf.iq_tail),
                                   cfg.rf_decim)
    dc_i, dc_q, rho, sc = (c[:, None] for c in f64(corr).unbind(-1))
    eta = (2 * (h_rf.numel() + 4) * U32 * (1 + rho.abs())
           * sc.abs().clamp(min=1.0)
           * (a_abs.sum(1) + dc_i.abs() + dc_q.abs()))
    zi, zq = iqcorr.apply(iq_ds[:, 0], iq_ds[:, 1], iqcorr.IQCorrCoeffs(
        dc_i[:, 0], dc_q[:, 0], rho[:, 0], sc[:, 0]))
    fm, _, _ = demod.fm_demod_diff(zi, zq, f64(fs.rf.prev_i),
                                   f64(fs.rf.prev_q))
    mag = torch.hypot(zi, zq)
    power = mag * mag
    ex_fm = torch.where(
        power > 0, 2 * 2 ** 0.5 * torch.maximum(prev(eta), eta)
        * (prev(mag) + mag + 2 * fm.abs() * mag) / power,
        torch.full_like(power, 1e6)).clamp(max=1e6)
    kb = params.bank_coeff.shape[-1]
    dly = kb // 2
    zero = torch.zeros(C, kb - 1, dtype=torch.float64, device=dev)
    through = lambda e, h: fir.block_fir(e, f64(h).abs(), zero)[0]  # noqa: E731
    delayed = lambda t: torch.cat([torch.zeros_like(t[:, :dly]),  # noqa: E731
                                   t[:, :-dly]], -1)   # cold delay lines
    excess = {"fm_delayed": delayed(ex_fm),
              "pilot": through(ex_fm, params.bank_coeff[0]),
              "stereo_band": through(ex_fm, params.bank_coeff[1])}
    if rds:
        ex_rb = through(ex_fm, params.bank_coeff[2])
        rb = fir.block_fir(fm, f64(params.bank_coeff[2]), zero)[0]
        excess["carrier"] = through(2 * rb.abs() * ex_rb + ex_rb ** 2,
                                    params.rds_carrier_coeff)
        excess["rds_delayed"] = delayed(ex_rb)

    worst, report = 0.0, []
    for name, k, p in zip(rx.FrontOut._fields, k_out[:5], p_out[:5]):
        if k is None:
            continue
        err = (k.double() - p.double()).abs()
        ratio = err / (1e-5 + excess[name])
        r, m = divmod(int(err.argmax()), err.shape[-1])
        worst = max(worst, float(err.max()))
        report.append(f"{name} {float(err.max()):.3g} (row {r}, sample {m}; "
                      f"at most {float(ratio.max()):.3g} of its tolerance)")
        if not float(ratio.max()) <= 1.0:
            raise AssertionError(f"{label}: {name} departs from the plain "
                                 f"version beyond its tolerance: {report}")
    # where the demod is worst conditioned, and both float32 routes
    # against the float64 one there
    err = (k_out[0].double() - p_out[0].double()).abs()
    r, m = divmod(int(err.argmax()), err.shape[-1])
    ref = delayed(fm)
    _say(f"phase 2: {label}: max |kernel - plain| " + "; ".join(report)
         + f"; at the worst fm_delayed sample the corrected |z|^2 is "
         f"{float(power[r, m - dly]) if m >= dly else 0.0:.3g} (median "
         f"{float(power.median()):.3g}); against a float64 route, max "
         f"|err| of fm_delayed: kernel "
         f"{float((k_out[0].double() - ref).abs().max()):.3g}, plain "
         f"{float((p_out[0].double() - ref).abs().max()):.3g}; tails "
         f"{tails:.3g}")
    return worst


def _check_kernels(cfg, params, blocks, dev, smi) -> list[dict]:
    """Phase 2 at one mode: every kernel of the mode's path against its
    plain version on block 1, mid-stream, at C=512.  Returns the JSON
    entries."""
    import numpy as np
    import torch
    from dy4tpu_torch.ops import (backend_cuda, frontend_cuda, pll, pll_cuda,
                                  resample_cuda)
    from dy4tpu_torch.pipeline import receiver as rx

    rds = cfg.supports_rds
    mode = f"mode{cfg.mode}"
    # block 0 brings every tail and carry mid-stream: all plain at mode 0
    # (as first written), through the kernels at modes 1-3 (the plain PLL
    # costs seconds per block)
    kw = (dict(frontend="plain", backend="plain", pll_impl="plain")
          if cfg.mode == 0 else {})
    st, _ = rx.receiver_step(params, rx.init_state(cfg, (C,), device=dev),
                             blocks[0], cfg, **kw)
    blk = blocks[1]
    rows = []

    fs = rx.front_state_of(st)
    cont = lambda t: None if t is None else t.contiguous()  # noqa: E731
    fargs = (blk, params.rf_coeff, params.bank_coeff,
             params.rds_carrier_coeff, *(cont(t) for t in (
                 fs.rf.iq_tail, fs.rf.prev_i, fs.rf.prev_q, fs.bank_tail,
                 fs.mono_delay, fs.carrier_tail, fs.rds_delay)),
             cfg.rf_decim)
    _distinct_rows("B1", *fargs[:1], *fargs[4:11])
    k_out = frontend_cuda.fused_frontend_full(*fargs, rds=rds)
    p_out = frontend_cuda.fused_frontend_full_plain(*fargs, rds=rds)
    torch.cuda.synchronize()
    if not torch.equal(k_out[5], p_out[5]):
        raise AssertionError(f"B1 {mode} iq_tail differs from the plain "
                             f"version")
    # 1e-5: float32 sums in another order; a TF32 tap sum misses it by far
    rows.append(_Row(
        "B1 frontend", f"{mode} decim {cfg.rf_decim} rds={rds}",
        "dy4tpu_torch/csrc/frontend.cu", "dy4tpu/ops/frontend_pallas.py:693",
        frontend_cuda.fused_frontend_full, _max_err(k_out, p_out), 1e-5,
        lambda: frontend_cuda.fused_frontend_full(*fargs, rds=rds),
        lambda: frontend_cuda.fused_frontend_full_plain(*fargs, rds=rds),
        nbytes=_nbytes(fargs[:11] if rds else fargs[:3] + fargs[4:9],
                       k_out),
        flops=_front_flops(cfg, C, rds, rf=True)))
    fmd, pilot, stereo, carrier, rdsdel = (cont(t) for t in p_out[:5])

    if cfg.mode in OPT_MODES:
        # B1 with the IQ tracker's epilogue: per-row coefficients
        g = np.random.default_rng(cfg.mode)
        corr = torch.from_numpy(np.stack(
            [g.uniform(-0.05, 0.05, C), g.uniform(-0.05, 0.05, C),
             g.uniform(-0.2, 0.2, C), g.uniform(0.8, 1.2, C)],
            axis=-1).astype(np.float32)).to(dev)
        _distinct_rows("B1 corr", corr)
        k_out, p_out = _front_corr_pair(f"B1 corr {mode}", fargs, corr, rds)
        mom_rel = _moments_rel_err(f"B1 corr {mode}", blk, params, cfg,
                                   fs.rf.iq_tail, k_out[12], p_out[12])
        cold = _check_corr_cold(cfg, params, blocks[0], corr, dev)
        rows.append(_Row(
            "B1 frontend_corr", f"{mode} decim {cfg.rf_decim} rds={rds}",
            "dy4tpu_torch/csrc/frontend.cu",
            "dy4tpu/ops/frontend_pallas.py:693",
            frontend_cuda.fused_frontend_full.corr,
            _max_err(k_out[:12], p_out[:12]), 1e-5,
            lambda: frontend_cuda.fused_frontend_full(*fargs, rds=rds,
                                                      corr=corr),
            lambda: frontend_cuda.fused_frontend_full_plain(
                *fargs, rds=rds, corr=corr),
            nbytes=_nbytes(fargs[:11] if rds else fargs[:3] + fargs[4:9],
                           corr, k_out),
            flops=_front_flops(cfg, C, rds, rf=True, corr=True),
            extra=dict(mom_rel_err=mom_rel, cold_max_abs_err=cold)))
        del k_out, p_out

    if cfg.mode in B6_MODES:
        # the IF entry on the same block: IF I/Q by the plain RF LPF,
        # carried from block 0's RF tail
        i_if, q_if, _ = frontend_cuda.rf_lpf_plain(
            blk, params.rf_coeff, fs.rf.iq_tail, cfg.rf_decim)
        iargs = (i_if.contiguous(), q_if.contiguous(), *fargs[5:7],
                 params.bank_coeff, params.rds_carrier_coeff, *fargs[7:11])
        _distinct_rows("B6", *iargs[:4], *iargs[6:])
        k_out = frontend_cuda.fused_frontend_if(*iargs, rds=rds)
        p_out = frontend_cuda.fused_frontend_if_plain(*iargs, rds=rds)
        torch.cuda.synchronize()
        if not (torch.equal(k_out[5], p_out[5])
                and torch.equal(k_out[6], p_out[6])):
            raise AssertionError(f"B6 {mode} prev_i/prev_q differ from the "
                                 f"plain version")
        rows.append(_Row(
            "B6 frontend_if", f"{mode} rds={rds}",
            "dy4tpu_torch/csrc/frontend.cu",
            "dy4tpu/ops/frontend_pallas.py:881",
            frontend_cuda.fused_frontend_if, _max_err(k_out, p_out), 1e-5,
            lambda: frontend_cuda.fused_frontend_if(*iargs, rds=rds),
            lambda: frontend_cuda.fused_frontend_if_plain(*iargs, rds=rds),
            nbytes=_nbytes(iargs if rds else iargs[:5] + iargs[6:8], k_out),
            flops=_front_flops(cfg, C, rds, rf=False)))

    # the NCO angle runs free of the data, equal on every row: draw it
    draw = np.random.default_rng(0)
    if rds:
        x = torch.stack([pilot, carrier], dim=-2).contiguous()
        lanes = dict(
            freq=np.array([cfg.pll_freq, cfg.rds_pll_freq], np.float32),
            nco_scale=np.array([cfg.pll_nco_scale, cfg.rds_pll_nco_scale],
                               np.float32),
            norm_bandwidth=np.array([cfg.pll_bandwidth,
                                     cfg.rds_pll_bandwidth], np.float32))
        state = pll.PLLState(*(torch.stack([a, b], dim=-1) for a, b in
                               zip(st.audio.pll, st.rds.pll)))
        angle_shape = (C, 2)
    else:
        x = pilot
        lanes = dict(freq=cfg.pll_freq, nco_scale=cfg.pll_nco_scale,
                     norm_bandwidth=cfg.pll_bandwidth)
        state = st.audio.pll
        angle_shape = (C,)
    consts = pll._loop_consts(lanes["freq"], cfg.if_fs,
                              lanes["norm_bandwidth"])
    kp, ki, dth = (torch.as_tensor(v, device=dev) for v in consts)
    angle = torch.from_numpy(draw.uniform(0.0, 4 * np.pi, angle_shape)
                             .astype(np.float32)).to(dev)
    carry = (state.integrator.contiguous(), state.phase_est.contiguous(),
             angle)
    _distinct_rows("B2", x, *carry)
    k_phi, k_c = pll_cuda.phase_scan(x, kp, ki, dth, carry)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    p_phi, p_c = pll_cuda.phase_scan_plain(x, kp, ki, dth, carry)
    stop.record()
    torch.cuda.synchronize()
    plain_pll_ms = start.elapsed_time(stop)
    if not (torch.equal(k_phi, p_phi)
            and all(torch.equal(a, b) for a, b in zip(k_c, p_c))):
        raise AssertionError(f"B2 {mode} PLL is not bitwise equal to its "
                             f"plain version: max |dphi| "
                             f"{_max_err([k_phi], [p_phi])}")
    # the plain scan is a Python loop of launches (seconds per call): its
    # time is the comparison call above
    rows.append(_Row(
        "B2 pll", f"{mode} {list(x.shape)}", "dy4tpu_torch/csrc/pll.cu",
        "dy4tpu/ops/pll_pallas.py:278", pll_cuda.phase_scan,
        _max_err((k_phi, *k_c), (p_phi, *p_c)), 0.0,
        lambda: pll_cuda.phase_scan(x, kp, ki, dth, carry),
        plain_ms=plain_pll_ms,
        nbytes=_nbytes(x, kp, ki, dth, carry, k_phi, k_c),
        flops=B2_STEP_OPS * x.numel(), chain_steps=x.shape[-1]))
    del k_phi, p_phi

    if cfg.mode in OPT_MODES:
        # B9: the span PLL's scan over the broadcast's span targets, with
        # the span constants and a dead (NaN) span in every row
        _, *eff = pll._span_consts(*consts, SPAN)
        kp_s, ki_s, dth_s = (torch.as_tensor(v, device=dev) for v in eff)
        targets = pll._span_targets(x, dth, SPAN).contiguous()
        m = targets.shape[-1]
        rows_c = torch.arange(C, device=dev)
        targets[rows_c, ..., rows_c % m] = float("nan")
        _distinct_rows("B9", torch.nan_to_num(targets, nan=9.0), *carry)
        k_res = pll_cuda.phase_scan_target(targets, kp_s, ki_s, dth_s, carry,
                                           span=SPAN)
        torch.cuda.synchronize()
        start.record()
        p_res = pll_cuda.phase_scan_target_plain(targets, kp_s, ki_s, dth_s,
                                                 carry, span=SPAN)
        stop.record()
        torch.cuda.synchronize()
        k_flat = (k_res[0], k_res[1], *k_res[2])
        p_flat = (p_res[0], p_res[1], *p_res[2])
        if not all(torch.equal(a, b) for a, b in zip(k_flat, p_flat)):
            raise AssertionError(f"B9 {mode} span PLL is not bitwise equal "
                                 f"to its plain version: max |dphi0| "
                                 f"{_max_err(k_flat, p_flat)}")
        rows.append(_Row(
            "B9 pll_span", f"{mode} {list(targets.shape)} span {SPAN}",
            "dy4tpu_torch/csrc/pll.cu", "dy4tpu/ops/pll_pallas.py:278",
            pll_cuda.phase_scan_target, _max_err(k_flat, p_flat), 0.0,
            lambda: pll_cuda.phase_scan_target(targets, kp_s, ki_s, dth_s,
                                               carry, span=SPAN),
            plain_ms=start.elapsed_time(stop),
            nbytes=_nbytes(targets, kp_s, ki_s, dth_s, carry, k_flat),
            flops=B9_STEP_OPS * targets.numel(), chain_steps=m))
        del k_res, p_res, k_flat, p_flat

    nco_i2, nco_q2, _ = pll.pll(x, state, fs=cfg.if_fs, impl="kernel",
                                **lanes)
    if rds:
        nco = nco_i2[:, 0].contiguous()
        nco_i = nco_i2[:, 1].contiguous()
        nco_q = nco_q2[:, 1].contiguous()
    else:
        nco = nco_i2.contiguous()
    bs = rx.back_state_of(st)
    if cfg.audio_up == 1:
        aargs = (fmd, stereo, nco, params.audio_coeff,
                 bs.mono_tail.contiguous(), bs.stereo_tail.contiguous(),
                 cfg.audio_down)
        wrap = backend_cuda.fused_audio_backend
        plain = backend_cuda.fused_audio_backend_plain
        name = ("B3 audio_backend", f"{mode} D={cfg.audio_down}",
                "dy4tpu_torch/csrc/audio_backend.cu",
                "dy4tpu/ops/backend_pallas.py:93")
    else:
        aargs = (fmd, stereo, nco, params.audio_coeff,
                 bs.mono_tail.contiguous(), bs.stereo_tail.contiguous(),
                 cfg.audio_up, cfg.audio_down)
        wrap = resample_cuda.fused_audio_backend_rational
        plain = resample_cuda.fused_audio_backend_rational_plain
        name = ("B5 audio_rational",
                f"{mode} {cfg.audio_up}/{cfg.audio_down}",
                "dy4tpu_torch/csrc/audio_rational.cu",
                "dy4tpu/ops/resample_pallas.py:173")
    _distinct_rows(name[0], *aargs[:3], *aargs[4:6])
    k_out = wrap(*aargs)
    p_out = plain(*aargs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k_out[3:], p_out[3:])):
        raise AssertionError(f"{name[0]} {mode}: tails differ from the "
                             f"plain version")
    n, n_out = cfg.if_per_block, cfg.audio_per_block
    per_out = -(-params.audio_coeff.numel() // cfg.audio_up)  # taps visited
    rows.append(_Row(*name, wrap, _max_err(k_out, p_out), 1e-5,
                     lambda: wrap(*aargs), lambda: plain(*aargs),
                     nbytes=_nbytes(aargs[:6], k_out),
                     flops=C * (2 * n + 2 * n_out * per_out * 2
                                + 2 * n_out)))
    del k_out, p_out

    if rds:
        rargs = (rdsdel, nco_i, nco_q, params.rds_lpf_coeff,
                 params.rds_rrc_coeff, bs.lpf_tail_i.contiguous(),
                 bs.lpf_tail_q.contiguous(), bs.rrc_tail_i.contiguous(),
                 bs.rrc_tail_q.contiguous(), cfg.rds_up, cfg.rds_down)
        _distinct_rows("B4", *rargs[:3], *rargs[5:9])
        k_out = resample_cuda.fused_rds_backend(*rargs)
        p_out = resample_cuda.fused_rds_backend_plain(*rargs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k_out[2:4],
                                                     p_out[2:4])):
            raise AssertionError(f"B4 {mode}: LPF tails differ from the "
                                 f"plain version")
        n_rds = cfg.rds_per_block
        per_out = -(-params.rds_lpf_coeff.numel() // cfg.rds_up)
        rows.append(_Row(
            "B4 rds_backend", f"{mode} {cfg.rds_up}/{cfg.rds_down}",
            "dy4tpu_torch/csrc/rds_backend.cu",
            "dy4tpu/ops/resample_pallas.py:275",
            resample_cuda.fused_rds_backend, _max_err(k_out, p_out), 1e-5,
            lambda: resample_cuda.fused_rds_backend(*rargs),
            lambda: resample_cuda.fused_rds_backend_plain(*rargs),
            nbytes=_nbytes(rargs[:9], k_out),
            flops=C * (2 * cfg.if_per_block + 2 * n_rds * per_out * 2
                       + 2 * n_rds * params.rds_rrc_coeff.numel() * 2)))

    return [r.finish(smi, cfg.mode) for r in rows]


def _path(cfg, entry: str = "rf", span: bool = False, corr: bool = False):
    """The kernel wrappers a mode's main path launches: ``entry`` "rf"
    (``receiver_step``), "if" (``receiver_step_if``) or "wideband"
    (``wideband_step``: the channelizer, then the IF entry); ``span``
    (the span PLL: B9 for B2) and ``corr`` (the IQ tracker: B1's corr
    variant for B1) are the opt-in features of the RF entry."""
    from dy4tpu_torch.ops import (backend_cuda, channelizer_cuda,
                                  frontend_cuda, pll_cuda, resample_cuda)
    if entry == "rf":
        front = (frontend_cuda.fused_frontend_full.corr if corr
                 else frontend_cuda.fused_frontend_full)
    else:
        front = frontend_cuda.fused_frontend_if
    audio = (backend_cuda.fused_audio_backend if cfg.audio_up == 1
             else resample_cuda.fused_audio_backend_rational)
    pll_kernel = (pll_cuda.phase_scan_target if span
                  else pll_cuda.phase_scan)
    path = [front, pll_kernel, audio]
    if cfg.supports_rds:
        path.append(resample_cuda.fused_rds_backend)
    if entry == "wideband":
        path.insert(0, channelizer_cuda.channelize_branches)
    return path


def _run_path(label, cfg, run, all_wrappers, entry="rf",
              n_blocks=N_BLOCKS, **features):
    """Zero every launch count, ``run()``, and check that each kernel of
    the path (``_path(cfg, entry, **features)``) launched on every one of
    ``n_blocks`` blocks and no other kernel launched.  Returns ``(run's
    result, {wrapper: launches})``."""
    import torch
    for w in all_wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {w: w.launches for w in all_wrappers}
    path = _path(cfg, entry, **features)
    for w, n in counts.items():
        if w in path and n < n_blocks:
            raise AssertionError(f"{label}: kernel {w.__name__} launched "
                                 f"{n} times over {n_blocks} blocks")
        if w not in path and n:
            raise AssertionError(f"{label}: kernel {w.__name__} is not on "
                                 f"this path but launched {n} times")
    _say(f"phase 3: {label}: launches " + ", ".join(
        f"{w.__name__} {n}" for w, n in counts.items() if w in path)
        + f" ({secs:.2f} s, first run)")
    return out, counts


def _check_outputs(label, cfg, outs) -> dict:
    """Shapes, finiteness, and the decode bars on channel 0.  Returns
    ``fm.check_reception``'s measures."""
    import torch
    from dy4tpu_torch.tx import fm

    shapes = {"mono": cfg.audio_per_block, "left": cfg.audio_per_block,
              "right": cfg.audio_per_block}
    if cfg.supports_rds:
        shapes.update(rds_bb_i=cfg.rds_per_block, rds_bb_q=cfg.rds_per_block,
                      rds_symbols=cfg.rds_symbols_per_block)
    for name, n in shapes.items():
        got_shape = tuple(getattr(outs, name).shape)
        if got_shape != (N_BLOCKS, C, n):
            raise AssertionError(f"{label} {name}: shape {got_shape}, "
                                 f"expected {(N_BLOCKS, C, n)}")
    for f in outs:
        if f is not None and f.is_floating_point() and not bool(
                torch.isfinite(f).all()):
            raise AssertionError(f"{label}: non-finite receiver output")
    rds = cfg.supports_rds
    got = fm.check_reception(
        cfg, outs.left[:, 0].cpu().numpy(), outs.right[:, 0].cpu().numpy(),
        outs.rds_symbols[:, 0].cpu().numpy() if rds else None,
        outs.rds_resync[:, 0].cpu().numpy() if rds else None)
    _say(f"phase 3: {label}: channel 0 decoded: separation L "
         f"{got['sep_l_db']:.1f} dB, R {got['sep_r_db']:.1f} dB"
         + (f", PI {got['pi']}, PS {got['ps']!r} ({got['groups']} groups)"
            if rds else ""))
    return got


def _compare_chain(label, cfg, outs, ref, n_blocks,
                   rows=f"channels {CHAIN_ROWS}") -> None:
    """Hold ``outs`` (the rows named by ``rows``, first ``n_blocks``) to
    ``ref`` within the chain tolerances."""
    fields = ["mono", "left", "right"]
    if cfg.supports_rds:
        fields += ["rds_bb_i", "rds_bb_q"]
    errs = {f: _max_err([getattr(outs, f)[:n_blocks]],
                        [getattr(ref, f)[:n_blocks]]) for f in fields}
    msg = ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
    sym_agree = 1.0
    if cfg.supports_rds:
        sym_agree = float((outs.rds_symbols[:n_blocks]
                           == ref.rds_symbols[:n_blocks]).double().mean())
        msg += f"; RDS symbols agree {sym_agree:.4f}"
    _say(f"phase 3: {label}, {rows}, blocks 0-{n_blocks - 1}: max |err| "
         f"{msg}")
    if max(errs.values()) > CHAIN_TOL or sym_agree < SYM_AGREE:
        raise AssertionError(f"{label}: departs beyond the chain "
                             f"tolerance ({CHAIN_TOL:g} on audio and "
                             f"baseband, {SYM_AGREE:.0%} of RDS symbols)")


def _select(outs, sel):
    from dy4tpu_torch.pipeline import receiver as rx
    return rx.StepOutputs(*(None if f is None else f[:, sel] for f in outs))


def _chain_rate(label, cfg, run, t0, smi) -> None:
    """Time a second, warm ``run()`` and print the chain rate."""
    import torch
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    msps = N_BLOCKS * C * cfg.iq_per_block / wall / 1e6
    _say(f"phase 3: {label}: chain {msps:.1f} MS/s complex IQ, "
         f"{msps / (cfg.rf_fs / 1e6):.0f}x real time at "
         f"{cfg.rf_fs / 1e6:g} MS/s per channel ({N_BLOCKS} blocks x {C} "
         f"channels in {wall:.3f} s, kernels, after warm-up); peak device "
         f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
         f"{time.perf_counter() - t0:.1f} s on {smi}")


def _median_rate(cfg, run) -> float:
    """Chain MS/s of complex IQ: the median of ``RATE_REPS`` warm runs of
    ``run()`` over the N_BLOCKS x C batch (host clock, synchronized)."""
    import torch
    rates = []
    for _ in range(RATE_REPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rates.append(N_BLOCKS * C * cfg.iq_per_block
                     / (time.perf_counter() - t1) / 1e6)
    return sorted(rates)[len(rates) // 2]


def _run_options(cfg, params, blocks, dev, smi, all_wrappers) -> dict:
    """Phase 3 of the opt-in features at one mode: the chain with the span
    PLL (B9 on every block, B2 on none) and with the IQ tracker (B1's corr
    variant on every block, plain B1 on none), channel 0 decoded in both;
    at mode 0 the tracker runs on the broadcast through ``FAULT`` and the
    span chain is timed against span 1; channel 0's tracker must read
    the fault back at mode 0 (and win back separation the same capture
    loses without it), the identity on the clean broadcast at mode 1.
    Returns {wrapper: launches} of B9 and of B1's corr variant."""
    import numpy as np
    from dy4tpu_torch.ops import frontend_cuda, iqcorr, pll_cuda
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.tx import fm

    t0 = time.perf_counter()
    label = f"mode {cfg.mode} span PLL (pll_span={SPAN})"
    state = rx.init_state(cfg, (C,), device=dev)
    (_, outs), counts = _run_path(
        label, cfg, lambda: rx.run_blocks(params, state, blocks, cfg,
                                          pll_span=SPAN),
        all_wrappers, span=True)
    _check_outputs(label, cfg, outs)
    del outs
    launches = {pll_cuda.phase_scan_target:
                counts[pll_cuda.phase_scan_target]}
    if cfg.mode == 0:
        rate = {span: _median_rate(cfg, lambda sp=span: rx.run_blocks(
            params, state, blocks, cfg, pll_span=sp)) for span in (1, SPAN)}
        _say(f"phase 3: mode 0 chain, median of {RATE_REPS}: span 1 "
             f"{rate[1]:.1f} MS/s, span {SPAN} {rate[SPAN]:.1f} MS/s "
             f"({rate[SPAN] / rate[1]:.3f}x; {N_BLOCKS} blocks x {C} "
             f"channels, kernels, after warm-up) on {smi}")

    label = f"mode {cfg.mode} IQ tracker"
    if cfg.mode == 0:
        # the tracker's own case: the broadcast through a faulted tuner
        tblocks = _channels(fm.stereo_rds_broadcast(cfg, N_BLOCKS + 1,
                                                    **FAULT), cfg, dev)
        label += " on the broadcast through " + ", ".join(
            f"{k}={v}" for k, v in FAULT.items())
    else:
        tblocks = blocks
    state = rx.init_state(cfg, (C,), with_iqcorr=True, device=dev)
    (st, outs), counts = _run_path(
        label, cfg, lambda: rx.run_blocks(params, state, tblocks, cfg),
        all_wrappers, corr=True)
    fixed = _check_outputs(label, cfg, outs)
    del outs
    c0 = iqcorr.coeffs(iqcorr.IQCorrState(m=st.iqcorr.m[:1],
                                          count=st.iqcorr.count[:1]))
    got = {k: float(v[0]) for k, v in zip(c0._fields, c0)}
    if cfg.mode == 0:
        # channel 0's readout against the fault, in the units of the
        # decimated I/Q: the u8 scale and the RF LPF's DC gain carry the
        # offsets; rho = g sin(phi), s = 1 / (g cos(phi))
        dc = (fm.U8_AMPLITUDE / 128.0
              * float(params.rf_coeff.double().sum()))
        phi = np.deg2rad(FAULT["iq_phase_deg"])
        want = dict(dc_i=FAULT["dc_i"] * dc, dc_q=FAULT["dc_q"] * dc,
                    rho=FAULT["iq_gain"] * np.sin(phi),
                    s=1.0 / (FAULT["iq_gain"] * np.cos(phi)))
        tol = dict(dc_i=TRACK_TOL_DC, dc_q=TRACK_TOL_DC,
                   rho=TRACK_TOL_SHAPE, s=TRACK_TOL_SHAPE)
        # the same capture without the tracker: the fault costs separation
        _, raw = rx.run_blocks(params, rx.init_state(cfg, (C,), device=dev),
                               tblocks, cfg)
        dirty = min(fm.stereo_separation_db(
            cfg, raw.left[:, 0].cpu().numpy(),
            raw.right[:, 0].cpu().numpy()))
        del raw
        gain = min(fixed["sep_l_db"], fixed["sep_r_db"]) - dirty
    else:
        # the clean broadcast: every component in its deadband, exactly
        want = dict(dc_i=0.0, dc_q=0.0, rho=0.0, s=1.0)
        tol = dict.fromkeys(want, 0.0)
    del tblocks
    _say(f"phase 3: {label}: channel 0 tracker after {N_BLOCKS} blocks: "
         + ", ".join(f"{k} {got[k]:.4f} (expected {want[k]:.4f} within "
                     f"{tol[k]:g})" for k in want)
         + ("" if cfg.mode else
            f"; without the tracker channel 0 separates {dirty:.1f} dB, "
            f"{gain:.1f} dB less (at least {TRACK_GAIN_DB:g})")
         + f"; {time.perf_counter() - t0:.1f} s for the feature runs")
    off = [k for k in want if not abs(got[k] - want[k]) <= tol[k]]
    if off:
        raise AssertionError(f"{label}: the tracker reads {off} off the "
                             f"expected values: {got} against {want}")
    if cfg.mode == 0 and not gain >= TRACK_GAIN_DB:
        raise AssertionError(f"{label}: the tracker wins back {gain:.1f} dB "
                             f"of separation, under {TRACK_GAIN_DB:g}")
    launches[frontend_cuda.fused_frontend_full.corr] = counts[
        frontend_cuda.fused_frontend_full.corr]
    return launches


def _run_mode(mode, dev, smi, all_wrappers) -> list[dict]:
    """Phases 2 and 3 at one mode (and the IF entry where B6 is checked).
    Returns the mode's JSON entries, each with the launches of the run
    whose path holds its kernel."""
    import torch
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import frontend_cuda
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.tx import fm

    cfg = get_mode(mode)
    torch.cuda.reset_peak_memory_stats()
    params = rx.make_params(cfg, device=dev)
    t0 = time.perf_counter()
    blocks = _channels(fm.stereo_rds_broadcast(cfg, N_BLOCKS + 1), cfg, dev)
    _say(f"setup mode {mode}: synthesized {N_BLOCKS} blocks, spread to "
         f"{tuple(blocks.shape)} u8 on the card "
         f"({blocks.numel() / 1e9:.2f} GB; channel c starts {SHIFT}*c "
         f"bytes in, odd channels I/Q swapped) in "
         f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    results = _check_kernels(cfg, params, blocks, dev, smi)
    _say(f"phase 2 mode {mode}: {len(results)} kernel checks in "
         f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    label = f"mode {mode}"
    state = rx.init_state(cfg, (C,), device=dev)
    (_, outs), counts = _run_path(
        label, cfg, lambda: rx.run_blocks(params, state, blocks, cfg),
        all_wrappers)
    for r in results:
        if r["wrapper"] in _path(cfg):
            r["launches"] = counts[r["wrapper"]]
    _check_outputs(label, cfg, outs)
    sel = torch.tensor(CHAIN_ROWS, device=dev)
    n_check = N_CHAIN_CHECK[mode]
    _, ref = rx.run_blocks(
        params, rx.init_state(cfg, (len(CHAIN_ROWS),), device=dev),
        blocks[:n_check, sel].contiguous(), cfg, frontend="plain",
        backend="plain", pll_impl="plain")
    rf_kept = _select(outs, sel)
    _compare_chain(f"{label}: kernel path vs all-plain path", cfg, rf_kept,
                   ref, n_check)
    del outs, ref
    _chain_rate(label, cfg, lambda: rx.run_blocks(params, state, blocks,
                                                  cfg), t0, smi)
    if mode in B6_MODES:
        count = _run_if_entry(cfg, params, blocks, rf_kept, dev, smi,
                              all_wrappers)
        for r in results:
            if r["wrapper"] is frontend_cuda.fused_frontend_if:
                r["launches"] = count
    if mode in OPT_MODES:
        counts = _run_options(cfg, params, blocks, dev, smi, all_wrappers)
        for r in results:
            if r["wrapper"] in counts:
                r["launches"] = counts[r["wrapper"]]
    return results


def _run_if_entry(cfg, params, blocks, rf_kept, dev, smi,
                  all_wrappers) -> int:
    """Phase 3 of the IF entry: ``receiver_step_if`` over IF I/Q made from
    the same u8 blocks, held to the RF entry's kernel run.  Returns B6's
    launches."""
    import torch
    from dy4tpu_torch.ops import frontend_cuda
    from dy4tpu_torch.pipeline import receiver as rx

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # set-up, untimed: each channel's IF I/Q by the plain RF LPF, its tail
    # carried across the blocks
    tail = torch.zeros(C, 2, cfg.num_taps - 1, device=dev)
    i_if = torch.empty(N_BLOCKS, C, cfg.if_per_block, device=dev)
    q_if = torch.empty_like(i_if)
    for b in range(N_BLOCKS):
        i_if[b], q_if[b], tail = frontend_cuda.rf_lpf_plain(
            blocks[b], params.rf_coeff, tail, cfg.rf_decim)
    _say(f"setup IF entry mode {cfg.mode}: {N_BLOCKS} blocks of IF I/Q "
         f"{tuple(i_if.shape)} float32 by the plain RF LPF in "
         f"{time.perf_counter() - t0:.1f} s")

    def run():
        st = rx.init_state(cfg, (C,), device=dev)
        outs = []
        for b in range(N_BLOCKS):
            st, out = rx.receiver_step_if(params, st, i_if[b], q_if[b], cfg)
            outs.append(out)
        return rx.StepOutputs(*(None if f[0] is None else torch.stack(f)
                                for f in zip(*outs)))

    t0 = time.perf_counter()
    label = f"IF entry mode {cfg.mode}"
    outs, counts = _run_path(label, cfg, run, all_wrappers, entry="if")
    _check_outputs(label, cfg, outs)
    sel = torch.tensor(CHAIN_ROWS, device=dev)
    kept = _select(outs, sel)
    del outs
    _compare_chain(f"{label}: IF entry vs RF entry (kernels)", cfg, kept,
                   rf_kept, N_CHAIN_CHECK[cfg.mode])
    fields = [f for f in ("mono", "left", "right", "rds_bb_i", "rds_bb_q")
              if getattr(kept, f) is not None]
    every = max(_max_err([getattr(kept, f)], [getattr(rf_kept, f)])
                for f in fields)
    _say(f"phase 3: {label}: over all {N_BLOCKS} blocks max |err| "
         f"{every:.3g} against the RF entry (information)")
    _chain_rate(label + " (IQ counted at the RF rate)", cfg, run, t0, smi)
    return counts[frontend_cuda.fused_frontend_if]


def _branch_conv1d(x, p, ti, tq):
    """The yardstick of B7: the same branch FIRs as one grouped
    ``conv1d`` (2C groups of T taps) on the normalized, tail-extended
    input laid out channels-first (prepared here, outside the timed
    call).  Returns the call; the port never makes it."""
    import torch
    import torch.nn.functional as F
    c, t = p.shape
    m = x.shape[-1] // (2 * c)
    ext = torch.cat([torch.stack([ti, tq], dim=-1).reshape(x.shape[0], -1),
                     (x.to(torch.float32) - 128.0) / 128.0], dim=-1)
    seg = ext[:, : (m + t - 1) * 2 * c].reshape(x.shape[0], m + t - 1, 2 * c)
    seg = seg.transpose(1, 2).contiguous()            # [bands, 2C, m+T-1]
    weight = torch.repeat_interleave(p.flip(0), 2, dim=0).flip(1)[:, None]
    return lambda: F.conv1d(seg, weight.contiguous(), groups=2 * c)


def _check_channelizer(cfg, dev, smi) -> list[dict]:
    """Phase 2 of the wideband front door: B7 against its plain version at
    every geometry of ``WB_GEOMS`` on 32 band rows of mode 0's block,
    mid-stream (random u8 rows and tails from a seed), and the kernel
    route of ``channelize_block_u8`` against its plain route with a
    per-band IQ correction.  Returns the JSON entries."""
    import torch
    from dy4tpu_torch.ops import channelizer as chz
    from dy4tpu_torch.ops import channelizer_cuda as chc
    from dy4tpu_torch.ops import iqcorr

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for c, t in WB_GEOMS:
        p = chz.make_channelizer(c, cfg.if_fs, taps_per_branch=t,
                                 device=dev).p
        n2 = 2 * c * cfg.if_per_block
        x = torch.randint(0, 256, (WB_BANDS, n2), generator=gen,
                          device=dev, dtype=torch.uint8)
        ti, tq = (torch.randn(WB_BANDS, c * t - 1, generator=gen,
                              device=dev) for _ in range(2))
        args = (x, p, ti, tq)
        _distinct_rows("B7", x, ti, tq)
        k_out = chc.channelize_branches(*args)
        p_out = chc.channelize_branches_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k_out[1:], p_out[1:])):
            raise AssertionError(f"B7 C={c} T={t}: tails differ from the "
                                 f"plain version")
        # 1e-5: T float32 products summed in the same order, maybe fused
        conv = _branch_conv1d(*args[:1], p, ti, tq)
        w_conv = conv().transpose(1, 2)
        conv_err = _max_err([w_conv], [p_out[0]])
        if not conv_err <= 1e-5:
            raise AssertionError(f"B7 C={c} T={t}: the conv1d yardstick "
                                 f"departs by {conv_err:.3g}")
        del w_conv
        rows.append(_Row(
            "B7 channelizer", f"C={c} T={t}",
            "dy4tpu_torch/csrc/channelizer.cu",
            "dy4tpu/ops/channelizer.py:344", chc.channelize_branches,
            _max_err(k_out, p_out), 1e-5,
            lambda a=args: chc.channelize_branches(*a),
            lambda a=args: chc.channelize_branches_plain(*a),
            where=f"{WB_BANDS} bands x {n2} bytes",
            nbytes=_nbytes(args, k_out),
            flops=2 * k_out[0].numel() * t, library=conv))
        del k_out, p_out
    out = [r.finish(smi, cfg.mode) for r in rows]
    del rows

    # the kernel route (B7, DFT matrices with the correction folded in)
    # against the plain route (post-bank correction), per-band coefficients
    chan = chz.make_channelizer(WB_C, cfg.if_fs, taps_per_branch=WB_T,
                                device=dev)
    x = torch.randint(0, 256, (WB_BANDS, 2 * WB_C * cfg.if_per_block),
                      generator=gen, device=dev, dtype=torch.uint8)
    tails = [torch.randn(WB_BANDS, WB_C * WB_T - 1, generator=gen,
                         device=dev) for _ in range(2)]
    st = chz.ChannelizerState(*tails)
    u = lambda lo, hi: (torch.rand(WB_BANDS, generator=gen,  # noqa: E731
                                   device=dev) * (hi - lo) + lo)
    corr = iqcorr.IQCorrCoeffs(dc_i=u(-0.04, 0.04), dc_q=u(-0.04, 0.04),
                               rho=u(-0.2, 0.2), s=u(0.8, 1.2))
    (ki, kq), ks = chz.channelize_block_u8(chan, st, x, corr=corr)
    (pi, pq), ps = chz.channelize_block_u8(chan, st, x, impl="plain",
                                           corr=corr)
    torch.cuda.synchronize()
    err = _max_err((ki, kq), (pi, pq))
    _say(f"phase 2: channelize_block_u8 C={WB_C} T={WB_T}, {WB_BANDS} "
         f"bands, per-band IQ correction: kernel route (folded DFT) vs "
         f"plain route (post-bank): max |err| {err:.3g} (tolerance 1e-5)")
    if not (err <= 1e-5 and torch.equal(ks.tail_i, ps.tail_i)
            and torch.equal(ks.tail_q, ps.tail_q)):
        raise AssertionError("channelize_block_u8: the kernel route departs "
                             "from the plain route")
    return out


def _wideband_capture(cfg, dev):
    """[WB_STEPS, WB_BANDS, 2*C*if_per_block] u8 on ``dev``: ``bench.py``'s
    wideband capture (one stereo + RDS station on channel WB_STATION,
    800/2400 Hz, PI 54A7, PS DY4TPU), band b starting 74*b bytes in, so
    that every band row differs while the station stays on its channel."""
    import torch
    from dy4tpu_torch.rds import coding
    from dy4tpu_torch.tx import fm

    n = WB_STEPS + 1
    n_audio = n * cfg.audio_per_block
    bits = coding.make_ps_bitstream(fm.PI_CODE, 10, fm.PS_NAME, repeats=n)
    cap = fm.synthesize_wideband(cfg, WB_C, n, stations={WB_STATION: dict(
        left=fm.tone(800.0, cfg.audio_fs, n_audio, amp=0.7),
        right=fm.tone(2400.0, cfg.audio_fs, n_audio, amp=0.7),
        rds_bits=bits)})
    flat = torch.from_numpy(cap).to(dev)
    step = 2 * WB_C * cfg.if_per_block
    blocks = torch.empty(WB_STEPS, WB_BANDS, step, dtype=torch.uint8,
                         device=dev)
    for b in range(WB_BANDS):
        blocks[:, b] = flat[SHIFT * b:SHIFT * b + WB_STEPS * step].view(
            WB_STEPS, step)
    return blocks


def _run_wideband(dev, smi, all_wrappers) -> list[dict]:
    """The wideband front door: phases 2, 3 and 3b.  Returns B7's JSON
    entries, each with the launches of the phase-3 run."""
    import torch
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import afc, channelizer_cuda
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.pipeline import wideband as wb
    from dy4tpu_torch.tx import fm

    cfg = get_mode(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = _check_channelizer(cfg, dev, smi)
    _say(f"phase 2 wideband: {len(results)} B7 checks and the route check "
         f"in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    blocks = _wideband_capture(cfg, dev)
    _distinct_rows("wideband bands", blocks[0])
    _say(f"setup wideband: synthesized {WB_STEPS} steps, spread to "
         f"{tuple(blocks.shape)} u8 on the card ({blocks.numel() / 1e6:.0f} "
         f"MB; band b starts {SHIFT}*b bytes in) in "
         f"{time.perf_counter() - t0:.1f} s")
    params = rx.make_params(cfg, device=dev)
    chan = wb.make_wideband(cfg, WB_C, taps_per_branch=WB_T, device=dev)

    def run():
        st = wb.wideband_init(cfg, chan, (WB_BANDS,))
        return wb.run_wideband_blocks(params, chan, st, blocks, cfg)

    t0 = time.perf_counter()
    label = f"wideband {WB_BANDS} bands x {WB_C} channels"
    (_, outs), counts = _run_path(label, cfg, run, all_wrappers,
                                  entry="wideband", n_blocks=WB_STEPS)
    for r in results:
        r["launches"] = counts[channelizer_cuda.channelize_branches]
    want = {"mono": cfg.audio_per_block, "left": cfg.audio_per_block,
            "right": cfg.audio_per_block,
            "rds_symbols": cfg.rds_symbols_per_block}
    for name, n in want.items():
        got_shape = tuple(getattr(outs.rx, name).shape)
        if got_shape != (WB_STEPS, WB_BANDS, WB_C, n):
            raise AssertionError(f"{label} {name}: shape {got_shape}")
    for f in (*outs.rx, outs.rssi):
        if f is not None and f.is_floating_point() and not bool(
                torch.isfinite(f).all()):
            raise AssertionError(f"{label}: non-finite output")
    rssi = outs.rssi.mean(0)                       # [bands, C]
    for b in WB_ROWS:
        o = outs.rx
        got = fm.check_reception(
            cfg, o.left[:, b, WB_STATION].cpu().numpy(),
            o.right[:, b, WB_STATION].cpu().numpy(),
            o.rds_symbols[:, b, WB_STATION].cpu().numpy(),
            o.rds_resync[:, b, WB_STATION].cpu().numpy())
        live = float(rssi[b, WB_STATION])
        dead = max(float(v) for c, v in enumerate(rssi[b]) if c != WB_STATION)
        _say(f"phase 3: {label}: band {b} channel {WB_STATION} decoded: "
             f"separation L {got['sep_l_db']:.1f} dB, R {got['sep_r_db']:.1f} "
             f"dB, PI {got['pi']}, PS {got['ps']!r} ({got['groups']} groups);"
             f" RSSI {live:.1f} dBFS, loudest other channel {dead:.1f} dBFS")
        if not live >= dead + 15.0:
            raise AssertionError(f"{label}: band {b}: channel {WB_STATION} "
                                 f"is not 15 dB over every other channel")

    sel = torch.tensor(WB_ROWS, device=dev)
    n_check = N_CHAIN_CHECK[0]
    plain = dict(frontend="plain", backend="plain", pll_impl="plain",
                 channelizer="plain")
    _, ref = wb.run_wideband_blocks(
        params, chan, wb.wideband_init(cfg, chan, (len(WB_ROWS),)),
        blocks[:n_check, sel].contiguous(), cfg, **plain)
    # the live channel only: an empty channel demodulates to static, where
    # float32 rounding differences grow without bound
    live = lambda o, rows=slice(None): rx.StepOutputs(*(  # noqa: E731
        None if f is None else f[:, rows, WB_STATION] for f in o))
    _compare_chain(f"{label}: kernel path vs all-plain path", cfg,
                   live(outs.rx, sel), live(ref.rx), n_check,
                   rows=f"channel {WB_STATION} of bands {WB_ROWS}")
    del outs, ref

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    msps = WB_STEPS * WB_BANDS * WB_C * cfg.if_per_block / wall / 1e6
    bands_rt = msps * 1e6 / (WB_C * cfg.if_fs)
    _say(f"phase 3: {label}: {msps:.1f} MS/s wideband complex IQ = "
         f"{bands_rt:.1f} bands of {WB_C * cfg.if_fs / 1e6:g} MS/s in real "
         f"time ({WB_STEPS} steps x {WB_BANDS * WB_C} stations in "
         f"{wall:.3f} s, kernels, after warm-up); peak device memory "
         f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
         f"{time.perf_counter() - t0:.1f} s on {smi}")

    # ---- 3b. AFC and the IQ tracker, kernel path vs all-plain ----
    t0 = time.perf_counter()
    opt = blocks[:WB_OPT_STEPS, :WB_OPT_BANDS].contiguous()
    del blocks

    def run_opt(**kw):
        st = wb.wideband_init(cfg, chan, (WB_OPT_BANDS,), afc=True,
                              iqcorr=True)
        return wb.run_wideband_blocks(params, chan, st, opt, cfg, **kw)

    k_st, k_out = run_opt()
    p_st, p_out = run_opt(**plain)
    label = (f"wideband AFC + IQ tracker, {WB_OPT_BANDS} bands x "
             f"{WB_OPT_STEPS} steps")
    _compare_chain(f"{label}: kernel path vs all-plain path", cfg,
                   live(k_out.rx), live(p_out.rx), WB_OPT_STEPS,
                   rows=f"channel {WB_STATION} of bands 0-{WB_OPT_BANDS - 1}")
    hz = afc.freq_hz(k_st.afc, cfg.if_fs)[:, WB_STATION]
    hz_plain = afc.freq_hz(p_st.afc, cfg.if_fs)[:, WB_STATION]
    _say(f"phase 3b: {label}: AFC estimate of channel {WB_STATION}: "
         f"{[round(float(v), 1) for v in hz]} Hz (all-plain "
         f"{[round(float(v), 1) for v in hz_plain]} Hz); "
         f"{time.perf_counter() - t0:.1f} s")
    if not float(hz.abs().max()) <= AFC_TOL_HZ:
        raise AssertionError(f"{label}: the AFC estimate of the on-grid "
                             f"station left +-{AFC_TOL_HZ:g} Hz")
    return results


def _count_ops(dev) -> dict:
    """Top-level torch ops one mode-0 block issues at C=1 on the card,
    each kernel launch not counted (host-side count, ``torch.profiler``
    with CPU activity over one warm block): the bare ``receiver_step``,
    with ``pll_span=8``, with the IQ tracker, and the CLI's whole block
    (tracker, stereo blend, de-emphasis of both streams, quantize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import deemph, mix
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.tx import fm

    cfg = get_mode(0)
    params = rx.make_params(cfg, device=dev)
    blk = torch.from_numpy(fm.stereo_rds_broadcast(cfg, 1)).to(dev)
    a = deemph.deemph_coeff(cfg.audio_fs)

    def block(st, span=1, post=False):
        st, out = rx.receiver_step(params, st, blk, cfg, pll_span=span)
        if post:
            left, right = mix.stereo_blend(out.left, out.right,
                                           out.pilot_snr_db)
            zero = torch.zeros(1, device=dev)
            left, _ = deemph.deemphasis_block(left, zero, a)
            right, _ = deemph.deemphasis_block(right, zero, a)
            mix.quantize_s16(mix.interleave(left, right))
        return st

    counts = {}
    for name, tracker, kw in (("bare", False, {}),
                              ("span 8", False, dict(span=SPAN)),
                              ("tracker", True, {}),
                              ("CLI block", True, dict(post=True))):
        st = block(rx.init_state(cfg, (1,), with_iqcorr=tracker,
                                 device=dev), **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            block(st, **kw)
            torch.cuda.synchronize()
        counts[name] = sum(1 for e in prof.events()
                           if e.name.startswith("aten::")
                           and e.cpu_parent is None)
    return counts


def _run_cli(smi) -> None:
    """Phase 4: the receiver's command line on the card, as a user runs
    it, over a mode-0 stereo + RDS capture through ``FAULT``: one
    uninterrupted run with every opt-in audio feature, then the same
    stream cut by ``--checkpoint`` and finished by ``--resume``, whose PCM
    must equal the uninterrupted run's."""
    import numpy as np
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.tx import fm

    import torch
    counts = _count_ops(torch.device("cuda", 0))
    _say("phase 4: top-level torch ops per mode-0 block at C=1 besides the "
         "kernel launches: " + ", ".join(f"{k} {v}" for k, v in
                                         counts.items()))
    cfg = get_mode(0)
    t0 = time.perf_counter()
    iq = fm.stereo_rds_broadcast(cfg, CLI_BLOCKS, **FAULT)
    _say(f"setup phase 4: synthesized {CLI_BLOCKS} blocks of mode 0 "
         f"({iq.nbytes / 1e6:.1f} MB u8) in {time.perf_counter() - t0:.1f} s")
    flags = ["0", "sr", "--iqcorr", "--stereo-blend", "--deemphasis", "us"]

    def cli(*args):
        cmd = [sys.executable, "-m", "dy4tpu_torch", *flags, *args]
        t1 = time.perf_counter()
        r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"phase 4: {' '.join(cmd[1:])} exited "
                                 f"{r.returncode}:\n{r.stderr[-3000:]}")
        _say(f"phase 4: python -m dy4tpu_torch {' '.join(flags + list(args))}"
             f" ({time.perf_counter() - t1:.1f} s)")
        return r.stderr

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        iq.tofile(tmp / "all.raw")
        iq[CLI_SPLIT:].tofile(tmp / "rest.raw")
        err = cli("--rds-json", str(tmp / "events.jsonl"), "--stats",
                  "--input", str(tmp / "all.raw"), "--output",
                  str(tmp / "whole.pcm"))
        whole = np.fromfile(tmp / "whole.pcm", "<i2")
        want = CLI_BLOCKS * cfg.audio_per_block * 2
        if len(whole) != want:
            raise AssertionError(f"phase 4: {len(whole)} PCM samples, "
                                 f"expected {want}")
        events = [json.loads(line) for line in
                  (tmp / "events.jsonl").read_text().splitlines()]
        last = events[-1] if events else {}
        if not (last.get("pi") == f"{fm.PI_CODE:04X}"
                and last.get("ps", "").strip() == fm.PS_NAME.strip()):
            raise AssertionError(f"phase 4: the RDS events do not carry "
                                 f"PI/PS: {last}")
        stats = [ln for ln in err.splitlines() if ln.startswith("block ")]
        done = [ln for ln in err.splitlines()
                if ln.startswith("processed ")]
        if not (stats and done and "x real-time" in stats[-1]
                and "x real-time" in done[-1]):
            raise AssertionError(f"phase 4: --stats printed no real-time "
                                 f"factor:\n{err[-2000:]}")
        _say(f"phase 4: {len(whole)} PCM samples, {len(events)} RDS events "
             f"(PI {last['pi']}, PS {last['ps']!r}); --stats: "
             f"{stats[-1]}; single stream: {done[-1]} on {smi}")

        cli("--max-blocks", str(CLI_SPLIT), "--checkpoint",
            str(tmp / "rx.ckpt"), "--input", str(tmp / "all.raw"),
            "--output", str(tmp / "first.pcm"))
        cli("--resume", str(tmp / "rx.ckpt"), "--input",
            str(tmp / "rest.raw"), "--output", str(tmp / "second.pcm"))
        both = np.concatenate([np.fromfile(tmp / "first.pcm", "<i2"),
                               np.fromfile(tmp / "second.pcm", "<i2")])
        if not np.array_equal(both, whole):
            raise AssertionError(
                f"phase 4: checkpoint at block {CLI_SPLIT} + resume gives "
                f"{len(both)} PCM samples, "
                f"{int((both[:len(whole)] != whole[:len(both)]).sum())} of "
                f"them unequal to the uninterrupted run's")
        _say(f"phase 4: --checkpoint at block {CLI_SPLIT} + --resume: the "
             f"PCM equals the uninterrupted run's ({len(both)} samples); "
             f"phase 4 took {time.perf_counter() - t0:.1f} s")


def main() -> None:
    t_start = time.perf_counter()
    import torch

    # ---- 0. the card ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's kernels run only on a CUDA device")
    from dy4tpu_torch.ops import (backend_cuda, channelizer_cuda,
                                  frontend_cuda, pll_cuda, resample_cuda)
    from dy4tpu_torch.runtime import kernels

    # float32 throughout (dy4tpu's precision=HIGHEST): no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    _say(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)}")
    _say(smi)

    # ---- 1. build ----
    t0 = time.perf_counter()
    libs = kernels.build_all()
    _say(f"phase 1: built {len(libs)} kernel libraries in "
         f"{time.perf_counter() - t0:.1f} s ({kernels.build_dir().name})")

    all_wrappers = [frontend_cuda.fused_frontend_full,
                    frontend_cuda.fused_frontend_full.corr,
                    frontend_cuda.fused_frontend_if, pll_cuda.phase_scan,
                    pll_cuda.phase_scan_target,
                    backend_cuda.fused_audio_backend,
                    resample_cuda.fused_audio_backend_rational,
                    resample_cuda.fused_rds_backend,
                    channelizer_cuda.channelize_branches]
    # ---- 2 + 3, mode by mode, then the wideband front door ----
    results: list[dict] = []
    for mode in (0, 1, 2, 3):
        results += _run_mode(mode, dev, smi, all_wrappers)
        torch.cuda.empty_cache()
    results += _run_wideband(dev, smi, all_wrappers)
    torch.cuda.empty_cache()
    _run_cli(smi)

    for r in results:
        del r["wrapper"]
        if not r.get("launches"):
            raise AssertionError(f"{r['name']}: no launch on its path")
    _say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

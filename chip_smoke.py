"""Chip smoke of the PyTorch / CUDA port (``dy4tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's receiver on the card through its seven hand-written CUDA
kernels, in all four modes, through the IF entry, and through the wideband
channelizer front door:

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
   the plain RF LPF;
3. per mode, runs ``run_blocks`` over 24 blocks x 512 channels, checks
   that every kernel of the mode's path ran on every block (and no other
   kernel ran), decodes channel 0 (stereo separation, and RDS PI/PS in
   modes 0 and 2), compares four channels with an all-plain run over the
   first blocks, and times the chain.  At modes 0 and 1 it also runs the
   IF entry (``receiver_step_if``) over the same 24 blocks as IF I/Q, with
   the same checks, and holds it against the RF entry's kernel run;
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
   all-plain run.

Prints one JSON line of per-kernel results (one entry per kernel and
geometry), then, as its last line, ``{"ok": true, "device": {...}}``.  Any
failure raises (nonzero exit); without a CUDA device it exits nonzero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
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


@dataclasses.dataclass
class _Row:
    """One kernel checked at one geometry: what the JSON line reports.
    The plain version is timed by ``plain`` or, where it was timed by its
    comparison call, given as ``plain_ms``."""
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

    def finish(self, smi: str, mode: int) -> dict:
        if not self.err <= self.tol:
            raise AssertionError(f"{self.kernel} ({self.geometry}): max "
                                 f"|kernel - plain| {self.err:.3g} above "
                                 f"the tolerance {self.tol:g}")
        ms = _time_ms(self.kern, 20)
        plain_ms = (self.plain_ms if self.plain is None
                    else _time_ms(self.plain, 5))
        _say(f"phase 2: {self.kernel} {self.geometry}: max |kernel - "
             f"plain| {self.err:.3g} (tolerance {self.tol:g}); kernel "
             f"{ms:.4f} ms, plain {plain_ms:.4f} ms at {self.where} ({smi})")
        return dict(name=f"{self.kernel.split()[1]}:{self.geometry}",
                    route="cuda", source=self.source,
                    replaces=self.replaces, max_abs_err=self.err,
                    tolerance=self.tol, ms=ms, plain_ms=plain_ms,
                    mode=mode, wrapper=self.wrapper)


def _check_kernels(cfg, params, blocks, dev, smi) -> list[dict]:
    """Phase 2 at one mode: every kernel of the mode's path against its
    plain version on block 1, mid-stream, at C=512.  Returns the JSON
    entries."""
    import numpy as np
    import torch
    from dy4tpu_torch.ops import (backend_cuda, frontend_cuda, pll,
                                  pll_cuda, resample_cuda)
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
        lambda: frontend_cuda.fused_frontend_full_plain(*fargs, rds=rds)))
    fmd, pilot, stereo, carrier, rdsdel = (cont(t) for t in p_out[:5])

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
            lambda: frontend_cuda.fused_frontend_if_plain(*iargs, rds=rds)))

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
        plain_ms=plain_pll_ms))

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
    rows.append(_Row(*name, wrap, _max_err(k_out, p_out), 1e-5,
                     lambda: wrap(*aargs), lambda: plain(*aargs)))
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
        rows.append(_Row(
            "B4 rds_backend", f"{mode} {cfg.rds_up}/{cfg.rds_down}",
            "dy4tpu_torch/csrc/rds_backend.cu",
            "dy4tpu/ops/resample_pallas.py:275",
            resample_cuda.fused_rds_backend, _max_err(k_out, p_out), 1e-5,
            lambda: resample_cuda.fused_rds_backend(*rargs),
            lambda: resample_cuda.fused_rds_backend_plain(*rargs)))

    return [r.finish(smi, cfg.mode) for r in rows]


def _path(cfg, entry: str = "rf"):
    """The kernel wrappers a mode's main path launches: ``entry`` "rf"
    (``receiver_step``), "if" (``receiver_step_if``) or "wideband"
    (``wideband_step``: the channelizer, then the IF entry)."""
    from dy4tpu_torch.ops import (backend_cuda, channelizer_cuda,
                                  frontend_cuda, pll_cuda, resample_cuda)
    front = (frontend_cuda.fused_frontend_full if entry == "rf"
             else frontend_cuda.fused_frontend_if)
    audio = (backend_cuda.fused_audio_backend if cfg.audio_up == 1
             else resample_cuda.fused_audio_backend_rational)
    path = [front, pll_cuda.phase_scan, audio]
    if cfg.supports_rds:
        path.append(resample_cuda.fused_rds_backend)
    if entry == "wideband":
        path.insert(0, channelizer_cuda.channelize_branches)
    return path


def _run_path(label, cfg, run, all_wrappers, entry="rf",
              n_blocks=N_BLOCKS):
    """Zero every launch count, ``run()``, and check that each kernel of
    the path launched on every one of ``n_blocks`` blocks and no other
    kernel launched.  Returns ``(run's result, {wrapper: launches})``."""
    import torch
    for w in all_wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {w: w.launches for w in all_wrappers}
    path = _path(cfg, entry)
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


def _check_outputs(label, cfg, outs) -> None:
    """Shapes, finiteness, and the decode bars on channel 0."""
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


def _run_mode(mode, dev, smi, all_wrappers) -> list[dict]:
    """Phases 2 and 3 at one mode (and the IF entry where B6 is checked).
    Returns the mode's JSON entries, each with the launches of the run
    whose path holds its kernel."""
    import torch
    from dy4tpu.config import get_mode
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
        if r["wrapper"] is not frontend_cuda.fused_frontend_if:
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
        rows.append(_Row(
            "B7 channelizer", f"C={c} T={t}",
            "dy4tpu_torch/csrc/channelizer.cu",
            "dy4tpu/ops/channelizer.py:344", chc.channelize_branches,
            _max_err(k_out, p_out), 1e-5,
            lambda a=args: chc.channelize_branches(*a),
            lambda a=args: chc.channelize_branches_plain(*a),
            where=f"{WB_BANDS} bands x {n2} bytes"))
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
    from dy4tpu.rds import coding
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
    from dy4tpu.config import get_mode
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
                    frontend_cuda.fused_frontend_if, pll_cuda.phase_scan,
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

    for r in results:
        del r["wrapper"]
        if "launches" not in r:
            raise AssertionError(f"{r['name']}: no launch count")
    _say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

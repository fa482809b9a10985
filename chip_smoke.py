"""Chip smoke of the PyTorch / CUDA port (``dy4tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path, the mode-0 mono + stereo + RDS receiver, on
the card, through its four hand-written CUDA kernels:

0. requires a CUDA device; prints torch/CUDA versions and the card's name
   and power limit; turns TF32 off (the receiver is float32 throughout);
1. builds the kernels from ``dy4tpu_torch/csrc`` with nvcc;
2. holds each kernel against its plain torch version at the main path's
   shapes (C=512 channels, one 32 ms block) on a synthesized broadcast,
   mid-stream, over all rows, and times both with CUDA events.  Each
   channel takes the broadcast from its own offset (I/Q swapped on odd
   channels), so every row of every input, tail and carry differs.  The
   PLL must be bitwise equal; the others within their stated tolerances;
3. runs ``run_blocks`` over 24 blocks x 512 channels of those streams
   (1.9 GB of u8 on the card), checks that every kernel ran on every
   block, decodes channel 0 (stereo separation, RDS PI/PS), compares
   four channels over 4 blocks with an all-plain run, and times the
   chain.

Prints one JSON line of per-kernel results, then, as its last line,
``{"ok": true, "device": {...}}``.  Any failure raises (nonzero exit);
without a CUDA device it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

C = 512          # channels: the serving batch of one card
N_BLOCKS = 24    # 0.77 s of stream; PS needs 24 blocks to decode
N_CHAIN_CHECK = 4
CHAIN_ROWS = [0, 1, C // 2, C - 1]   # held against an all-plain run
SHIFT = 74       # bytes (37 complex samples) between neighbouring channels


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
        r = t.reshape(t.shape[0], -1)
        if not bool((r[1:] != r[:-1]).any(dim=1).all()):
            raise AssertionError(f"{name}: inputs with equal neighbouring "
                                 f"rows cannot show a row fault")


def main() -> None:
    import numpy as np
    import torch

    # ---- 0. the card ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's kernels run only on a CUDA device")
    from dy4tpu.config import get_mode
    from dy4tpu_torch.ops import (backend_cuda, frontend_cuda, pll,
                                  pll_cuda, resample_cuda)
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.runtime import kernels
    from dy4tpu_torch.tx import fm

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
    _say(f"phase 1: built {len(libs)} kernels in "
         f"{time.perf_counter() - t0:.1f} s ({kernels.build_dir().name})")

    cfg = get_mode(0)
    params = rx.make_params(cfg, device=dev)
    t0 = time.perf_counter()
    blocks = _channels(fm.stereo_rds_broadcast(cfg, N_BLOCKS + 1), cfg, dev)
    _say(f"setup: synthesized {N_BLOCKS} blocks, spread to "
         f"{tuple(blocks.shape)} u8 on the card "
         f"({blocks.numel() / 1e9:.2f} GB; channel c starts {SHIFT}*c "
         f"bytes in, odd channels I/Q swapped) in "
         f"{time.perf_counter() - t0:.1f} s")

    # ---- 2. each kernel against its plain version, mid-stream ----
    plain_all = dict(frontend="plain", backend="plain", pll_impl="plain")
    st, _ = rx.receiver_step(params, rx.init_state(cfg, (C,), device=dev),
                             blocks[0], cfg, **plain_all)
    blk = blocks[1]
    rows = []

    fs = rx.front_state_of(st)
    fargs = (blk, params.rf_coeff, params.bank_coeff,
             params.rds_carrier_coeff, fs.rf.iq_tail.contiguous(),
             fs.rf.prev_i.contiguous(), fs.rf.prev_q.contiguous(),
             fs.bank_tail.contiguous(), fs.mono_delay.contiguous(),
             fs.carrier_tail.contiguous(), fs.rds_delay.contiguous(),
             cfg.rf_decim)
    _distinct_rows("B1", *fargs[:1], *fargs[4:11])
    k_out = frontend_cuda.fused_frontend_full(*fargs)
    p_out = frontend_cuda.fused_frontend_full_plain(*fargs)
    torch.cuda.synchronize()
    if not torch.equal(k_out[5], p_out[5]):
        raise AssertionError("B1 iq_tail differs from the plain version")
    # 1e-5: float32 sums in another order; a TF32 tap sum misses it by far
    rows.append(("B1 frontend", "dy4tpu_torch/csrc/frontend.cu",
                 "dy4tpu/ops/frontend_pallas.py:693",
                 frontend_cuda.fused_frontend_full, _max_err(k_out, p_out),
                 1e-5, lambda: frontend_cuda.fused_frontend_full(*fargs),
                 lambda: frontend_cuda.fused_frontend_full_plain(*fargs)))
    fmd, pilot, stereo, carrier, rdsdel = (t.contiguous() for t in p_out[:5])

    x = torch.stack([pilot, carrier], dim=-2).contiguous()
    consts = pll._loop_consts(
        np.array([cfg.pll_freq, cfg.rds_pll_freq], np.float32), cfg.if_fs,
        np.array([cfg.pll_bandwidth, cfg.rds_pll_bandwidth], np.float32))
    kp, ki, dth = (torch.as_tensor(v, device=dev) for v in consts)
    integ, pe, _ = (torch.stack([a, b], dim=-1).contiguous() for a, b in
                    zip(st.audio.pll[2:5], st.rds.pll[2:5]))
    # the NCO angle runs free of the data, equal on every row: draw it
    angle = torch.from_numpy(np.random.default_rng(0).uniform(
        0.0, 4 * np.pi, (C, 2)).astype(np.float32)).to(dev)
    carry = (integ, pe, angle)
    _distinct_rows("B2", x, *carry)
    k_phi, k_c = pll_cuda.phase_scan(x, kp, ki, dth, carry)
    p_phi, p_c = pll_cuda.phase_scan_plain(x, kp, ki, dth, carry)
    torch.cuda.synchronize()
    if not (torch.equal(k_phi, p_phi)
            and all(torch.equal(a, b) for a, b in zip(k_c, p_c))):
        raise AssertionError("B2 PLL is not bitwise equal to its plain "
                             f"version: max |dphi| "
                             f"{_max_err([k_phi], [p_phi])}")
    rows.append(("B2 pll", "dy4tpu_torch/csrc/pll.cu",
                 "dy4tpu/ops/pll_pallas.py:278", pll_cuda.phase_scan,
                 _max_err((k_phi, *k_c), (p_phi, *p_c)), 0.0,
                 lambda: pll_cuda.phase_scan(x, kp, ki, dth, carry),
                 lambda: pll_cuda.phase_scan_plain(x, kp, ki, dth, carry)))

    both = pll.PLLState(*(torch.stack([a, b], dim=-1) for a, b in
                          zip(st.audio.pll, st.rds.pll)))
    nco_i2, nco_q2, _ = pll.pll(
        x, both, freq=np.array([cfg.pll_freq, cfg.rds_pll_freq], np.float32),
        fs=cfg.if_fs,
        nco_scale=np.array([cfg.pll_nco_scale, cfg.rds_pll_nco_scale],
                           np.float32),
        norm_bandwidth=np.array([cfg.pll_bandwidth, cfg.rds_pll_bandwidth],
                                np.float32), impl="kernel")
    nco = nco_i2[:, 0].contiguous()
    nco_i = nco_i2[:, 1].contiguous()
    nco_q = nco_q2[:, 1].contiguous()
    bs = rx.back_state_of(st)
    aargs = (fmd, stereo, nco, params.audio_coeff,
             bs.mono_tail.contiguous(), bs.stereo_tail.contiguous(),
             cfg.audio_down)
    _distinct_rows("B3", *aargs[:3], *aargs[4:6])
    k_out = backend_cuda.fused_audio_backend(*aargs)
    p_out = backend_cuda.fused_audio_backend_plain(*aargs)
    rows.append(("B3 audio_backend", "dy4tpu_torch/csrc/audio_backend.cu",
                 "dy4tpu/ops/backend_pallas.py:93",
                 backend_cuda.fused_audio_backend, _max_err(k_out, p_out),
                 1e-5, lambda: backend_cuda.fused_audio_backend(*aargs),
                 lambda: backend_cuda.fused_audio_backend_plain(*aargs)))

    rargs = (rdsdel, nco_i, nco_q, params.rds_lpf_coeff,
             params.rds_rrc_coeff, bs.lpf_tail_i.contiguous(),
             bs.lpf_tail_q.contiguous(), bs.rrc_tail_i.contiguous(),
             bs.rrc_tail_q.contiguous(), cfg.rds_up, cfg.rds_down)
    _distinct_rows("B4", *rargs[:3], *rargs[5:9])
    k_out = resample_cuda.fused_rds_backend(*rargs)
    p_out = resample_cuda.fused_rds_backend_plain(*rargs)
    rows.append(("B4 rds_backend", "dy4tpu_torch/csrc/rds_backend.cu",
                 "dy4tpu/ops/resample_pallas.py:275",
                 resample_cuda.fused_rds_backend, _max_err(k_out, p_out),
                 1e-5, lambda: resample_cuda.fused_rds_backend(*rargs),
                 lambda: resample_cuda.fused_rds_backend_plain(*rargs)))

    results = []
    for name, src, repl, wrapper, err, tol, kern, plain in rows:
        if not err <= tol:
            raise AssertionError(f"{name}: max |kernel - plain| {err:.3g} "
                                 f"above the tolerance {tol:g}")
        ms = _time_ms(kern, 20)
        plain_ms = _time_ms(plain, 1 if wrapper is pll_cuda.phase_scan
                            else 5)
        _say(f"phase 2: {name}: max |kernel - plain| {err:.3g} (tolerance "
             f"{tol:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
             f"at C={C} ({smi})")
        results.append(dict(name=name.split()[1], route="cuda", source=src,
                            replaces=repl, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, wrapper=wrapper))

    # ---- 3. the slice: run_blocks through the kernels ----
    wrappers = [r["wrapper"] for r in results]
    for w in wrappers:
        w.launches = 0
    state = rx.init_state(cfg, (C,), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, outs = rx.run_blocks(params, state, blocks, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for r in results:
        r["launches"] = r.pop("wrapper").launches
    for r in results:
        if r["launches"] < N_BLOCKS:
            raise AssertionError(f"kernel {r['name']} launched "
                                 f"{r['launches']} times over {N_BLOCKS} "
                                 f"blocks")
    _say("phase 3: launches over the run: " + ", ".join(
        f"{r['name']} {r['launches']}" for r in results)
        + f" ({first_s:.2f} s, first run)")

    shapes = {"mono": cfg.audio_per_block, "left": cfg.audio_per_block,
              "right": cfg.audio_per_block, "rds_bb_i": cfg.rds_per_block,
              "rds_bb_q": cfg.rds_per_block,
              "rds_symbols": cfg.rds_symbols_per_block}
    for name, n in shapes.items():
        got_shape = tuple(getattr(outs, name).shape)
        if got_shape != (N_BLOCKS, C, n):
            raise AssertionError(f"{name}: shape {got_shape}, expected "
                                 f"{(N_BLOCKS, C, n)}")
    for f in outs:
        if f is not None and f.is_floating_point() and not bool(
                torch.isfinite(f).all()):
            raise AssertionError("non-finite receiver output")
    got = fm.check_reception(
        cfg, outs.left[:, 0].cpu().numpy(), outs.right[:, 0].cpu().numpy(),
        outs.rds_symbols[:, 0].cpu().numpy(),
        outs.rds_resync[:, 0].cpu().numpy())
    _say(f"phase 3: channel 0 decoded: separation L {got['sep_l_db']:.1f} "
         f"dB, R {got['sep_r_db']:.1f} dB, PI {got['pi']}, PS "
         f"{got['ps']!r} ({got['groups']} groups)")

    sel = torch.tensor(CHAIN_ROWS, device=dev)
    _, ref = rx.run_blocks(
        params, rx.init_state(cfg, (len(CHAIN_ROWS),), device=dev),
        blocks[:N_CHAIN_CHECK, sel].contiguous(), cfg, **plain_all)
    errs = {f: _max_err([getattr(outs, f)[:N_CHAIN_CHECK, sel]],
                        [getattr(ref, f)])
            for f in ("mono", "left", "right", "rds_bb_i", "rds_bb_q")}
    sym_agree = float((outs.rds_symbols[:N_CHAIN_CHECK, sel]
                       == ref.rds_symbols).double().mean())
    _say(f"phase 3: kernel path vs all-plain path, channels {CHAIN_ROWS}, "
         f"blocks 0-{N_CHAIN_CHECK - 1}: max |err| " + ", ".join(
             f"{k} {v:.3g}" for k, v in errs.items())
         + f"; RDS symbols agree {sym_agree:.4f}")
    if max(errs.values()) > 5e-2 or sym_agree < 0.99:
        raise AssertionError("kernel path departs from the plain path "
                             "(tolerance 5e-2 on audio and baseband, 99% "
                             "of RDS symbols)")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, outs = rx.run_blocks(params, state, blocks, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    msps = N_BLOCKS * C * cfg.iq_per_block / wall / 1e6
    _say(f"phase 3: chain {msps:.1f} MS/s complex IQ ({N_BLOCKS} blocks x "
         f"{C} channels in {wall:.3f} s, kernels, after warm-up) on {smi}")

    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

"""Chip smoke of the PyTorch / CUDA port (``dy4tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's receiver on the card through its sixteen hand-written
CUDA kernels, in all four modes, through the IF entry, with the opt-in span
PLL and IQ tracker, through the wideband channelizer front door, through
the receiver's command line, through the exact time-sharded receiver,
through the PSD path and the capture tools, through dy4tpu's A/B
front-end routes and the kernels no receiver route runs, through fleet
serving, and through CDR dropouts, noise, echoes, channel isolation and a
10^4-block soak:

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
   state (there elementwise within 1e-5 plus the demod's conditioning).
   B9 also at a ragged [37, 383] (37 streams, m two 128-step tiles + 127,
   NaN spans over the tile boundary at 128 in every third row).
   At mode 0 B2 is also held bitwise at a ragged [37, 1531] (37 pilot
   rows, N no multiple of 4 or of its 128-step tile) and at the CLI's
   [1, 2, 7680]; at modes 0 and 1 (decim 10 and 5) B1, B1-corr and B6 also
   at a ragged [37, 3132] (the block cut to 3132 IF samples: two tiles of
   1536 and a last one of 60, shorter than the 100-sample band history)
   and at the CLI's one channel, and B1 / B6's tile plan and shared
   memory per block are printed; B3 (modes 0 and 1: the tile resampler
   of B5 at U = 1), B4 (modes 0 and 2) and B5 (modes 2 and 3) also at a
   ragged 37 rows and at the CLI's C=1, B4 at mode 0 also at the sharded
   step's mini warm-up of 1920 inputs (C=128), each with its tile plan
   (``resample_cuda._tile_plan``) printed, and at 37 rows the wrapper's
   plan held bitwise against a pinned plan of row groups of 2 (the last
   one short) whose last tile is shorter than the rest; at each full
   geometry every plan the plan weighs is timed (CUDA events around
   back-to-back launches of the C entry point), the plan's pick printed
   beside the fastest (B3 also beside the fastest plan of one output a
   thread and a cycle of one output), and after the four modes the plan's
   cost model is fitted to them all;
3. per mode, runs ``run_blocks`` over 24 blocks x 512 channels, checks
   that every kernel of the mode's path ran on every block (and no other
   kernel ran), decodes channel 0 (stereo separation, and RDS PI/PS in
   modes 0 and 2), compares four channels with an all-plain run over the
   first blocks, and times the chain (and splits one more warm run's
   device time by kernel under ``torch.profiler``, here and for the IF
   entry and the wideband path).  At modes 0 and 1 it also runs the
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
   band rows, at the wideband tool's one band (C=8), at 37 ragged bands,
   at the tool's band at C=25, at T=24 taps and at C=128 T=32 (no stage
   head), each bitwise under a
   second plan (each plan printed) and also alone from a cold L2, with a
   sweep of its plans at two of them (the plan's pick beside the
   fastest), the wrapper's host time at the tool's band and each
   geometry's wrapper against conv1d by CUDA events (met or missed),
   ``channelize_block_u8``'s kernel route (folded IQ
   correction) against its plain route (post-bank correction), and B2
   bitwise on the wideband step's own PLL input [512, 2, 7680]; phase 3
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
   PCM must equal the uninterrupted run's;
6. phase 5, the exact time-sharded receiver at mode 0 on a 1x1 mesh at
   ``bench.py``'s sharded point (C=128, shard_blocks=6, the auto 1920-IF
   halo): B8 against its plain version and against B2 on the float32
   samples its codes came from, bitwise, at [128, 2, 48000] (some rows
   with an INVALID prefix, one INVALID throughout) and at a ragged
   [37, 1531] (N no multiple of 16 or of the tile; split_at 0, 128, 1000
   and 1531; an INVALID run over [100, 300) in every third row, one row
   INVALID throughout); then 4 ``step`` calls
   over 24 blocks, every output bitwise equal to ``run_blocks`` on the
   card, B8 launched once per step and B1, B3, B4 seven times (the warm-up
   and six blocks), B2 and B9 never; channel 0 decoded; and the sharded
   step against plain ``run_blocks`` as ``bench.py``'s ``_time_sharded``
   times them (medians of 5), with B8's share of the sharded step's device
   time under ``torch.profiler``;
7. phase 6, the PSD path and the tools at mode 0: B10 (the FFT) against its
   plain version (the four-step) and against ``torch.fft.fft``, within 1e-5
   of the largest magnitude, at every N of 4..2048 that its TPU twin takes,
   real and complex, on 1531 rows, and at the PSD path's 76,800 x 512
   (the RF I of 512 channels); ``estimate_psd`` over the RF I, RDS
   baseband and mono of 512 channels (B10 once per call; against the
   four-step on the card and ``torch.fft.fft`` on the CPU; channel 0's mono
   peaks on its two tones; white noise within 1e-3 dB); psdview's
   ``_block_psds`` over 8 blocks of a capture from the port's synth (B10
   three times a block, B1-B4 once); and as subprocesses the port's synth
   (48 blocks, clean with PI/PS and with the three tuner and channel
   faults), the receiver's CLI decoding PI/PS from the clean capture, and
   ratechange 2400 -> 1440 on the card against ``--device cpu`` (within 1
   LSB).  B10 must launch on no earlier path;
8. phase 7, at modes 0 and 1: B11, B12 and B13 (one kernel,
   ``rf_tile_kernel``: the RF stage to fm from the u8 rows read as 16-bit
   pairs, B12 on the same rows with no phase planes, B13 as 32-bit words)
   against their plain versions on block 2 at C=512, at 37 ragged rows
   and at C=1 (fm within 1e-3 where the decimated power is above 1e-3,
   iq_tail exact, prev_i/prev_q within 1e-5), each bitwise under a second
   plan and B12, B13 bitwise B11; B11 bitwise B1 from the same state (its
   fm[m - 50] B1's fm_delayed[m], its prev_i/prev_q and iq_tail B1's);
   B9-expand against its plain version and B9 + the torch expansion,
   bitwise, also at B9's ragged [37, 383]; ``run_blocks`` over 24 blocks
   with ``frontend="fused-rf"`` and ``"fused-phase"`` (B11 or B12 exactly
   once a block, B1 never; channel 0 decoded; four channels held to the
   B1 route; median of 5 rates; one more warm run's device time split by
   kernel) and with ``pll_span=8,
   pll_span_emit="kernel"`` (B9-expand once a block, B9 never; decoded;
   every output bitwise equal to the torch expansion's run); at mode 0,
   B13 and B14 (``fir.block_fir_decim(impl="kernel")`` on the RF legs)
   through their own calls over the 24 blocks, state carried, each once a
   block and nothing else, B14's I/Q through torch's demod bit for bit
   B11's fm, iq_tail and prev_i/prev_q on every channel; then B14 against
   its plain conv1d (also the library call) at seven geometries (37
   ragged rows among them), y within 2e-4 x max(1, max|y|), state exact,
   bit for bit under a second plan, and its plans swept alone from a cold
   L2 at the RF legs of 512 channels, the rule's pick marked;
9. phase 8, fleet serving (``dy4tpu_torch.tools.fleet``) over captures
   the port's synth writes (four mode-0 stations, one through a tuner
   fault, two mode-2 stations, 24 blocks each): the tool as a subprocess
   at C=512 (``--repeat 128``), overlapped and with ``--sync-ingest``,
   every station decoding its capture's PI/PS and the two runs' station
   lines equal; ``fleet.serve`` in process at C=512 with chunks of 8
   (overlapped and sync), 3 and 1, the RDS outputs bitwise equal, B1-B4
   once a block (and once a block of the warm-up chunk) and nothing else;
   mode 2 with the envelope CDR (B5 and B4 at 171/640) and mode 0 with the
   IQ tracker (B1's corr variant) at C=64, decoded; each run's wall,
   MS/s, real-time factor and phase times beside phase 3's chain rate;
10. phase 9, recovery and the long stream, on the default kernel route:
   the soak of tests/test_soak.py at C=64 (four stations, 16 rows each):
   10^4 mode-0 blocks and 5000 mode-2 blocks with the envelope CDR, one
   25-block cycle put on the card once and looped, the state finite and
   the PLL accumulators inside their wrap band every 100 cycles, a
   checkpoint through ``utils.checkpoint`` and disk at block 7500 (3750
   at mode 2) whose resumed twin equals the live run bit for bit over
   three cycles, and every row's PI/PS decoded from the last cycle with
   no resync in it (B1-B4, or B1, B2, B5, B4, on every block); then one
   mode-0 batch of tests/test_noise.py's, test_recovery.py's and
   test_multichannel.py's captures at their bars, the IQ tracker (B1's
   corr variant) on test_iqcorr.py's faulted and multipath captures
   against the tracker off, and test_mode2_rds_property.py's CDR
   dropouts at mode 2 on two stations, each at its four properties; the
   soak's ms a block, MS/s and the phase's peak device memory.

Prints one JSON line of per-kernel results (one entry per kernel and
geometry: its error against the plain version, its time and the plain
version's, the kernel alone (``kernel_device_ms``: its CUDA kernel's
mean device time a launch under ``torch.profiler`` over 20 more calls,
without the wrapper's host work), its launches on the main path, and its
bound: the larger of the bytes it must move over 3.35 TB/s and its
float32 operations over 67 TFLOP/s; phase 2 also prints an estimate of
the serial PLL scans' dependency-chain floor), then, as its last line,
``{"ok": true, "device": {...}}``.  Any failure raises (nonzero exit);
without a CUDA device it exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
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
# B7 also at the wideband tool's one band of WB_TOOL_C channels and at
# 32 + 5 bands of a row no tile divides (C=16); its plan swept at these
# (bands, C, T), its wrapper's host time taken at the tool's band
WB_TOOL_C = 8
B7_RAGGED = (37, 1531)
B7_SWEEP = ((WB_BANDS, 16, 12), (1, WB_TOOL_C, 12))
# (C, T, bands) the first design also served: an odd C (the tool at
# --channels 25), T > 16 (two groups of taps) and a bank whose tail takes
# no stage head (read from device memory)
B7_MORE = ((25, 12, 1), (16, 24, WB_BANDS), (128, 32, 1))
WB_OPT_BANDS, WB_OPT_STEPS = 4, 8    # AFC + IQ tracker, kernel vs plain
AFC_TOL_HZ = 1000.0                  # on-grid station: |AFC estimate|
OPT_MODES = (0, 1)                   # span PLL (B9) and IQ tracker (B1 corr)
SPAN = 8                             # the span PLL's samples per update
FAULT = dict(dc_i=0.12, dc_q=-0.08, iq_gain=0.7, iq_phase_deg=25.0)
RATE_REPS = 5                        # chain rate: median of this many runs
CLI_BLOCKS, CLI_SPLIT = 200, 100     # phase 4: blocks, checkpoint point
# phase 5: bench.py's sharded point (_time_sharded(128, 6, ...)), one
# card, 4 steps of 6 blocks = N_BLOCKS
SH_C, SH_S, SH_STEPS = 128, 6, 4
SH_PREFIX_EVERY = 4                  # B8 check: every 4th row from row 1
#                                      starts with an INVALID prefix
# phase 6: B10 at every N its TPU twin takes, on a row count no tile of
# the kernel divides; the PSD path on mode 0's block PSD_BLOCK (after the
# PLLs' lock-in) of C channels; psdview over PSD_VIEW_BLOCKS blocks; the
# capture tools over TOOL_BLOCKS (synth, the CLI) and RC_BLOCKS (ratechange)
FFT_NS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
FFT_ROWS = 1531                      # a prime
FFT_TOL = 1e-5       # max |kernel - plain| / max |plain| (test_fft_psd.py)
PSD_NFFT, PSD_BLOCK, PSD_VIEW_BLOCKS = 512, 4, 8
# PSD, linear power relative to the row's peak.  The four-step on the card
# carries about 7e-7 of the largest magnitude; averaged in dB over 150
# segments, the few segments in which a strong bin fades to that floor
# move its mean by a few 1e-5 of the row's peak.  1e-3 is 4.3e-3 dB at
# the peak, and a wrong bin, scale or window departs by O(1).
PSD_LIN_TOL = 1e-3
PSD_NOISE_DB = 1e-3  # PSD of white noise, dB (test_fft_psd.py's bar)
PSD_NOISE_ROWS = 4
TOOL_BLOCKS, RC_BLOCKS = 48, 24
# phase 8: fleet serving.  Four mode-0 stations x 128 = C, one faulted
# mode-0 capture for --iqcorr, two mode-2 stations for the envelope CDR
FLEET_MODE0 = ((0x54A7, "DY4TPU"), (0x0A0B, "FLEET 2"), (0x1C3D, "FLEET 3"),
               (0x7E5F, "FLEET 4"))
FLEET_FAULTED = (0x5EED, "FAULTED")
FLEET_MODE2 = ((0x2A2A, "MODE2 A"), (0x2B2B, "MODE2 B"))
FLEET_REPEAT = C // len(FLEET_MODE0)  # 128: the serving batch of phase 3
FLEET_SIDE_C = 64                     # stations of the mode-2 / iqcorr runs
FLEET_CHUNKS = ((8, False), (8, True), (3, False), (1, False))
# phase 9: the soak (tests/test_soak.py): a SOAK_CYCLE-block cycle of four
# distinct stations (PI, PS, left and right tones), SOAK_ROWS rows each,
# looped (mode, cycles, CDR timing); the state checked every
# SOAK_CHECK_EVERY cycles, checkpointed after min(SOAK_CKPT, 3/4 of the
# cycles) (block 7500 at mode 0) and its resumed twin held bitwise over
# SOAK_TWIN cycles
SOAK_CYCLE, SOAK_CHECK_EVERY, SOAK_CKPT, SOAK_TWIN = 25, 100, 300, 3
SOAK_RUNS = ((0, 400, "peak"), (2, 200, "envelope"))
SOAK_STATIONS = ((0x54A7, "SOAKSOAK", 800.0, 2400.0),
                 (0x1B2C, "SOAK  B ", 600.0, 1900.0),
                 (0x3D4E, "SOAK  C ", 1000.0, 3100.0),
                 (0x5F60, "SOAK  D ", 1300.0, 700.0))
SOAK_ROWS = 16                        # C = 64
PLL_WRAP = 4.0 * math.pi              # ops/pll.py's accumulator modulus
# phase 9's recovery runs: test_recovery.py's 14 + 4 + 14 dropout stream,
# test_multichannel.py's stations, test_mode2_rds_property.py's capture
# (row 0) and a second station through the same dropouts (row 1)
REC_SEG = 14
REC_STATIONS = ((0x1111, "ALPHA FM", 600.0), (0x2222, "BRAVO FM", 1000.0),
                (0x3333, "CHARLIE!", 1500.0))
MODE2_ROWS = ((0x2A95, 7, "MODE2 95"), (0x6B21, 7, "MODE2 B "))
MODE2_BLOCKS = 52
# phase 7: the A/B front ends B11-B13 and B9-expand at AB_MODES, checked on
# block AB_BLOCK after the loops lock in: fm within AB_TOL where the
# decimated power is above AB_POWER (test_frontend_pallas.py's bar: the
# demod's 1/power amplifies float32 rounding near the origin), prev_i/
# prev_q within AB_PREV_TOL; B14 within FIR_TOL x max(1, max|y|)
# (test_fir_pallas.py) at FIR_GEOMS (batch, N, K, D): mode 0's RF legs at
# C=512, benchmarks/micro_fir.py's 128 rows, test_fir_pallas.py's four, 37
# ragged rows; B14's plan swept at FIR_GEOMS[0] over FIR_SWEEP's tiles,
# outputs a pass and ring stages
AB_MODES, AB_BLOCK = (0, 1), 2
AB_POWER, AB_TOL, AB_PREV_TOL = 1e-3, 1e-3, 1e-5
FIR_TOL = 2e-4
FIR_GEOMS = (((2 * C,), 76800, 101, 10), ((128,), 76800, 101, 10),
             ((2, 2), 76800, 101, 10), ((3,), 640, 101, 5),
             ((), 1280, 7, 2), ((5,), 256, 33, 4), ((37,), 15310, 101, 10))
FIR_SWEEP = dict(tile=(512, 1024, 1920), sub=(256, 512), stages=(1, 2, 3))
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
B2_RAGGED = (37, 1531)  # B2 at mode 0: 32 + 5 rows, N = 11 x 128 + 123, odd
# B8 (phase 5) at 32 + 5 rows, N no multiple of 16 or of the 128-step
# tile, split_at at 0, a tile boundary, strictly inside a tile and N, with
# an INVALID run over the tile boundaries at 128 and 256 in every third row
# from row 1 and one row INVALID throughout
B8_RAGGED, B8_SPLITS = (37, 1531), (0, 128, 1000, 1531)
B8_INVALID = (100, 300)
# B9 and B9-expand at modes 0 and 1: 32 + 5 streams, m = 2 x 128 + 127 span
# steps (odd: 4-byte copies), NaN spans over the tile boundary at 128 in
# every third row from row 1
B9_RAGGED, B9_NAN = (37, 383), (120, 136)
# B1 / B6 at modes 0 and 1: 37 rows, n_out = two tiles + 60 (the last
# tile shorter than the band filters' 100-sample history)
FRONT_RAGGED_ROWS, FRONT_RAGGED_LAST = 37, 60
# B3 / B4 / B5 also at 32 + 5 rows (a short last row group of a pinned
# plan of row groups of 2, whose tiles of these many cycles leave a last
# tile shorter than the rest; B3 at one output a thread, two cycles of 16
# outputs, the leads at work at D = 8), at C=1 and (B4) at the sharded
# step's mini warm-up of SH_HALO_IF inputs
RESAMPLE_RAGGED_ROWS = 37
RESAMPLE_PINNED = {("B4", 0): dict(cycles=7), ("B4", 2): dict(cycles=4),
                   ("B5", 2): dict(cycles=5), ("B5", 3): dict(cycles=3),
                   ("B3", 0): dict(cycles=7, shape=(1, 2)),
                   ("B3", 1): dict(cycles=7, shape=(1, 2))}
SH_HALO_IF = 1920       # parallel/sharded.py's auto halo at mode 0
_PLAN_SWEEP: list = []  # B3 / B4 / B5: every plan timed (_plan_sweep)
PROFILE_REPS = 20       # calls under torch.profiler for the kernel alone
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


def _channels(stream, cfg, dev, c_all=C):
    """[N_BLOCKS, c_all, block_size] u8 on ``dev``: channel c is the
    broadcast from byte ``SHIFT * c`` on, with I and Q swapped on odd
    channels, so that no two rows of any kernel's inputs, tails or carries
    are equal.  Channel 0 is the broadcast itself.  ``stream``: [N_BLOCKS
    + 1, block_size] u8, the spare block covering the largest shift."""
    import torch
    flat = torch.from_numpy(stream.ravel()).to(dev)
    n = N_BLOCKS * cfg.block_size
    assert SHIFT * (c_all - 1) <= flat.numel() - n
    blocks = torch.empty(N_BLOCKS, c_all, cfg.block_size, dtype=torch.uint8,
                         device=dev)
    for c in range(c_all):
        blocks[:, c] = flat[SHIFT * c:SHIFT * c + n].view(N_BLOCKS, -1)
    odd = blocks[:, 1::2].view(N_BLOCKS, c_all // 2, -1, 2)
    blocks[:, 1::2] = odd.flip(-1).reshape(N_BLOCKS, c_all // 2, -1)
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


@functools.lru_cache(maxsize=1)
def _device_kernels() -> dict:
    """Each kernel wrapper's ``__global__`` function, as its name stands
    in ``torch.profiler``'s device events (a part of the demangled name
    no other kernel's holds)."""
    from dy4tpu_torch.ops import (backend_cuda, channelizer_cuda, fft_cuda,
                                  fir_cuda, frontend_cuda, pll_cuda,
                                  resample_cuda)
    return {
        frontend_cuda.fused_frontend_full: "frontend_full_kernel",
        frontend_cuda.fused_frontend_full.corr: "frontend_full_kernel",
        frontend_cuda.fused_frontend_if: "frontend_if_kernel",
        pll_cuda.phase_scan: "pll_phase_scan_kernel",
        pll_cuda.phase_scan_target: "pll_span_scan_kernel",
        pll_cuda.phase_scan_target.expand: "pll_span_expand_kernel",
        pll_cuda.phase_scan_coded: "pll_phase_scan_coded_kernel",
        backend_cuda.fused_audio_backend: "audio_rational_kernel",
        resample_cuda.fused_audio_backend_rational: "audio_rational_kernel",
        resample_cuda.fused_rds_backend: "rds_backend_kernel",
        channelizer_cuda.channelize_branches: "channelizer_kernel",
        fft_cuda.fft: "fft_stockham_kernel",
        frontend_cuda.fused_frontend_raw: "rf_tile_kernel",
        frontend_cuda.fused_frontend: "rf_tile_kernel",
        frontend_cuda.fused_frontend_raw_pm: "rf_tile_kernel",
        fir_cuda.block_fir_decim: "fir_decim_kernel",
    }


def _kernel_device_ms(fn, wrapper, reps: int = PROFILE_REPS):
    """The kernel alone: mean device milliseconds of one launch of
    ``wrapper``'s CUDA kernel over ``reps`` calls of ``fn`` (one launch
    each) under ``torch.profiler``, the wrapper's host work and the torch
    ops around the launch left out.  The mean is over the launches the
    profiler recorded (it can miss a few of the first).  None where the
    profiler shows no device time; raises where it shows device time but
    none of this kernel's, or more launches than calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    name = _device_kernels()[wrapper]
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_us = lambda e: getattr(e, "device_time_total", 0.0)  # noqa: E731
    if not any(device_us(e) > 0 for e in events):
        return None
    mine = [e for e in events if name in e.key]
    count = sum(e.count for e in mine)
    if not 0 < count <= reps:
        raise AssertionError(f"{name}: {count} device events in {reps} "
                             f"calls under the profiler")
    return sum(device_us(e) for e in mine) / count / 1e3


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
    phase: str = "phase 2"

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
        # a profiler session now and then records no device time: up to
        # three
        for _ in range(3):
            kernel_ms = _kernel_device_ms(self.kern, self.wrapper)
            if kernel_ms is not None:
                break
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
        _say(f"{self.phase}: {self.kernel} {self.geometry}: max |kernel - "
             f"plain| {self.err:.3g} (tolerance {self.tol:g}); kernel "
             f"{ms:.4f} ms (alone "
             + ("not measured" if kernel_ms is None else f"{kernel_ms:.4f}")
             + f" ms), plain {plain_ms:.4f} ms"
             + ("" if library_ms is None else f", library {library_ms:.4f} "
                "ms") + f"; bound {bound_ms:.4f} ms by {bound_by} "
             f"({self.nbytes / 1e6:.1f} MB, {self.flops / 1e9:.2f} GFLOP)"
             f"{note} at {self.where} ({smi})")
        return dict(name=f"{self.kernel.split()[1]}:{self.geometry}",
                    route="cuda", source=self.source,
                    replaces=self.replaces, max_abs_err=self.err,
                    tolerance=self.tol, ms=ms,
                    kernel_device_ms=("not measured" if kernel_ms is None
                                      else kernel_ms), plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms, mode=mode, wrapper=self.wrapper,
                    **self.extra)


def _front_flops(cfg, c: int, rds: bool, rf: bool, corr: bool = False,
                 n=None):
    """Float operations of the front half per block of ``n`` IF samples
    (the mode's by default): per IF sample the RF LPF on both legs
    (``rf``), the demod (about 9), the band bank and, with RDS, squaring
    and the carrier BPF; ``corr`` adds the 14 moments and the correction
    (about 30)."""
    kb = cfg.num_taps
    per = 9 + (3 if rds else 2) * kb * 2
    if rds:
        per += 1 + kb * 2
    if rf:
        per += 2 * cfg.num_taps * 2
    if corr:
        per += 30
    return c * (cfg.if_per_block if n is None else n) * per


def _front_corr_pair(label, fargs, corr, rds):
    """B1 (its corr variant with ``corr``) and its plain version on
    ``fargs`` (the eleven tensors and the decimation of
    ``fused_frontend_full``); raises unless the new RF tails are equal.
    Returns both output tuples."""
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
    _say(f"phase 2: {label}: moments {list(k_mom.shape)} within a relative "
         f"{rel:.3g} "
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


def _front_plan(cfg) -> None:
    """B1 / B6's tile plan at the mode's block: the wrapper's shared
    memory per block must equal the kernel's own formula and stay within
    60 KB, and a row must spread over more than one block."""
    from dy4tpu_torch.ops import frontend_cuda as fc
    from dy4tpu_torch.runtime import kernels
    import ctypes
    rds = cfg.supports_rds
    kb = cfg.num_taps
    smem = kernels.load("frontend").dy4_frontend_smem
    smem.argtypes = [ctypes.c_int] * 7
    smem.restype = ctypes.c_longlong
    for what, k, d, corr in (("B1", cfg.num_taps, cfg.rf_decim, 0),
                             ("B1-corr", cfg.num_taps, cfg.rf_decim, 1),
                             ("B6", 0, 1, 0)):
        plan = fc._tile_plan(cfg.if_per_block, d, k, kb, rds)
        need = smem(plan.tile, plan.sub, d, k, kb, int(rds), corr)
        mine = fc._smem_bytes(plan, d, k, kb, rds, bool(corr))
        _say(f"phase 2: {what} mode{cfg.mode} plan: {plan.n_tiles} tiles of "
             f"{plan.tile} (halo {plan.halo}, RF passes of {plan.sub}), "
             f"{need} bytes of shared memory a block")
        if need != mine or need > 60 * 1024 or plan.n_tiles < 2:
            raise AssertionError(f"{what} mode{cfg.mode}: plan {plan}, "
                                 f"{need} bytes of shared memory a block "
                                 f"(the wrapper's formula {mine})")


def _front_cut_rows(cfg, params, fargs, corr, label) -> list:
    """B1, B1-corr and B6 against their plain versions at a cut geometry,
    ``fargs`` as for ``fused_frontend_full`` (B6 on the plain RF stage's
    IF I/Q of the same rows): outputs within 1e-5, iq_tail and B6's
    prev_i/prev_q equal, the moments within ``MOM_TOL``.  Returns the
    rows."""
    import torch
    from dy4tpu_torch.ops import frontend_cuda
    rds = cfg.supports_rds
    blk = fargs[0]
    c, bs = blk.shape
    n = bs // 2 // cfg.rf_decim
    geom = f"mode{cfg.mode} {label} [{c}, {n}] decim {cfg.rf_decim} rds={rds}"
    where = f"C={c}"
    src, rep = "dy4tpu_torch/csrc/frontend.cu", "dy4tpu/ops/frontend_pallas.py"
    _distinct_rows(f"B1 {label}", *fargs[:1], *fargs[4:11])
    k_out, p_out = _front_corr_pair(f"B1 {geom}", fargs, None, rds)
    b1_in = fargs[:11] if rds else fargs[:3] + fargs[4:9]
    rows = [_Row(
        "B1 frontend", geom, src, f"{rep}:693",
        frontend_cuda.fused_frontend_full, _max_err(k_out, p_out), 1e-5,
        lambda: frontend_cuda.fused_frontend_full(*fargs, rds=rds),
        lambda: frontend_cuda.fused_frontend_full_plain(*fargs, rds=rds),
        where=where, nbytes=_nbytes(b1_in, k_out),
        flops=_front_flops(cfg, c, rds, rf=True, n=n))]
    k_out, p_out = _front_corr_pair(f"B1 corr {geom}", fargs, corr, rds)
    mom_rel = _moments_rel_err(f"B1 corr {geom}", blk, params, cfg,
                               fargs[4], k_out[12], p_out[12])
    rows.append(_Row(
        "B1 frontend_corr", geom, src, f"{rep}:693",
        frontend_cuda.fused_frontend_full.corr,
        _max_err(k_out[:12], p_out[:12]), 1e-5,
        lambda: frontend_cuda.fused_frontend_full(*fargs, rds=rds, corr=corr),
        lambda: frontend_cuda.fused_frontend_full_plain(*fargs, rds=rds,
                                                        corr=corr),
        where=where, nbytes=_nbytes(b1_in, corr, k_out),
        flops=_front_flops(cfg, c, rds, rf=True, corr=True, n=n),
        extra=dict(mom_rel_err=mom_rel)))
    i_if, q_if, _ = frontend_cuda.rf_lpf_plain(blk, params.rf_coeff,
                                               fargs[4], cfg.rf_decim)
    iargs = (i_if.contiguous(), q_if.contiguous(), *fargs[5:7],
             params.bank_coeff, params.rds_carrier_coeff, *fargs[7:11])
    k_out = frontend_cuda.fused_frontend_if(*iargs, rds=rds)
    p_out = frontend_cuda.fused_frontend_if_plain(*iargs, rds=rds)
    torch.cuda.synchronize()
    if not (torch.equal(k_out[5], p_out[5])
            and torch.equal(k_out[6], p_out[6])):
        raise AssertionError(f"B6 {geom}: prev_i/prev_q differ from the "
                             f"plain version")
    rows.append(_Row(
        "B6 frontend_if", geom, src, f"{rep}:881",
        frontend_cuda.fused_frontend_if, _max_err(k_out, p_out), 1e-5,
        lambda: frontend_cuda.fused_frontend_if(*iargs, rds=rds),
        lambda: frontend_cuda.fused_frontend_if_plain(*iargs, rds=rds),
        where=where,
        nbytes=_nbytes(iargs if rds else iargs[:5] + iargs[6:8], k_out),
        flops=_front_flops(cfg, c, rds, rf=False, n=n)))
    return rows


def _pll_case(cfg, st, pilot, carrier, dev):
    """The PLL scans' inputs at one mode from the front half's ``pilot``
    (and with RDS ``carrier``) and the receiver state ``st``: ``(x, lanes,
    state, consts, (kp, ki, dth) on the card, carry)``.  With RDS the
    pilot and carrier loops are stacked on a lane axis, as the receiver
    does; the carry's NCO angle, which runs free of the data, is drawn
    from a seed so that no two rows are equal."""
    import numpy as np
    import torch
    from dy4tpu_torch.ops import pll

    draw = np.random.default_rng(0)
    if cfg.supports_rds:
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
    return x, lanes, state, consts, (kp, ki, dth), carry


def _span_case(x, consts, dth, dev):
    """The span PLL's scan inputs from the PLL input ``x``: the span
    constants on the card and the span targets, with a dead (NaN) span in
    every row."""
    import torch
    from dy4tpu_torch.ops import pll

    _, *eff = pll._span_consts(*consts, SPAN)
    targets = pll._span_targets(x, dth, SPAN).contiguous()
    m = targets.shape[-1]
    rows_c = torch.arange(C, device=dev)
    targets[rows_c, ..., rows_c % m] = float("nan")
    return tuple(torch.as_tensor(v, device=dev) for v in eff), targets


def _ragged_span(targets, eff, carry, per_sample=()):
    """The span scans' ragged case cut from a full one: the first
    B9_RAGGED[0] streams (lanes flattened), the first B9_RAGGED[1] span
    steps, and NaN spans B9_NAN over a tile boundary in every third row
    from row 1.  Returns ``(targets, eff, carry, per_sample)`` with every
    constant one value a stream."""
    import torch

    rows, m = B9_RAGGED
    batch = targets.shape[:-1]
    def cut(a):
        return torch.broadcast_to(a, batch).reshape(-1)[:rows].contiguous()

    t = targets.reshape(-1, targets.shape[-1])[:rows, :m].clone()
    t[1::3, B9_NAN[0]:B9_NAN[1]] = float("nan")
    return (t, tuple(cut(a) for a in eff), tuple(cut(c) for c in carry),
            tuple(cut(a) for a in per_sample))


def _b9_row(label, targets, eff, carry, where=f"C={C}") -> "_Row":
    """B9 against its plain span scan on ``targets`` [..., M] with the
    span constants ``eff`` from ``carry``, bitwise (phi0, i0 and the end
    carry); raises otherwise.  Returns the row, the plain scan timed by
    its comparison call."""
    import torch
    from dy4tpu_torch.ops import pll_cuda

    kp_s, ki_s, dth_s = eff
    _distinct_rows("B9", torch.nan_to_num(targets, nan=9.0), *carry)
    k_res = pll_cuda.phase_scan_target(targets, kp_s, ki_s, dth_s, carry,
                                       span=SPAN)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    p_res = pll_cuda.phase_scan_target_plain(targets, kp_s, ki_s, dth_s,
                                             carry, span=SPAN)
    stop.record()
    torch.cuda.synchronize()
    k_flat = (k_res[0], k_res[1], *k_res[2])
    p_flat = (p_res[0], p_res[1], *p_res[2])
    if not all(torch.equal(a, b) for a, b in zip(k_flat, p_flat)):
        raise AssertionError(f"B9 {label} {list(targets.shape)} span PLL is "
                             f"not bitwise equal to its plain version: max "
                             f"|dphi0| {_max_err(k_flat, p_flat)}")
    return _Row(
        "B9 pll_span", f"{label} {list(targets.shape)} span {SPAN}",
        "dy4tpu_torch/csrc/pll.cu", "dy4tpu/ops/pll_pallas.py:278",
        pll_cuda.phase_scan_target, _max_err(k_flat, p_flat), 0.0,
        lambda: pll_cuda.phase_scan_target(targets, kp_s, ki_s, dth_s,
                                           carry, span=SPAN),
        plain_ms=start.elapsed_time(stop), where=where,
        nbytes=_nbytes(targets, kp_s, ki_s, dth_s, carry, k_flat),
        flops=B9_STEP_OPS * targets.numel(), chain_steps=targets.shape[-1])


def _b2_row(label, x, kp, ki, dth, carry, where=f"C={C}",
            phase="phase 2") -> "_Row":
    """B2 against its plain scan on ``x`` [..., N] from ``carry``, bitwise
    (phases and the end carry); raises otherwise.  Returns the row, the
    plain scan timed by its comparison call (a Python loop of launches,
    seconds per call)."""
    import torch
    from dy4tpu_torch.ops import pll_cuda

    _distinct_rows("B2", x, *carry)
    k_phi, k_c = pll_cuda.phase_scan(x, kp, ki, dth, carry)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    p_phi, p_c = pll_cuda.phase_scan_plain(x, kp, ki, dth, carry)
    stop.record()
    torch.cuda.synchronize()
    if not (torch.equal(k_phi, p_phi)
            and all(torch.equal(a, b) for a, b in zip(k_c, p_c))):
        raise AssertionError(f"B2 {label} {list(x.shape)} PLL is not bitwise "
                             f"equal to its plain version: max |dphi| "
                             f"{_max_err([k_phi], [p_phi])}")
    return _Row(
        "B2 pll", f"{label} {list(x.shape)}", "dy4tpu_torch/csrc/pll.cu",
        "dy4tpu/ops/pll_pallas.py:278", pll_cuda.phase_scan,
        _max_err((k_phi, *k_c), (p_phi, *p_c)), 0.0,
        lambda: pll_cuda.phase_scan(x, kp, ki, dth, carry),
        plain_ms=start.elapsed_time(stop), where=where,
        nbytes=_nbytes(x, kp, ki, dth, carry, k_phi, k_c),
        flops=B2_STEP_OPS * x.numel(), chain_steps=x.shape[-1], phase=phase)


def _rate(which: str, args) -> tuple[int, int]:
    """``(U, D)`` of a B3 / B4 / B5 call on ``args`` (the wrapper's; B3's
    end with D alone)."""
    return (1, args[-1]) if which == "B3" else (args[-2], args[-1])


def _rational_flops(which: str, args) -> float:
    """Float operations of one B3 / B4 / B5 call on ``args`` (the
    wrapper's): the mix, 2 x ceil(K/U) MACs an output of each leg, B4's
    RRC (2 x K2 MACs an output of each leg), B3's and B5's matrix."""
    c, n = args[0].shape
    (up, down), k = _rate(which, args), args[3].numel()
    m = n * up // down
    per_out = -(-k // up)
    if which == "B4":
        return c * (2 * n + 2 * m * per_out * 2
                    + 2 * m * args[4].numel() * 2)
    return c * (2 * n + 2 * m * per_out * 2 + 2 * m)


def _entry_ms(which: str, args, plan, reps: int = 20) -> float:
    """Mean milliseconds of one B3 / B4 / B5 launch under ``plan`` on
    ``args`` (the wrapper's), by CUDA events around ``reps`` back-to-back
    calls of the C entry point with its arguments built once: the host
    issues a launch in well under the kernel's time, so the events time
    the card.  Raises when a launch is refused."""
    import torch
    from dy4tpu_torch.ops import resample_cuda as rc
    from dy4tpu_torch.runtime import kernels
    b4 = which == "B4"
    c, n = args[0].shape
    up, down = _rate(which, args)
    k = args[3].numel()
    s = (k - 1) // up
    m = n * up // down
    shapes = (((c, m),) * 2 + ((c, s),) * 2 + ((c, args[4].numel() - 1),) * 2
              if b4 else ((c, m),) * 3 + ((c, s),) * 2)
    outs = [torch.empty(sh, device=args[0].device) for sh in shapes]
    geom = (c, n, up, down, k) + ((args[4].numel(),) if b4 else ())
    fn = (kernels.entry("rds_backend", "dy4_rds_backend", rc._ARGS) if b4
          else kernels.entry("audio_rational", "dy4_audio_rational",
                             rc._AUDIO_ARGS))
    call = (*(t.data_ptr() for t in args[:9 if b4 else 6]),
            *(t.data_ptr() for t in outs), *geom,
            *rc._plan_args(plan, up, down),
            torch.cuda.current_stream().cuda_stream)
    for _ in range(3):
        kernels.check_launch(fn(*call), f"{which} {plan}")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    status = [fn(*call) for _ in range(reps)]
    stop.record()
    torch.cuda.synchronize()
    for st in status:
        kernels.check_launch(st, f"{which} {plan}")
    return start.elapsed_time(stop) / reps


def _plan_sweep(which: str, mode: int, args) -> None:
    """Every plan ``resample_cuda._candidates`` weighs for B3 / B4 / B5 on
    ``args`` (the mode's full geometry), each timed (_entry_ms); the rows
    go to _PLAN_SWEEP for the fit of the plan's cost model, and the plan
    the model picks is printed beside the fastest (B3: and beside the
    fastest plan of one output a thread and one tuple a cycle, the first
    design's shape, which B5's kernel took at U = 1 before it learnt
    cycles of several tuples)."""
    from dy4tpu_torch.ops import resample_cuda as rc
    c, n = args[0].shape
    up, down = _rate(which, args)
    k2 = args[4].numel() if which == "B4" else 0
    rows = [dict(kernel=which, mode=mode, cost=cost, plan=plan,
                 ms=_entry_ms(which, args, plan))
            for cost, plan in rc._candidates(c, n, up, down, args[3].numel(),
                                             k2, rc._sms(args[0].device))]
    fastest = min(rows, key=lambda r: r["ms"])
    picked = min(rows, key=lambda r: r["cost"].clocks())
    _PLAN_SWEEP.extend(rows)
    if which == "B3":
        first = min((r for r in rows if r["plan"].span == 1),
                    key=lambda r: r["ms"])
        _say(f"phase 2: B3 mode{mode}: the fastest plan of one output a "
             f"thread and a cycle of one output {first['ms']:.4f} ms "
             f"({first['plan'].rows} rows x {first['plan'].cycles} cycles, "
             f"chunk {first['plan'].chunk})")
    _say(f"phase 2: {which} mode{mode} plan sweep: {len(rows)} plans, each "
         f"timed by CUDA events over 20 back-to-back launches; the plan's "
         f"pick {picked['ms']:.4f} ms ({picked['plan'].rows} rows x "
         f"{picked['plan'].cycles} cycles, {picked['plan'].phases} "
         f"positions x {picked['plan'].chunk} cycles a thread), the fastest "
         f"{fastest['ms']:.4f} ms ({fastest['plan'].rows} x "
         f"{fastest['plan'].cycles}, {fastest['plan'].phases} x "
         f"{fastest['plan'].chunk}, span {fastest['plan'].span}): "
         f"{picked['ms'] / fastest['ms']:.3f}x")


def _plan_fit() -> None:
    """The fit of the plan's cost model (its four clock constants,
    ``resample_cuda._Cost``) to every plan _plan_sweep timed, by least
    squares of the log of the time; the fit's correlation and the one of
    the constants in use, and at each geometry swept the plan each picks,
    against the fastest."""
    import numpy as np
    from scipy.optimize import least_squares
    from dy4tpu_torch.ops import resample_cuda as rc
    clocks = np.array([r["ms"] for r in _PLAN_SWEEP]) * 1e-3 * \
        _max_sm_clock_hz()
    rounds, wf, rrc, copy = (np.array([getattr(r["cost"], f) for r in
                                       _PLAN_SWEEP], float)
                             for f in rc._Cost._fields)

    def model(x):
        return (rounds * np.maximum(x[0] * wf + x[1] * rrc + x[2],
                                    x[3] * copy) + x[3] * copy)

    in_use = [rc._WF_CLK, rc._RRC_CLK, rc._ITEM_CLK, rc._COPY_CLK]
    fit = least_squares(lambda x: np.log(model(x)) - np.log(clocks),
                        in_use, bounds=(0, np.inf)).x
    picks = []
    for key in dict.fromkeys((r["kernel"], r["mode"]) for r in _PLAN_SWEEP):
        at = [i for i, r in enumerate(_PLAN_SWEEP)
              if (r["kernel"], r["mode"]) == key]
        fastest = min(clocks[i] for i in at)
        picks.append(f"{key[0]} mode{key[1]} " + " / ".join(
            f"{clocks[min(at, key=lambda i: m[i])] / fastest:.3f}x"
            for m in (model(np.array(in_use)), model(fit))))
    _say(f"phase 2: the plan's cost model over {len(_PLAN_SWEEP)} plans: "
         f"fitted _WF_CLK {fit[0]:.4g}, _RRC_CLK {fit[1]:.4g}, _ITEM_CLK "
         f"{fit[2]:.4g}, _COPY_CLK {fit[3]:.4g} (correlation "
         f"{np.corrcoef(model(fit), clocks)[0, 1]:.3f}); in use "
         f"{', '.join(map(str, in_use))} (correlation "
         f"{np.corrcoef(model(np.array(in_use)), clocks)[0, 1]:.3f}); each "
         f"geometry's pick against its fastest plan, constants in use / "
         f"fitted: {'; '.join(picks)}")


def _rational_rows(which: str, cfg, args, k_out) -> list:
    """B4 (``args`` as ``fused_rds_backend`` takes them, ``k_out`` its
    output on them), B5 or B3 at the mode's full geometry, then at a
    ragged 37 rows (a short last row group under a pinned plan of row
    groups of 2), at the CLI's C=1 and (B4 at mode 0) at the sharded
    step's mini warm-up of 1920 inputs: each within 1e-5 of the plain
    version with the input tails bit-equal, its plan printed; and, at 37
    rows, the wrapper's plan and the pinned one bitwise equal.  Returns
    the rows."""
    import torch
    from dy4tpu_torch.ops import backend_cuda
    from dy4tpu_torch.ops import resample_cuda as rc
    b4 = which == "B4"
    wrap, plain, launch, name = {
        "B4": (rc.fused_rds_backend, rc.fused_rds_backend_plain,
               rc._rds_launch, ("B4 rds_backend",
                                "dy4tpu_torch/csrc/rds_backend.cu",
                                "dy4tpu/ops/resample_pallas.py:275")),
        "B5": (rc.fused_audio_backend_rational,
               rc.fused_audio_backend_rational_plain, rc._audio_launch,
               ("B5 audio_rational", "dy4tpu_torch/csrc/audio_rational.cu",
                "dy4tpu/ops/resample_pallas.py:173")),
        "B3": (backend_cuda.fused_audio_backend,
               backend_cuda.fused_audio_backend_plain, rc._audio_launch,
               ("B3 audio_backend", "dy4tpu_torch/csrc/audio_rational.cu",
                "dy4tpu/ops/backend_pallas.py:93"))}[which]
    exact = (2, 3) if b4 else (3, 4)
    n_t = 9 if b4 else 6                       # tensors before the rate
    up, down = _rate(which, args)
    rate = (down,) if which == "B3" else (up, down)
    k, k2 = args[3].numel(), (args[4].numel() if b4 else 0)
    mode = f"mode{cfg.mode}"
    sms = rc._sms(args[0].device)
    rows_out = []
    cuts = [("", C, None), (" ragged", RESAMPLE_RAGGED_ROWS, None),
            (" CLI", 1, None)]
    if b4 and cfg.mode == 0:
        cuts.append((" warm-up", SH_C, SH_HALO_IF))
    for label, c, n_in in cuts:
        n = args[0].shape[1] if n_in is None else n_in
        cut = tuple(t if t.dim() == 1 else
                    (t[:c, :n] if t.shape[1] == args[0].shape[1] else t[:c])
                    .contiguous() for t in args[:n_t]) + rate
        got = k_out if not label else wrap(*cut)
        want = plain(*cut)
        torch.cuda.synchronize()
        if not all(torch.equal(got[i], want[i]) for i in exact):
            raise AssertionError(f"{which} {mode}{label}: input tails differ "
                                 f"from the plain version")
        plan = rc._tile_plan(c, n, up, down, k, k2, sms=sms)
        geometry = (f"{mode} D={down}{label}" if which == "B3" else
                    f"{mode} {up}/{down}{label}")
        _say(f"phase 2: {which} {geometry} [{c}, {n}] plan: {plan.items} "
             f"items of {plan.rows} rows x {plan.n_tiles} tiles of "
             f"{plan.cycles} cycles of {plan.span} ({plan.tile} outputs, "
             f"halo {plan.halo}), {plan.phases} positions x {plan.chunk} "
             f"cycles a thread, leads (k // {plan.lead_group}) % "
             f"{plan.lead_mod}, {plan.compute_threads} of {plan.threads} "
             f"threads computing, {plan.ctas} blocks, {plan.smem} bytes of "
             f"shared memory a block")
        extra = dict(plan=plan._asdict())
        if not label:
            _plan_sweep(which, cfg.mode, cut)
        if label == " ragged":
            other = rc._tile_plan(c, n, up, down, k, k2, sms=sms, rows=2,
                                  **RESAMPLE_PINNED[which, cfg.mode])
            alt = launch(cut[:n_t], up, down, other)
            torch.cuda.synchronize()
            if other == plan or not all(torch.equal(a, b)
                                        for a, b in zip(got, alt)):
                raise AssertionError(f"{which} {geometry}: the plans "
                                     f"{plan} and {other} do not give the "
                                     f"same bits")
            _say(f"phase 2: {which} {geometry}: the wrapper's plan and a "
                 f"plan of row groups of 2 (the last one short) and tiles "
                 f"of {other.cycles} cycles of {other.span} ({other.phases} "
                 f"x {other.chunk} a thread) give bitwise-equal outputs and "
                 f"tails")
            extra["two_plans_bitwise"] = True
        rows_out.append(_Row(
            name[0], geometry, *name[1:], wrap, _max_err(got, want), 1e-5,
            lambda cut=cut: wrap(*cut), lambda cut=cut: plain(*cut),
            where=f"C={c}", nbytes=_nbytes(cut[:n_t], got),
            flops=_rational_flops(which, cut), extra=extra))
    return rows_out


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

    _front_plan(cfg)
    if cfg.mode in OPT_MODES:
        # the tiling's edges, B1, B1-corr and B6: a ragged geometry whose
        # last tile is shorter than the band history, and the CLI's one
        # channel
        from dy4tpu_torch.ops.frontend_cuda import _tile_plan
        rg = FRONT_RAGGED_ROWS
        n_r = 2 * frontend_cuda.TILE + FRONT_RAGGED_LAST
        plan = _tile_plan(n_r, cfg.rf_decim, cfg.num_taps, cfg.num_taps, rds)
        last = n_r - (plan.n_tiles - 1) * plan.tile
        if not 0 < last < cfg.num_taps - 1:
            raise AssertionError(f"[{rg}, {n_r}]: the last tile holds "
                                 f"{last} samples, not fewer than the band "
                                 f"history")
        cut = lambda t, r: (  # noqa: E731
            None if t is None else t[:r].contiguous())
        for label, r, n_b in (("ragged", rg, n_r),
                              ("CLI", 1, cfg.if_per_block)):
            args = (blk[:r, :2 * cfg.rf_decim * n_b].contiguous(),
                    *fargs[1:4], *(cut(t, r) for t in fargs[4:11]),
                    cfg.rf_decim)
            rows += _front_cut_rows(cfg, params, args, cut(corr, r), label)

    x, lanes, state, consts, (kp, ki, dth), carry = _pll_case(
        cfg, st, pilot, carrier, dev)
    rows.append(_b2_row(mode, x, kp, ki, dth, carry))
    if cfg.mode == 0:
        # B2 at a ragged geometry (rows not a multiple of the block's 32,
        # N not a multiple of 4 or of the 128-step tile) and at the CLI's
        # one channel
        rg, rn = B2_RAGGED
        rows.append(_b2_row(
            "ragged", x[:rg, 0, :rn].contiguous(), kp[0], ki[0], dth[0],
            tuple(c[:rg, 0].contiguous() for c in carry), where="pilot rows"))
        rows.append(_b2_row("CLI", x[:1].contiguous(), kp, ki, dth,
                            tuple(c[:1].contiguous() for c in carry),
                            where="C=1"))

    if cfg.mode in OPT_MODES:
        # B9: the span PLL's scan over the broadcast's span targets, with
        # the span constants and a dead (NaN) span in every row; then at
        # a ragged geometry
        eff, targets = _span_case(x, consts, dth, dev)
        rows.append(_b9_row(mode, targets, eff, carry))
        cut = _ragged_span(targets, eff, carry)[:3]
        rows.append(_b9_row(f"{mode} ragged", *cut, where="streams"))
        del targets

    nco_i2, nco_q2, _ = pll.pll(x, state, fs=cfg.if_fs, impl="kernel",
                                **lanes)
    if rds:
        nco = nco_i2[:, 0].contiguous()
        nco_i = nco_i2[:, 1].contiguous()
        nco_q = nco_q2[:, 1].contiguous()
    else:
        nco = nco_i2.contiguous()
    bs = rx.back_state_of(st)
    aargs = (fmd, stereo, nco, params.audio_coeff, bs.mono_tail.contiguous(),
             bs.stereo_tail.contiguous())
    if cfg.audio_up == 1:
        aargs += (cfg.audio_down,)
        wrap = backend_cuda.fused_audio_backend
        plain = backend_cuda.fused_audio_backend_plain
        name = "B3"
    else:
        aargs += (cfg.audio_up, cfg.audio_down)
        wrap = resample_cuda.fused_audio_backend_rational
        plain = resample_cuda.fused_audio_backend_rational_plain
        name = "B5"
    _distinct_rows(name, *aargs[:3], *aargs[4:6])
    k_out = wrap(*aargs)
    p_out = plain(*aargs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k_out[3:], p_out[3:])):
        raise AssertionError(f"{name} {mode}: tails differ from the plain "
                             f"version")
    rows += _rational_rows(name, cfg, aargs, k_out)
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
        rows += _rational_rows("B4", cfg, rargs, k_out)
        del k_out, p_out

    return [r.finish(smi, cfg.mode) for r in rows]


def _zero(wrappers) -> None:
    """Set every wrapper's launch count to 0, the card idle."""
    import torch
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()


def _launches_off(wrappers, want: dict) -> dict:
    """{name: (got, expected)} of every wrapper whose launches since
    ``_zero`` differ from ``want`` (0 for those not named)."""
    return {w.__name__: (w.launches, want.get(w, 0)) for w in wrappers
            if w.launches != want.get(w, 0)}


def _path(cfg, entry: str = "rf", span: bool = False, corr: bool = False,
          front: str = "auto", span_emit: str = "torch"):
    """The kernel wrappers a mode's main path launches: ``entry`` "rf"
    (``receiver_step``), "if" (``receiver_step_if``) or "wideband"
    (``wideband_step``: the channelizer, then the IF entry); ``span``
    (the span PLL: B9 for B2, B9-expand with ``span_emit="kernel"``),
    ``corr`` (the IQ tracker: B1's corr variant for B1) and ``front``
    (an A/B front end: B11 for "fused-rf", B12 for "fused-phase") are the
    options of the RF entry."""
    from dy4tpu_torch.ops import (backend_cuda, channelizer_cuda,
                                  frontend_cuda, pll_cuda, resample_cuda)
    if entry == "rf":
        front = {"auto": (frontend_cuda.fused_frontend_full.corr if corr
                          else frontend_cuda.fused_frontend_full),
                 "fused-rf": frontend_cuda.fused_frontend_raw,
                 "fused-phase": frontend_cuda.fused_frontend}[front]
    else:
        front = frontend_cuda.fused_frontend_if
    audio = (backend_cuda.fused_audio_backend if cfg.audio_up == 1
             else resample_cuda.fused_audio_backend_rational)
    pll_kernel = (pll_cuda.phase_scan if not span
                  else pll_cuda.phase_scan_target.expand
                  if span_emit == "kernel" else pll_cuda.phase_scan_target)
    path = [front, pll_kernel, audio]
    if cfg.supports_rds:
        path.append(resample_cuda.fused_rds_backend)
    if entry == "wideband":
        path.insert(0, channelizer_cuda.channelize_branches)
    return path


def _run_path(label, cfg, run, all_wrappers, entry="rf",
              n_blocks=N_BLOCKS, phase="phase 3", **features):
    """Zero every launch count, ``run()``, and check that each kernel of
    the path (``_path(cfg, entry, **features)``) launched on every one of
    ``n_blocks`` blocks and no other kernel launched.  Returns ``(run's
    result, {wrapper: launches})``."""
    import torch
    _zero(all_wrappers)
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
    _say(f"{phase}: {label}: launches " + ", ".join(
        f"{w.__name__} {n}" for w, n in counts.items() if w in path)
        + f" ({secs:.2f} s, first run)")
    return out, counts


def _check_outputs(label, cfg, outs, phase="phase 3") -> dict:
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
    _say(f"{phase}: {label}: channel 0 decoded: separation L "
         f"{got['sep_l_db']:.1f} dB, R {got['sep_r_db']:.1f} dB"
         + (f", PI {got['pi']}, PS {got['ps']!r} ({got['groups']} groups)"
            if rds else ""))
    return got


def _compare_chain(label, cfg, outs, ref, n_blocks,
                   rows=f"channels {CHAIN_ROWS}", phase="phase 3") -> None:
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
    _say(f"{phase}: {label}, {rows}, blocks 0-{n_blocks - 1}: max |err| "
         f"{msg}")
    if max(errs.values()) > CHAIN_TOL or sym_agree < SYM_AGREE:
        raise AssertionError(f"{label}: departs beyond the chain "
                             f"tolerance ({CHAIN_TOL:g} on audio and "
                             f"baseband, {SYM_AGREE:.0%} of RDS symbols)")


def _select(outs, sel):
    from dy4tpu_torch.pipeline import receiver as rx
    return rx.StepOutputs(*(None if f is None else f[:, sel] for f in outs))


def _device_split(label, run, n_blocks, unit="block",
                  phase="phase 3") -> None:
    """One more warm ``run()`` under ``torch.profiler``: print the device
    time a block (``unit``), the sum of the device events' durations, and
    each hand-written kernel's part of it, the torch ops' the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_us = lambda e: getattr(e, "device_time_total", 0.0)  # noqa: E731
    busy = sum(device_us(e) for e in events) / 1e3 / n_blocks
    if not busy > 0:
        _say(f"{phase}: {label}: the profiler shows no device time "
             f"(device split not measured)")
        return
    parts = {}
    for name in sorted(set(_device_kernels().values())):
        ms = sum(device_us(e) for e in events if name in e.key) / 1e3
        if ms > 0:
            parts[name] = ms / n_blocks
    rest = busy - sum(parts.values())
    _say(f"{phase}: {label}: device busy {busy:.4f} ms a {unit} under "
         f"torch.profiler (one warm run of {n_blocks}): "
         + ", ".join(f"{k} {v:.4f} ({v / busy:.1%})"
                     for k, v in parts.items())
         + f", torch ops {rest:.4f} ({rest / busy:.1%})")


def _chain_rate(label, cfg, run, t0, smi) -> float:
    """Time a second, warm ``run()`` and print the chain rate, then split
    a third run's device time by kernel.  Returns the rate in MS/s."""
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
    _device_split(label, run, N_BLOCKS)
    return msps


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


def _run_mode(mode, dev, smi, all_wrappers, rates: dict) -> list[dict]:
    """Phases 2 and 3 at one mode (and the IF entry where B6 is checked).
    Returns the mode's JSON entries, each with the launches of the run
    whose path holds its kernel; puts the chain rate in ``rates[mode]``."""
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
    rates[mode] = _chain_rate(
        label, cfg, lambda: rx.run_blocks(params, state, blocks, cfg), t0,
        smi)
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


def _b7_other_plan(bands: int, m: int, c: int, t: int, sms: int):
    """A second plan of B7, unlike the wrapper's own: units of another R,
    blocks of another size, tiles about half as long and about half the
    SMs' blocks."""
    from dy4tpu_torch.ops import channelizer_cuda as chc
    own = chc._tile_plan(bands, m, c, t, sms)
    tile = min(m, own.tile // 2 + 3)
    items = bands * -(-m // tile)
    other = chc._tile_plan(bands, m, c, t, sms,
                           rows=8 if own.rows != 8 else 16, tile=tile,
                           threads=128 if own.threads != 128 else 512,
                           ctas=max(1, min(items, sms // 2 + 1)))
    assert other != own
    return own, other


def _b7_outputs(args):
    """Fresh outputs of B7 on ``args`` (the wrapper's): w and the two
    tails."""
    import torch
    x, p, ti, tq = args
    (bands, n2), c = x.shape, p.shape[0]
    return (torch.empty(bands, n2 // (2 * c), 2 * c, device=x.device),
            torch.empty_like(ti), torch.empty_like(tq))


def _b7_entry(args, outs, plan) -> int:
    """One launch of B7's C entry point under ``plan`` on ``args`` into
    ``outs``; its status."""
    import torch
    from dy4tpu_torch.ops import channelizer_cuda as chc
    x, p = args[:2]
    return chc._entry()(*(a.data_ptr() for a in args),
                        *(o.data_ptr() for o in outs),
                        chc._launch_array(*x.shape, *p.shape, plan),
                        torch.cuda.current_stream().cuda_stream)


@functools.lru_cache(maxsize=1)
def _l2_flush():
    """A buffer of twice the card's L2 cache: reading it before a launch
    leaves none of the launch's inputs in L2, and no dirty line for the
    launch to write back."""
    import torch
    props = torch.cuda.get_device_properties(0)
    n = 2 * getattr(props, "L2_cache_size", 50 * 2 ** 20)
    return torch.empty(n, dtype=torch.uint8, device="cuda")


def _cold_ms(launch, wrapper):
    """A kernel alone from a cold L2: mean device milliseconds of
    ``wrapper``'s kernel under ``torch.profiler``, each call of ``launch``
    (one launch) after a read of ``_l2_flush()`` (whose own time is left
    out).  Up to three profiler sessions; None where none shows device
    time."""
    flush = _l2_flush()

    def call():
        flush.sum()
        launch()
    for _ in range(3):
        ms = _kernel_device_ms(call, wrapper)
        if ms is not None:
            return ms
    return None


def _b7_cold_ms(args, plan=None):
    """B7 alone from a cold L2 (``_cold_ms``) under ``plan`` (through the
    C entry point) or the wrapper's."""
    from dy4tpu_torch.ops import channelizer_cuda as chc
    from dy4tpu_torch.runtime import kernels
    outs = _b7_outputs(args)

    def launch():
        if plan is None:
            chc.channelize_branches(*args)
        else:
            kernels.check_launch(_b7_entry(args, outs, plan), f"B7 {plan}")
    return _cold_ms(launch, chc.channelize_branches)


def _b7_sweep(label: str, args) -> dict:
    """A short sweep of B7's plans on ``args`` (the wrapper's): the plan's
    pick and the plan at each R of ``ROWS`` and block of 128, 256 and 512
    threads, each alone from a cold L2 (``_b7_cold_ms``); the pick beside
    the fastest.  Returns the JSON keys of the geometry's row."""
    from dy4tpu_torch.ops import channelizer_cuda as chc
    x, p = args[:2]
    (bands, n2), (c, t) = x.shape, p.shape
    m, sms = n2 // (2 * c), chc._sms(x.device)
    pick = chc._tile_plan(bands, m, c, t, sms)
    plans = [pick] + [chc._tile_plan(bands, m, c, t, sms, rows=r, threads=nt)
                      for r in chc.ROWS for nt in (128, 256, 512)]
    plans = list(dict.fromkeys(plans))
    timed = [(plan, _b7_cold_ms(args, plan)) for plan in plans]
    measured = [(plan, ms) for plan, ms in timed if ms is not None]
    pick_ms = timed[0][1]
    fastest = min(measured, key=lambda r: r[1], default=(None, None))
    _say(f"phase 2: B7 {label} plan sweep: {len(plans)} plans, each alone "
         f"from a cold L2 under torch.profiler ({len(plans) - len(measured)}"
         f" not measured); the plan's pick "
         + ("not measured" if pick_ms is None else f"{pick_ms:.4f} ms")
         + f" ({_b7_plan_text(pick)}), the fastest "
         + ("none" if fastest[0] is None else
            f"{fastest[1]:.4f} ms ({_b7_plan_text(fastest[0])})")
         + ("" if pick_ms is None or fastest[0] is None
            else f": {pick_ms / fastest[1]:.3f}x"))
    return dict(sweep_plans=len(plans),
                sweep_pick_ms=("not measured" if pick_ms is None
                               else pick_ms),
                sweep_fastest_ms=("not measured" if fastest[0] is None
                                  else fastest[1]),
                sweep_fastest_plan=(None if fastest[0] is None
                                    else fastest[0]._asdict()))


def _b7_host_us(args, calls: int = 200) -> dict:
    """The wrapper's host time and its parts: mean microseconds of a call
    over ``calls`` calls issued back to back (the kernel, a few
    microseconds, never holds the queue); of its three output
    allocations, and of one allocation with the three as views of it; of
    its checks of the four inputs; of the C entry through ctypes (the
    pointers read, the launch); of reading the stream through PyTorch's
    public ``current_stream`` and through the raw getter
    ``kernels.stream_of`` uses.  The JSON keys of the geometry's row."""
    import torch
    from dy4tpu_torch.ops import channelizer_cuda as chc
    from dy4tpu_torch.runtime import kernels
    x, p, ti, tq = args
    (bands, n2), (c, t) = x.shape, p.shape
    m, k1, dev, f32 = n2 // (2 * c), c * t - 1, x.device, torch.float32
    outs = _b7_outputs(args)
    launch = chc._launch_args(bands, n2, c, t, chc._sms(dev))
    stream = kernels.stream_of(x)

    def mean_us(fn, n=calls):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    def one_alloc():
        buf = torch.empty(bands * (m * 2 * c + 2 * k1), dtype=f32,
                          device=dev)
        w, a, b = buf.split_with_sizes([bands * m * 2 * c, bands * k1,
                                        bands * k1])
        return w.view(bands, m, 2 * c), a.view(bands, k1), b.view(bands, k1)
    return dict(
        host_us=mean_us(lambda: chc.channelize_branches(*args)),
        alloc_us=mean_us(lambda: (
            torch.empty(bands, m, 2 * c, dtype=f32, device=dev),
            torch.empty(bands, k1, dtype=f32, device=dev),
            torch.empty(bands, k1, dtype=f32, device=dev))),
        one_alloc_us=mean_us(one_alloc),
        checks_us=mean_us(lambda: x.is_cuda and all(
            chc._takes(a, s, d, dev) for a, s, d in (
                (x, (bands, n2), torch.uint8), (p, (c, t), f32),
                (ti, (bands, k1), f32), (tq, (bands, k1), f32)))),
        entry_us=mean_us(lambda: chc._entry()(
            *(a.data_ptr() for a in args), *(o.data_ptr() for o in outs),
            launch, stream)),
        stream_public_us=mean_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream, 10000),
        stream_raw_us=mean_us(lambda: kernels.stream_of(x), 10000))


def _b7_plan_text(plan) -> str:
    return (f"R={plan.rows}, tiles of {plan.tile} rows x {plan.n_tiles} a "
            f"band, {plan.items} items, {plan.ctas} blocks of "
            f"{plan.threads}, {plan.smem} B shared")


def _check_channelizer(cfg, dev, smi) -> list[dict]:
    """Phase 2 of the wideband front door: B7 against its plain version at
    every geometry of ``WB_GEOMS`` on 32 band rows of mode 0's block, at
    the wideband tool's one band (C=8) and at 37 ragged bands, mid-stream
    (random u8 rows and tails from a seed), at B7_MORE, bitwise equal
    under a second plan, each also alone from a cold L2, with a plan sweep
    at B7_SWEEP, the wrapper's host time at the tool's band, and by CUDA
    events against conv1d, met or missed; and the kernel route of
    ``channelize_block_u8`` against its plain route with a per-band IQ
    correction.  Returns the JSON entries."""
    import torch
    from dy4tpu_torch.ops import channelizer as chz
    from dy4tpu_torch.ops import channelizer_cuda as chc
    from dy4tpu_torch.ops import iqcorr
    from dy4tpu_torch.runtime import kernels

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    geoms = ([(c, t, WB_BANDS, cfg.if_per_block, "") for c, t in WB_GEOMS]
             + [(WB_TOOL_C, WB_T, 1, cfg.if_per_block, ", 1 band (the tool)"),
                (WB_C, WB_T, *B7_RAGGED, f", {B7_RAGGED[0]} x "
                 f"{B7_RAGGED[1]} rows")]
             + [(c, t, bands, cfg.if_per_block, f", {bands} band"
                 + "s" * (bands > 1)) for c, t, bands in B7_MORE])
    for c, t, bands, m, label in geoms:
        p = chz.make_channelizer(c, cfg.if_fs, taps_per_branch=t,
                                 device=dev).p
        n2 = 2 * c * m
        x = torch.randint(0, 256, (bands, n2), generator=gen,
                          device=dev, dtype=torch.uint8)
        ti, tq = (torch.randn(bands, c * t - 1, generator=gen,
                              device=dev) for _ in range(2))
        args = (x, p, ti, tq)
        geometry = f"C={c} T={t}{label}"
        _distinct_rows("B7", x, ti, tq)
        own, other = _b7_other_plan(bands, m, c, t, chc._sms(dev))
        k_out = chc.channelize_branches(*args)
        o_out = _b7_outputs(args)
        kernels.check_launch(_b7_entry(args, o_out, other), f"B7 {other}")
        p_out = chc.channelize_branches_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k_out[1:], p_out[1:])):
            raise AssertionError(f"B7 {geometry}: tails differ from the "
                                 f"plain version")
        if not all(torch.equal(a, b) for a, b in zip(k_out, o_out)):
            raise AssertionError(f"B7 {geometry}: two plans give other bits")
        _say(f"phase 2: B7 {geometry}: plan {_b7_plan_text(own)}; a second "
             f"plan ({_b7_plan_text(other)}) gives the same bits")
        del o_out
        # 1e-5: T float32 products summed in the same order, maybe fused
        conv = _branch_conv1d(*args[:1], p, ti, tq)
        w_conv = conv().transpose(1, 2)
        conv_err = _max_err([w_conv], [p_out[0]])
        if not conv_err <= 1e-5:
            raise AssertionError(f"B7 {geometry}: the conv1d yardstick "
                                 f"departs by {conv_err:.3g}")
        del w_conv
        extra = dict(kernel_cold_ms=_b7_cold_ms(args) or "not measured")
        if (bands, c, t) in B7_SWEEP:
            extra.update(_b7_sweep(geometry, args))
        if (bands, c, t) == (1, WB_TOOL_C, WB_T):
            extra.update(_b7_host_us(args))
            _say(f"phase 2: B7 {geometry}: the wrapper's host time "
                 f"{extra['host_us']:.1f} us a call; its three output "
                 f"allocations {extra['alloc_us']:.1f} us (one allocation "
                 f"and three views {extra['one_alloc_us']:.1f}), its "
                 f"checks {extra['checks_us']:.1f}, the C entry through "
                 f"ctypes {extra['entry_us']:.1f}; the stream read through "
                 f"torch.cuda.current_stream {extra['stream_public_us']:.2f}"
                 f" us, through the raw getter "
                 f"{extra['stream_raw_us']:.2f} us")
        rows.append(_Row(
            "B7 channelizer", geometry,
            "dy4tpu_torch/csrc/channelizer.cu",
            "dy4tpu/ops/channelizer.py:344", chc.channelize_branches,
            _max_err(k_out, p_out), 1e-5,
            lambda a=args: chc.channelize_branches(*a),
            lambda a=args: chc.channelize_branches_plain(*a),
            where=f"{bands} bands x {n2} bytes",
            nbytes=_nbytes(args, k_out),
            flops=2 * k_out[0].numel() * t, library=conv, extra=extra))
        del k_out, p_out
    out = [r.finish(smi, cfg.mode) for r in rows]
    del rows
    for r in out:
        r["beats_conv1d_by_events"] = r["ms"] < r["library_ms"]
        _say(f"phase 2: B7 {r['name'].split(':', 1)[1]} by CUDA events: "
             f"the wrapper {r['ms']:.4f} ms, conv1d {r['library_ms']:.4f} "
             f"ms: faster than conv1d "
             + ("met" if r["beats_conv1d_by_events"] else "missed")
             + "; alone from a cold L2 "
             + (r["kernel_cold_ms"] if isinstance(r["kernel_cold_ms"], str)
                else f"{r['kernel_cold_ms']:.4f} ms"))

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


def _check_b2_wideband(cfg, params, chan, blocks, dev) -> "_Row":
    """B2 at the wideband step's geometry, on its own PLL input: the
    pilot and RDS carrier of every channel of every band at step 2 (two
    ``wideband_step`` calls bring the state mid-stream), through the
    channelizer and the IF entry's front half, as ``receiver_step_if``
    gives them to B2.  Bitwise against the plain scan."""
    from dy4tpu_torch.ops import channelizer as chz
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.pipeline import wideband as wb

    if WB_BANDS * WB_C != C:
        raise AssertionError("_pll_case draws one NCO angle a channel of C")
    st = wb.wideband_init(cfg, chan, (WB_BANDS,))
    for b in range(2):
        st, _ = wb.wideband_step(params, chan, st, blocks[b], cfg)
    (y_i, y_q), _ = chz.channelize_block_u8(chan, st.chan, blocks[2])
    flat = lambda a: a.reshape(-1, *a.shape[2:])  # noqa: E731
    rx_st = wb._map(flat, st.rx)
    _, fo = rx.front_step_if(params, rx.front_state_of(rx_st),
                             flat(y_i).contiguous(), flat(y_q).contiguous(),
                             cfg)
    x, _, _, _, (kp, ki, dth), carry = _pll_case(
        cfg, rx_st, fo.pilot.contiguous(), fo.carrier.contiguous(), dev)
    return _b2_row("wideband", x, kp, ki, dth, carry,
                   where=f"{WB_BANDS} bands x {WB_C} channels")


def _run_wideband(dev, smi, all_wrappers) -> list[dict]:
    """The wideband front door: phases 2, 3 and 3b.  Returns B7's JSON
    entries and B2's at the wideband geometry, each with the launches of
    the phase-3 run."""
    import torch
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import afc
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
    results.append(_check_b2_wideband(cfg, params, chan, blocks, dev).finish(
        smi, cfg.mode))

    def run():
        st = wb.wideband_init(cfg, chan, (WB_BANDS,))
        return wb.run_wideband_blocks(params, chan, st, blocks, cfg)

    t0 = time.perf_counter()
    label = f"wideband {WB_BANDS} bands x {WB_C} channels"
    (_, outs), counts = _run_path(label, cfg, run, all_wrappers,
                                  entry="wideband", n_blocks=WB_STEPS)
    for r in results:
        r["launches"] = counts[r["wrapper"]]
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
    _device_split(label, run, WB_STEPS, unit="step")

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


def _profile(fn, kernel: str = "") -> tuple[float, int, int, float]:
    """One call of ``fn`` under ``torch.profiler``: (device busy ms, the
    sum of the device events' durations; the number of device events;
    the number of top-level torch ops the host issued; the ms of the
    device events whose name holds ``kernel``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = sum(1 for e in events if e.name.startswith("aten::")
              and e.cpu_parent is None)
    mine = sum(e.time_range.elapsed_us() for e in dev
               if kernel and kernel in e.name)
    return (sum(e.time_range.elapsed_us() for e in dev) / 1e3, len(dev),
            ops, mine / 1e3)


def _check_b8(cfg, params, blocks, halo_if, dev) -> list:
    """Phase 5's kernel check: B8 at the sharded path's shape, codes
    [SH_C, 2, halo_if + SH_S * N] of the broadcast's PLL inputs (the pilot
    and RDS carrier rows from B1 over the first blocks, every row its own
    channel), every SH_PREFIX_EVERY-th row from row 1 INVALID over its
    first halo_if samples (as in the stream's first replay) and row SH_C-2
    INVALID throughout (a padding row), from per-row carries, split where
    the receiver splits.  Held bitwise to its plain version, and on the
    valid samples to B2 run over the float32 samples the codes came from:
    phases, the carry at the split and at the end.  Then the ragged case
    on the same inputs (``_check_b8_ragged``).  Returns the two rows."""
    import numpy as np
    import torch
    from dy4tpu_torch.ops import pll, pll_cuda
    from dy4tpu_torch.pipeline import receiver as rx

    n_if = cfg.if_per_block
    m = halo_if + SH_S * n_if
    split = SH_S * n_if                    # T * S * N on one card
    st = rx.front_state_of(rx.init_state(cfg, (SH_C,), device=dev))
    xs = []
    for b in range(-(-m // n_if)):
        st, fo = rx.front_step(params, st, blocks[b], cfg)
        xs.append(torch.stack([fo.pilot, fo.carrier], dim=-2))
    x = torch.cat(xs, -1)[..., :m].contiguous()          # [C, 2, m] f32
    codes = pll.encode_sign(x)
    rows = torch.arange(SH_C, device=dev)
    prefix = rows % SH_PREFIX_EVERY == 1
    dead = SH_C - 2
    codes[prefix, :, :halo_if] = pll.CODE_INVALID
    codes[dead] = pll.CODE_INVALID
    draw = np.random.default_rng(5)
    carry = tuple(torch.from_numpy(draw.uniform(lo, hi, (SH_C, 2)).astype(
        np.float32)).to(dev) for lo, hi in ((-1e-3, 1e-3), (0, 4 * np.pi),
                                            (0, 4 * np.pi)))
    _distinct_rows("B8", codes, *carry)
    consts = pll._loop_consts(
        np.array([cfg.pll_freq, cfg.rds_pll_freq], np.float32), cfg.if_fs,
        np.array([cfg.pll_bandwidth, cfg.rds_pll_bandwidth], np.float32))
    kp, ki, dth = (torch.as_tensor(v, device=dev) for v in consts)
    k_phi, k_mid, k_end = pll_cuda.phase_scan_coded(codes, kp, ki, dth,
                                                    carry, split_at=split)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    p_phi, p_mid, p_end = pll_cuda.phase_scan_coded_plain(
        codes, kp, ki, dth, carry, split_at=split)
    stop.record()
    torch.cuda.synchronize()
    k_flat, p_flat = (k_phi, *k_mid, *k_end), (p_phi, *p_mid, *p_end)
    if not all(torch.equal(a, b) for a, b in zip(k_flat, p_flat)):
        raise AssertionError(f"B8 is not bitwise equal to its plain "
                             f"version: max |dphi| "
                             f"{_max_err(k_flat, p_flat)}")
    # against B2 over the samples the codes came from: the rows without a
    # prefix from sample 0, those with one from halo_if on
    live = rows != dead
    for sel, lo in ((live & ~prefix, 0), (live & prefix, halo_if)):
        cr = tuple(c[sel].contiguous() for c in carry)
        b_phi, b_end = pll_cuda.phase_scan(x[sel][..., lo:].contiguous(),
                                           kp, ki, dth, cr)
        _, b_mid = pll_cuda.phase_scan(x[sel][..., lo:split].contiguous(),
                                       kp, ki, dth, cr)
        torch.cuda.synchronize()
        if not (torch.equal(k_phi[sel][..., lo:], b_phi)
                and all(torch.equal(a[sel], b) for a, b in
                        zip(k_mid + k_end, b_mid + b_end))):
            raise AssertionError(f"B8 departs from B2 on the samples its "
                                 f"codes came from (rows from sample {lo})")
    frozen = carry[2][dead] + carry[1][dead]
    if not (all(torch.equal(a[dead], b[dead]) for a, b in zip(k_end, carry))
            and bool((k_phi[dead] == frozen[:, None]).all())):
        raise AssertionError("B8: the INVALID row moved its carry")
    _say(f"phase 5: B8 [{SH_C}, 2, {m}] split at {split}: bitwise equal to "
         f"its plain version, and to B2 on the float32 samples (rows "
         f"{int((live & ~prefix).sum())} from sample 0, "
         f"{int((live & prefix).sum())} after a {halo_if}-sample INVALID "
         f"prefix), phases and both carries; the INVALID row kept its "
         f"carry")
    return [_Row(
        "B8 pll_coded", f"mode0 {list(codes.shape)}",
        "dy4tpu_torch/csrc/pll.cu", "dy4tpu/ops/pll_pallas.py:308",
        pll_cuda.phase_scan_coded, _max_err(k_flat, p_flat), 0.0,
        lambda: pll_cuda.phase_scan_coded(codes, kp, ki, dth, carry,
                                          split_at=split),
        plain_ms=start.elapsed_time(stop), where=f"C={SH_C}",
        nbytes=_nbytes(codes, kp, ki, dth, carry, k_flat),
        flops=B2_STEP_OPS * x.numel(), chain_steps=m, phase="phase 5"),
        _check_b8_ragged(x, kp, ki, dth)]


def _check_b8_ragged(x, kp, ki, dth) -> "_Row":
    """B8 at B8_RAGGED, cut from phase 5's PLL inputs ``x`` [SH_C, 2, m]
    (pilot rows), with the INVALID run B8_INVALID over two tile boundaries
    in every third row from row 1 and row 2 INVALID throughout, from
    per-row carries, at every split_at of B8_SPLITS: bitwise equal to its
    plain version, and to B2 on the float32 samples the codes came from
    (the rows without INVALID codes whole; the rows with the run before it,
    then the frozen carry's phase across it, then after it), phases and
    both carries.  Returns the row, timed at the split inside a tile."""
    import numpy as np
    import torch
    from dy4tpu_torch.ops import pll, pll_cuda

    (rows_n, n), (lo, hi), dead = B8_RAGGED, B8_INVALID, 2
    xr = x[:rows_n, 0, :n].contiguous()
    codes = pll.encode_sign(xr)
    run = torch.arange(rows_n, device=x.device) % 3 == 1
    clean = ~run
    clean[dead] = False
    codes[run, lo:hi] = pll.CODE_INVALID
    codes[dead] = pll.CODE_INVALID
    draw = np.random.default_rng(6)
    carry = tuple(torch.from_numpy(draw.uniform(a, b, rows_n).astype(
        np.float32)).to(x.device) for a, b in ((-1e-3, 1e-3), (0, 4 * np.pi),
                                               (0, 4 * np.pi)))
    kp, ki, dth = kp[0], ki[0], dth[0]
    _distinct_rows("B8 ragged", codes, *carry)

    def b2(sel, t0, t1, c):
        return pll_cuda.phase_scan(xr[sel, t0:t1].contiguous(), kp, ki, dth,
                                   c)

    def rows_of(sel, c):
        return tuple(a[sel].contiguous() for a in c)

    c_clean, c_run = rows_of(clean, carry), rows_of(run, carry)
    b_phi, b_end = b2(clean, 0, n, c_clean)
    a_phi, at_lo = b2(run, 0, lo, c_run)            # the carry at the run
    z_phi, z_end = b2(run, hi, n, at_lo)
    held = (at_lo[2] + at_lo[1])[:, None].expand(-1, hi - lo)
    want_run = torch.cat([a_phi, held, z_phi], -1)
    for split in B8_SPLITS:
        k_phi, k_mid, k_end = pll_cuda.phase_scan_coded(
            codes, kp, ki, dth, carry, split_at=split)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        p_phi, p_mid, p_end = pll_cuda.phase_scan_coded_plain(
            codes, kp, ki, dth, carry, split_at=split)
        stop.record()
        torch.cuda.synchronize()
        k_flat, p_flat = (k_phi, *k_mid, *k_end), (p_phi, *p_mid, *p_end)
        label = f"B8 ragged {list(codes.shape)} split at {split}"
        if not all(torch.equal(a, b) for a, b in zip(k_flat, p_flat)):
            raise AssertionError(f"{label}: not bitwise equal to its plain "
                                 f"version: max |dphi| "
                                 f"{_max_err(k_flat, p_flat)}")
        mid_clean = c_clean if split == 0 else b2(clean, 0, split, c_clean)[1]
        mid_run = (c_run if split == 0 else b2(run, 0, split, c_run)[1]
                   if split <= lo else at_lo if split <= hi
                   else b2(run, hi, split, at_lo)[1])
        torch.cuda.synchronize()
        frozen = carry[2][dead] + carry[1][dead]
        if not (torch.equal(k_phi[clean], b_phi)
                and torch.equal(k_phi[run], want_run)
                and all(torch.equal(a[clean], b) for a, b in
                        zip(k_mid + k_end, mid_clean + b_end))
                and all(torch.equal(a[run], b) for a, b in
                        zip(k_mid + k_end, mid_run + z_end))
                and all(torch.equal(a[dead], b[dead]) for a, b in
                        zip(k_mid + k_end, carry + carry))
                and bool((k_phi[dead] == frozen).all())):
            raise AssertionError(f"{label}: departs from B2 on the samples "
                                 f"its codes came from, or the INVALID "
                                 f"codes moved the carry")
        if split == B8_SPLITS[2]:
            row = (k_flat, p_flat, start.elapsed_time(stop))
    _say(f"phase 5: B8 ragged {list(codes.shape)}, split at "
         f"{', '.join(map(str, B8_SPLITS))}: bitwise equal to its plain "
         f"version, and to B2 on the float32 samples ({int(clean.sum())} "
         f"rows whole, {int(run.sum())} around an INVALID run over "
         f"[{lo}, {hi})), phases and both carries; the INVALID row kept "
         f"its carry")
    k_flat, p_flat, plain_ms = row
    return _Row(
        "B8 pll_coded", f"ragged {list(codes.shape)}",
        "dy4tpu_torch/csrc/pll.cu", "dy4tpu/ops/pll_pallas.py:308",
        pll_cuda.phase_scan_coded, _max_err(k_flat, p_flat), 0.0,
        lambda: pll_cuda.phase_scan_coded(codes, kp, ki, dth, carry,
                                          split_at=B8_SPLITS[2]),
        plain_ms=plain_ms, where="pilot rows",
        nbytes=_nbytes(codes, kp, ki, dth, carry, k_flat),
        flops=B2_STEP_OPS * codes.numel(), chain_steps=n, phase="phase 5")


def _run_sharded(dev, smi, all_wrappers) -> list[dict]:
    """Phase 5: the exact time-sharded receiver at mode 0 on one card
    (a 1x1 mesh) at ``bench.py``'s sharded point: B8 checked first
    (``_check_b8``); then SH_STEPS ``step`` calls over N_BLOCKS blocks x
    SH_C channels, every output bitwise equal to ``run_blocks`` over the
    same blocks on the card, B8 launched once per step and B1, B3, B4
    once per block and once per warm-up, nothing else; channel 0 decoded;
    then sharded against plain ``run_blocks`` as ``bench.py``'s
    ``_time_sharded`` times them, with B8's share of the sharded step's
    device time.  Returns B8's JSON entries (the path's geometry and the
    ragged one)."""
    import torch
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import (backend_cuda, frontend_cuda, mix,
                                  pll_cuda, resample_cuda)
    from dy4tpu_torch.parallel import ShardedReceiver, make_mesh
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.tx import fm

    assert SH_S * SH_STEPS == N_BLOCKS
    cfg = get_mode(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = rx.make_params(cfg, device=dev)
    blocks = _channels(fm.stereo_rds_broadcast(cfg, N_BLOCKS + 1), cfg, dev,
                       SH_C)
    chunks = [blocks[k * SH_S:(k + 1) * SH_S].permute(1, 0, 2)
              .reshape(SH_C, -1).contiguous() for k in range(SH_STEPS)]
    r = ShardedReceiver(cfg, make_mesh(), shard_blocks=SH_S)
    _say(f"setup phase 5: {N_BLOCKS} blocks x {SH_C} channels, "
         f"{SH_STEPS} chunks of {SH_S} blocks; halo {r.halo_if} IF "
         f"samples; {time.perf_counter() - t0:.1f} s")
    results = [row.finish(smi, cfg.mode)
               for row in _check_b8(cfg, params, blocks, r.halo_if, dev)]

    def run():
        carry = r.init(SH_C)
        outs = []
        for chunk in chunks:
            carry, out = r.step(params, carry, chunk)
            outs.append(out)
        return outs

    _zero(all_wrappers)
    t1 = time.perf_counter()
    outs = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    counts = {w: w.launches for w in all_wrappers}
    per_step = SH_S + 1                              # the warm-up, S blocks
    want = {frontend_cuda.fused_frontend_full: SH_STEPS * per_step,
            backend_cuda.fused_audio_backend: SH_STEPS * per_step,
            resample_cuda.fused_rds_backend: SH_STEPS * per_step,
            pll_cuda.phase_scan_coded: SH_STEPS}
    off = _launches_off(all_wrappers, want)
    if off:
        raise AssertionError(f"phase 5: launches (got, expected): {off}")
    _say("phase 5: launches over " + f"{SH_STEPS} steps: " + ", ".join(
        f"{w.__name__} {n}" for w, n in counts.items() if n)
         + f"; none of B2, B9 or the others ({secs:.2f} s, first run)")
    for result in results:
        result["launches"] = counts[pll_cuda.phase_scan_coded]

    got = {f: torch.cat([getattr(o, f) for o in outs], -1)
           for f in outs[0]._fields if getattr(outs[0], f) is not None}
    del outs
    _, seq = rx.run_blocks(params, rx.init_state(cfg, (SH_C,), device=dev),
                           blocks, cfg)
    stream = lambda x: x.movedim(0, -2).reshape(SH_C, -1)  # noqa: E731
    want_out = {f: stream(getattr(seq, f))
                for f in ("mono", "left", "right", "rds_symbols")}
    want_out["pcm"] = mix.quantize_s16(mix.interleave(want_out["left"],
                                                      want_out["right"]))
    want_out["rds_resync"] = seq.rds_resync.movedim(0, -1)
    want_out["rds_offset"] = seq.rds_offset.movedim(0, -1)
    del seq
    if got.keys() != want_out.keys():
        raise AssertionError(f"phase 5: fields {sorted(got)} against "
                             f"{sorted(want_out)}")
    for f, v in want_out.items():
        if got[f].shape != v.shape:
            raise AssertionError(f"phase 5: sharded {f} {tuple(got[f].shape)}"
                                 f" against run_blocks' {tuple(v.shape)}")
        if not torch.equal(got[f], v):
            raise AssertionError(f"phase 5: sharded {f} is not bitwise equal "
                                 f"to run_blocks': max |err| "
                                 f"{_max_err([got[f]], [v])}")
    for f in got:
        if got[f].is_floating_point() and not bool(
                torch.isfinite(got[f]).all()):
            raise AssertionError(f"phase 5: non-finite {f}")
    _say(f"phase 5: {N_BLOCKS} blocks x {SH_C} channels through "
         f"{SH_STEPS} steps: every field ({', '.join(want_out)}) bitwise "
         f"equal to run_blocks over the same blocks on the card")
    dec = fm.check_reception(
        cfg, got["left"][0].view(N_BLOCKS, -1).cpu().numpy(),
        got["right"][0].view(N_BLOCKS, -1).cpu().numpy(),
        got["rds_symbols"][0].view(N_BLOCKS, -1).cpu().numpy(),
        got["rds_resync"][0].cpu().numpy())
    _say(f"phase 5: channel 0 decoded: separation L {dec['sep_l_db']:.1f} "
         f"dB, R {dec['sep_r_db']:.1f} dB, PI {dec['pi']}, PS "
         f"{dec['ps']!r} ({dec['groups']} groups)")
    del got

    # bench.py's _time_sharded protocol on one card: the plain scan over
    # one chunk's S blocks against one sharded step on the same chunk,
    # state and carry threaded through, warm; medians of RATE_REPS, the
    # two sides alternating which goes first
    chunk_blocks = blocks[:SH_S].contiguous()
    st = rx.init_state(cfg, (SH_C,), device=dev)
    carry = r.init(SH_C)
    samples = SH_C * SH_S * cfg.iq_per_block
    rates = {"plain": [], "sharded": []}

    def timed(side):
        nonlocal st, carry
        torch.cuda.synchronize()
        t = time.perf_counter()
        if side == "plain":
            st, _ = rx.run_blocks(params, st, chunk_blocks, cfg)
        else:
            carry, _ = r.step(params, carry, chunks[0])
        torch.cuda.synchronize()
        rates[side].append(samples / (time.perf_counter() - t) / 1e6)

    timed("plain")
    timed("sharded")
    for v in rates.values():                          # the warm-up
        v.clear()
    for k in range(RATE_REPS):
        for side in (("plain", "sharded") if k % 2 == 0
                     else ("sharded", "plain")):
            timed(side)
    med = {k: sorted(v)[len(v) // 2] for k, v in rates.items()}
    eff = med["sharded"] / med["plain"]
    b8 = _device_kernels()[pll_cuda.phase_scan_coded]
    prof = {"plain": _profile(lambda: rx.run_blocks(params, st, chunk_blocks,
                                                    cfg)),
            "sharded": _profile(lambda: r.step(params, carry, chunks[0]),
                                b8)}
    busy, b8_ms = prof["sharded"][0], prof["sharded"][3]
    if not 0 < b8_ms < busy:
        raise AssertionError(f"phase 5: B8 {b8_ms:.4f} ms of a sharded step's "
                             f"{busy:.4f} ms device busy under the profiler")
    _say("phase 5: one warm call of each under torch.profiler, device busy "
         "(CUDA kernel and copy time), device events, top-level torch ops: "
         + "; ".join(f"{k} {v[0]:.3f} ms, {v[1]} events, {v[2]} ops"
                     for k, v in prof.items())
         + f"; B8 {b8_ms:.4f} ms of the sharded step's device busy "
         f"({b8_ms / busy:.1%})"
         + "; wall without the profiler (median): "
         + ", ".join(f"{k} {samples / med[k] / 1e3:.3f} ms" for k in med))
    _say(f"phase 5: exact time-sharded receiver on one card, C={SH_C}, "
         f"S={SH_S}, halo {r.halo_if}: sharded {med['sharded']:.1f} MS/s, "
         f"plain run_blocks {med['plain']:.1f} MS/s, efficiency {eff:.3f} "
         f"(medians of {RATE_REPS}; sharded runs "
         f"{', '.join(f'{v:.1f}' for v in rates['sharded'])}; plain "
         f"{', '.join(f'{v:.1f}' for v in rates['plain'])}); peak device "
         f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase 5 "
         f"{time.perf_counter() - t0:.1f} s on {smi}")
    results[0].update(sharded_eff_1dev=eff, sharded_step_device_ms=busy,
                      b8_step_device_ms=b8_ms, b8_step_share=b8_ms / busy)
    return results


def _check_fft(blocks, dev) -> list:
    """Phase 6's kernel checks: B10 at every N of FFT_NS on FFT_ROWS
    distinct rows, real and complex (the real input timed), and at the PSD
    path's geometry: the Hann-windowed RF I of mode-0 block PSD_BLOCK over
    C channels, C x 150 segments of N = 512, real.  Each within FFT_TOL of
    the plain version's largest magnitude, against the plain version and
    against ``torch.fft.fft`` (cuFFT, the yardstick).  Returns the rows."""
    import math

    import torch
    from dy4tpu_torch.ops import fft as fft_ops
    from dy4tpu_torch.ops import fft_cuda

    def check(name, x):
        k = fft_cuda.fft(x)
        p = fft_cuda.fft_four_step(x)
        lib = torch.fft.fft(x)
        torch.cuda.synchronize()
        scale = float(p.abs().max())
        err = float((k - p).abs().max())
        err_lib = float((k - lib).abs().max())
        _say(f"phase 6: B10 {name}: max |kernel - plain| / max |plain| "
             f"{err / scale:.3g}, against torch.fft.fft {err_lib / scale:.3g} "
             f"(tolerance {FFT_TOL:g})")
        if not (err <= FFT_TOL * scale and err_lib <= FFT_TOL * scale):
            raise AssertionError(f"B10 {name}: departs beyond {FFT_TOL:g} of "
                                 f"the largest magnitude {scale:.4g}")
        return err, scale, k

    def row(geometry, x, err, scale, k, where, rel):
        n = x.shape[-1]
        return _Row(
            "B10 fft", geometry, "dy4tpu_torch/csrc/fft.cu",
            "dy4tpu/ops/fft_pallas.py:103", fft_cuda.fft, err,
            FFT_TOL * scale, lambda: fft_cuda.fft(x),
            lambda: fft_cuda.fft_four_step(x), where=where,
            nbytes=_nbytes(x, k), flops=5 * n * math.log2(n) * (x.numel() // n),
            library=lambda: torch.fft.fft(x), phase="phase 6",
            extra=dict(rel_err=rel))

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    rows = []
    for n in FFT_NS:
        x = torch.randn(FFT_ROWS, n, generator=gen, device=dev)
        xc = torch.complex(torch.randn(FFT_ROWS, n, generator=gen,
                                       device=dev),
                           torch.randn(FFT_ROWS, n, generator=gen,
                                       device=dev))
        _distinct_rows("B10", x, xc)
        err_c, scale_c, _ = check(f"N={n} complex [{FFT_ROWS}, {n}]", xc)
        err, scale, k = check(f"N={n} real [{FFT_ROWS}, {n}]", x)
        rows.append(row(f"N={n}", x, err, scale, k,
                        f"{FFT_ROWS} rows, real",
                        max(err / scale, err_c / scale_c)))
        del xc
    x = (blocks[PSD_BLOCK].to(torch.float32) - 128.0) / 128.0
    segs = x[:, 0::2].reshape(x.shape[0], -1, PSD_NFFT) * torch.from_numpy(
        fft_ops.hann_sq(PSD_NFFT)).to(dev)
    segs = segs.reshape(-1, PSD_NFFT)
    _distinct_rows("B10", segs)
    err, scale, k = check(f"N={PSD_NFFT} [{segs.shape[0]}, {PSD_NFFT}] (the "
                          f"RF I PSD of {x.shape[0]} channels)", segs)
    rows.append(row(f"N={PSD_NFFT} x {segs.shape[0]} rows", segs, err, scale,
                    k, f"C={x.shape[0]} x {segs.shape[0] // x.shape[0]} "
                    f"segments, real", err / scale))
    return rows


def _psd_close(label, got, ref, tol_lin=PSD_LIN_TOL, tol_db=None) -> float:
    """Hold one PSD in dB to another.  With ``tol_db``, every bin within
    that many dB.  Otherwise linear power, 10^(dB/10), within ``tol_lin``
    of the row's peak: the dB of a deep Hann sidelobe turns a tiny
    absolute error into a large dB one, which the linear comparison
    weighs by the bin's power.  Returns the departure."""
    import torch
    got, ref = got.double().cpu(), ref.double().cpu()
    if tol_db is not None:
        both_inf = torch.isinf(got) & torch.isinf(ref) & (got == ref)
        err = float(torch.where(both_inf, 0.0, (got - ref).abs()).max())
        tol = tol_db
    else:
        g, r = 10.0 ** (got / 10), 10.0 ** (ref / 10)
        err = float(((g - r).abs() / r.amax(-1, keepdim=True)).max())
        tol = tol_lin
    _say(f"phase 6: {label}: {err:.3g} (tolerance {tol:g}"
         f"{' dB' if tol_db is not None else ' of the row peak'})")
    if not err <= tol:
        raise AssertionError(f"{label}: departs by {err:.3g} > {tol:g}")
    return err


def _psd_sane(psd) -> bool:
    """No NaN or +inf, and a finite peak in every row.  A bin may be -inf:
    where a float32 FFT rounds a bin some 180 dB under the row's peak to
    exactly 0 (dy4tpu's jnp.fft.fft does too), 10 log10 gives -inf."""
    import numpy as np
    psd = np.asarray(psd, np.float64)
    return bool(not np.isnan(psd).any() and not (psd == np.inf).any()
                and np.isfinite(psd.max(-1)).all())


def _tone_peaks(freq, psd_row, tones=(800.0, 2400.0)) -> list[float]:
    """The frequencies of the two strongest peaks of one PSD row (bins
    within 3 of the first masked before the second); raises unless each
    of ``tones`` lies within one bin of one of them."""
    import numpy as np
    p = np.asarray(psd_row, np.float64).copy()
    first = int(np.argmax(p))
    p[max(0, first - 3):first + 4] = -np.inf
    found = [float(freq[first]), float(freq[int(np.argmax(p))])]
    bin_hz = freq[1] - freq[0]
    for t in tones:
        if min(abs(f - t) for f in found) > bin_hz:
            raise AssertionError(f"PSD peaks {found} Hz: no peak within one "
                                 f"bin ({bin_hz:g} Hz) of {t:g} Hz")
    return found


def _run_psd(dev, smi, all_wrappers) -> list[dict]:
    """Phase 6: B10 and the PSD path, then psdview's computation and the
    capture tools on the card.  Returns B10's JSON entries, each with
    B10's launches over psdview's run."""
    import argparse

    import numpy as np
    import torch
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import (backend_cuda, fft as fft_ops, fft_cuda,
                                  frontend_cuda, pll_cuda, resample_cuda)
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.tools import psdview
    from dy4tpu_torch.tx import fm

    cfg = get_mode(0)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    blocks = _channels(fm.stereo_rds_broadcast(cfg, N_BLOCKS + 1), cfg, dev)
    rows = _check_fft(blocks, dev)
    results = [r.finish(smi, cfg.mode) for r in rows]
    del rows

    # ---- the PSD path over the receiver's outputs, C channels ----
    params = rx.make_params(cfg, device=dev)
    _, outs = rx.run_blocks(params, rx.init_state(cfg, (C,), device=dev),
                            blocks[:PSD_BLOCK + 1], cfg)
    x = (blocks[PSD_BLOCK].to(torch.float32) - 128.0) / 128.0
    del blocks
    signals = {"RF I": (x[:, 0::2], cfg.rf_fs),
               "rds_bb_i": (outs.rds_bb_i[PSD_BLOCK], cfg.rds_fs),
               "mono": (outs.mono[PSD_BLOCK], cfg.audio_fs)}
    psds = {}
    for name, (sig, fs) in signals.items():
        label = f"PSD of {name} {list(sig.shape)}"
        _zero(all_wrappers)
        freq, psd = fft_ops.estimate_psd(sig, nfft=PSD_NFFT, fs=fs)
        off = _launches_off(all_wrappers, {fft_cuda.fft: 1})
        if off:
            raise AssertionError(f"{label}: launches (got, expected): {off}")
        if not (psd.shape == (C, PSD_NFFT // 2) and psd.device == sig.device
                and _psd_sane(psd.cpu().numpy())):
            raise AssertionError(f"{label}: {tuple(psd.shape)} on "
                                 f"{psd.device}, or NaN / +inf / a row "
                                 f"without a finite peak")
        n_inf = int(torch.isinf(psd).sum())
        if n_inf:
            _say(f"phase 6: {label}: {n_inf} of {psd.numel()} bins at -inf "
                 f"(a bin rounded to 0 by the float32 FFT)")
        _, four = fft_ops.estimate_psd(sig, nfft=PSD_NFFT, fs=fs,
                                       impl="four_step")
        _psd_close(f"{label}: B10 against four_step on the card", psd, four)
        _, cpu = fft_ops.estimate_psd(sig[0].cpu(), nfft=PSD_NFFT, fs=fs)
        _psd_close(f"{label}: channel 0 against torch.fft.fft on the CPU",
                   psd[0], cpu)
        psds[name] = (freq, psd[0].cpu().numpy())
    peaks = _tone_peaks(*psds["mono"])
    _say(f"phase 6: channel 0's mono PSD peaks at {peaks} Hz (tones 800 and "
         f"2400 Hz, bins of {psds['mono'][0][1]:g} Hz)")
    noise = torch.randn(PSD_NOISE_ROWS, 4096, generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    _, pk = fft_ops.estimate_psd(noise, nfft=PSD_NFFT, fs=48e3)
    _, p4 = fft_ops.estimate_psd(noise, nfft=PSD_NFFT, fs=48e3,
                                 impl="four_step")
    _, pc = fft_ops.estimate_psd(noise.cpu(), nfft=PSD_NFFT, fs=48e3)
    label = f"PSD of white noise [{PSD_NOISE_ROWS}, 4096]: B10 against"
    _psd_close(f"{label} four_step on the card", pk, p4, tol_db=PSD_NOISE_DB)
    _psd_close(f"{label} torch.fft.fft on the CPU", pk, pc,
               tol_db=PSD_NOISE_DB)
    del outs, signals, x

    # ---- the capture tools as a user runs them, psdview's computation --
    def tools(*commands):
        """Run ``python -m <command>`` for each command at once; raise
        unless every one exits 0.  No process outlives the call."""
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-m", *c], cwd=REPO,
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE, text=True)
                 for c in commands]
        try:
            for c, proc in zip(commands, procs):
                _, err = proc.communicate(timeout=300)
                if proc.returncode != 0:
                    raise AssertionError(f"phase 6: python -m {' '.join(c)} "
                                         f"exited {proc.returncode}:\n"
                                         f"{err[-3000:]}")
                _say(f"phase 6: python -m {' '.join(c)} "
                     f"({time.perf_counter() - t0:.1f} s)")
        finally:
            for proc in procs:
                proc.kill()
                proc.wait()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        clean, fault = tmp / "clean.raw", tmp / "fault.raw"
        synth = "dy4tpu_torch.tools.synth"
        tools((synth, str(clean), "--mode", "0", "--blocks",
               str(TOOL_BLOCKS), "--pi", "0x54A7", "--ps", "DY4TPU"),
              (synth, str(fault), "--mode", "0", "--blocks",
               str(TOOL_BLOCKS), "--dc", "0.1", "-0.05", "--iq-imbalance",
               "0.75", "20", "--multipath", "24:0.4:120,60:0.2"))
        iq, iq_fault = (np.fromfile(f, np.uint8) for f in (clean, fault))
        if not (len(iq) == len(iq_fault) == TOOL_BLOCKS * cfg.block_size
                and not np.array_equal(iq, iq_fault)):
            raise AssertionError(f"phase 6: synth wrote {len(iq)} and "
                                 f"{len(iq_fault)} bytes (or equal ones)")

        # psdview's computation (its drawing needs matplotlib, which this
        # script does not require): the main path of this phase
        args = argparse.Namespace(infile=str(clean), blocks=PSD_VIEW_BLOCKS,
                                  nfft=PSD_NFFT, device="cuda")
        _zero(all_wrappers)
        t0 = time.perf_counter()
        frames, n = psdview._block_psds(args, cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        b10 = fft_cuda.fft.launches
        nb = PSD_VIEW_BLOCKS
        off = _launches_off(all_wrappers, {
            fft_cuda.fft: 3 * nb, frontend_cuda.fused_frontend_full: nb,
            pll_cuda.phase_scan: nb, backend_cuda.fused_audio_backend: nb,
            resample_cuda.fused_rds_backend: nb})
        if off or n != nb or len(frames) != nb:
            raise AssertionError(f"phase 6: psdview over {n} blocks: "
                                 f"launches (got, expected) {off}")
        for panel in frames[-1]:
            if not (panel[1].shape == (PSD_NFFT // 2,)
                    and _psd_sane(panel[1])):
                raise AssertionError("phase 6: psdview: a panel of the "
                                     "wrong shape, or NaN / +inf / no "
                                     "finite peak")
        view_peaks = _tone_peaks(frames[-1][2][0] * 1e3, frames[-1][2][1])
        _say(f"phase 6: psdview._block_psds over {nb} blocks of the synth "
             f"capture: B10 {b10} launches (3 a block), B1, B2, B3, B4 "
             f"{nb} each, nothing else; block {nb - 1}'s mono peaks at "
             f"{view_peaks} Hz ({secs:.2f} s)")
        for r in results:
            r["launches"] = b10

        # the receiver's CLI on the clean capture; ratechange on its first
        # RC_BLOCKS blocks on the card and on the CPU, all three at once
        iq[:RC_BLOCKS * cfg.block_size].tofile(tmp / "rc_in.raw")
        rc = "dy4tpu_torch.tools.ratechange"
        tools(("dy4tpu_torch", "0", "r", "--input", str(clean), "--output",
               str(tmp / "a.pcm"), "--rds-json", str(tmp / "events.jsonl")),
              *((rc, str(tmp / "rc_in.raw"), str(tmp / f"rc_{d}.raw"),
                 "--to", "1440", "--device", d) for d in ("cuda", "cpu")))
        events = [json.loads(line) for line in
                  (tmp / "events.jsonl").read_text().splitlines()]
        last = events[-1] if events else {}
        if not (last.get("pi") == "54A7"
                and last.get("ps", "").strip() == "DY4TPU"):
            raise AssertionError(f"phase 6: the CLI's RDS events on the "
                                 f"synth capture do not carry PI/PS: {last}")
        gpu, cpu = (np.fromfile(tmp / f"rc_{d}.raw", np.uint8)
                    for d in ("cuda", "cpu"))
        n_iq = RC_BLOCKS * cfg.iq_per_block
        want = 2 * (n_iq // 5 * 3)
        lsb = (int(np.abs(gpu.astype(np.int16) - cpu).max())
               if len(gpu) == len(cpu) else -1)
        if not (len(gpu) == len(cpu) == want and 0 <= lsb <= 1):
            raise AssertionError(f"phase 6: ratechange 2400 -> 1440 wrote "
                                 f"{len(gpu)} bytes on the card, {len(cpu)} "
                                 f"on the CPU (want {want}), max |diff| "
                                 f"{lsb}")
        _say(f"phase 6: synth ({TOOL_BLOCKS} blocks, and with --dc "
             f"--iq-imbalance --multipath) decoded by the CLI: PI "
             f"{last['pi']}, PS {last['ps']!r} ({len(events)} events); "
             f"ratechange 2400 -> 1440 over {RC_BLOCKS} blocks: {len(gpu)} "
             f"bytes, card and CPU within {lsb} LSB "
             f"({int((gpu != cpu).sum())} bytes differ)")
    _say(f"phase 6: peak device memory "
         f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase 6 "
         f"{time.perf_counter() - t_phase:.1f} s on {smi}")
    return results


def _ab_other_plan(n_out: int, decim: int, k: int):
    """A second plan for B11-B13, unlike the wrapper's: tiles of about a
    third of the row (its own less 5 where that is shorter), passes of 64
    outputs."""
    from dy4tpu_torch.ops import frontend_cuda as fc
    own = fc._rf_plan(n_out, decim, k)
    other = fc._rf_plan(n_out, decim, k, tile=max(1, min(
        own.tile - 5, n_out // 3 + 1)), sub=64)
    assert other != own
    return other


def _check_ab_b1(cfg, params, blk, st, b11) -> None:
    """B11 against B1's RF stage and demod from the same state: B11's
    fm[m - kb/2] is B1's fm_delayed[m], and its prev_i/prev_q and iq_tail
    B1's, bit for bit (one RF stage, rf_stage.cuh, one demod)."""
    import torch
    from dy4tpu_torch.ops import frontend_cuda as fc
    from dy4tpu_torch.pipeline import receiver as rx

    fs = rx.front_state_of(st)
    cont = lambda t: None if t is None else t.contiguous()  # noqa: E731
    b1 = fc.fused_frontend_full(
        blk, params.rf_coeff, params.bank_coeff, params.rds_carrier_coeff,
        *(cont(t) for t in (fs.rf.iq_tail, fs.rf.prev_i, fs.rf.prev_q,
                            fs.bank_tail, fs.mono_delay, fs.carrier_tail,
                            fs.rds_delay)),
        cfg.rf_decim, rds=cfg.supports_rds)
    torch.cuda.synchronize()
    dly = params.bank_coeff.shape[-1] // 2
    same = (torch.equal(b11[0][:, :-dly], b1[0][:, dly:])
            and all(torch.equal(a, b) for a, b in zip(b11[1:4], b1[5:8])))
    if not same:
        raise AssertionError(
            f"B11 mode{cfg.mode}: not B1's bits: fm "
            f"{_max_err([b11[0][:, :-dly]], [b1[0][:, dly:]]):.3g}, "
            f"iq_tail / prev {_max_err(b11[1:4], b1[5:8]):.3g}")
    _say(f"phase 7: B11 mode{cfg.mode}: fm[m - {dly}], prev_i/prev_q and "
         f"iq_tail bit for bit B1's fm_delayed[m], prev_i/prev_q and "
         f"iq_tail from the same state (C={C})")


def _check_ab_kernels(cfg, params, blocks, st, dev) -> list:
    """Phase 7's kernel checks at one mode, on block AB_BLOCK from the
    state ``st`` after the blocks before it (the loops locked in): B11,
    B12 and B13 each against its plain version at C=512, at 37 ragged rows
    (32 + 5, no multiple of the card's 132 SMs) and at C=1, and B12 and B13
    against B11 and each under a second plan (``_ab_other_plan``), bit for
    bit; fm where the decimated power is above AB_POWER within AB_TOL,
    iq_tail exact, prev_i/prev_q within AB_PREV_TOL.  Then B11 against
    B1 (``_check_ab_b1``).  Returns the rows."""
    import torch
    from dy4tpu_torch.ops import frontend_cuda as fc

    blk = blocks[AB_BLOCK]
    full = (blk, params.rf_coeff, st.rf.iq_tail.contiguous(),
            st.rf.prev_i.contiguous(), st.rf.prev_q.contiguous(),
            cfg.rf_decim)
    _distinct_rows("B11", blk, *full[2:5])
    i_ds, q_ds, _ = fc.rf_lpf_plain(*full[:3], cfg.rf_decim)
    live_all = i_ds * i_ds + q_ds * q_ds > AB_POWER
    n_out = cfg.if_per_block
    other = _ab_other_plan(n_out, cfg.rf_decim, cfg.num_taps)
    rows = []
    for c in (C, FRONT_RAGGED_ROWS, 1):
        args = full if c == C else (
            blk[:c].contiguous(), full[1],
            *(t[:c].contiguous() for t in full[2:5]), full[5])
        live = live_all[:c]
        where = "" if c == C else f" [{c}, {cfg.block_size}]"
        b11 = None
        for name, wrap, plain, source, replaces in (
                ("B11 frontend_raw", fc.fused_frontend_raw,
                 fc.fused_frontend_raw_plain, fc._PAIRS,
                 "dy4tpu/ops/frontend_pallas.py:429"),
                ("B12 frontend_phase", fc.fused_frontend,
                 fc.fused_frontend_plain, fc._PAIRS,
                 "dy4tpu/ops/frontend_pallas.py:983"),
                ("B13 frontend_raw_pm", fc.fused_frontend_raw_pm,
                 fc.fused_frontend_raw_pm_plain, fc._WORDS,
                 "dy4tpu/ops/frontend_pallas.py:340")):
            label = f"{name.split()[0]} mode{cfg.mode}{where}"
            k_out = wrap(*args)
            p_out = plain(*args)
            o_out = fc._launch_rf(source, *args, "second plan", plan=other)
            torch.cuda.synchronize()
            prev = _max_err(k_out[2:], p_out[2:])
            if not (torch.equal(k_out[1], p_out[1]) and prev <= AB_PREV_TOL):
                raise AssertionError(f"{label}: iq_tail differs from the "
                                     f"plain version, or prev_i/prev_q by "
                                     f"{prev:.3g}")
            if not all(torch.equal(a, b) for a, b in zip(k_out, o_out)):
                raise AssertionError(f"{label}: not bitwise equal under a "
                                     f"second plan {other}")
            diff = (k_out[0] - p_out[0]).abs()
            err = float(diff[live].max())
            extra = dict(fm_max_abs_err_everywhere=float(diff.max()),
                         prev_max_abs_err=prev)
            if b11 is None:
                b11 = k_out
                note = ""
            else:
                if not all(torch.equal(a, b) for a, b in zip(k_out, b11)):
                    raise AssertionError(f"{label}: not bitwise equal to "
                                         f"B11")
                note = "; bit for bit B11's"
            _say(f"phase 7: {label}: fm within {err:.3g} of the plain "
                 f"version where the decimated power is above {AB_POWER:g} "
                 f"({float(live.double().mean()):.1%} of samples; "
                 f"everywhere {float(diff.max()):.3g}), iq_tail exact, "
                 f"prev_i/prev_q "
                 f"{prev:.3g}; bit for bit under a second plan{note}")
            rows.append(_Row(
                name, f"mode{cfg.mode} decim {cfg.rf_decim}{where}",
                "dy4tpu_torch/csrc/frontend_rf.cu", replaces, wrap, err,
                AB_TOL, lambda w=wrap, a=args: w(*a),
                lambda p=plain, a=args: p(*a), where=f"C={c}",
                nbytes=_nbytes(args[:5], k_out),
                flops=c * n_out * (4 * cfg.num_taps + 9),
                phase="phase 7", extra=extra))
        if c == C:
            _check_ab_b1(cfg, params, blk, st, b11)
    own = fc._rf_plan(n_out, cfg.rf_decim, cfg.num_taps)
    _say(f"phase 7: mode{cfg.mode}: B11-B13's plan {own}, "
         f"{fc._rf_smem_bytes(own, cfg.rf_decim, cfg.num_taps)} bytes of "
         f"shared memory a block; the second plan {other}")
    return rows


def _check_expand(cfg, params, blocks, st, dev) -> list:
    """B9-expand on the span targets of block AB_BLOCK's pilot (and
    carrier) from the state ``st``, with a dead span in every row, and at
    the ragged geometry cut from them (``_ragged_span``).  Returns the two
    rows."""
    from dy4tpu_torch.pipeline import receiver as rx

    _, fo = rx.front_step(params, rx.front_state_of(st), blocks[AB_BLOCK],
                          cfg, rds_enabled=cfg.supports_rds)
    x, _, _, consts, per_sample, carry = _pll_case(cfg, st, fo.pilot,
                                                   fo.carrier, dev)
    eff, targets = _span_case(x, consts, per_sample[2], dev)
    return [_expand_row(f"mode{cfg.mode}", targets, eff, carry, per_sample),
            _expand_row(f"mode{cfg.mode} ragged",
                        *_ragged_span(targets, eff, carry, per_sample),
                        where="streams")]


def _expand_row(label, targets, eff, carry, per_sample, where=f"C={C}"
                ) -> "_Row":
    """B9-expand against B9 + ``pll._span_expand`` on the card and against
    its plain version (B9's plain scan + the same expansion), bitwise, on
    ``targets`` with the span constants ``eff`` and the per-sample ones
    ``per_sample``.  Returns the row."""
    import torch
    from dy4tpu_torch.ops import pll, pll_cuda

    kp_s, ki_s, dth_s = eff
    kp, ki, dth = per_sample
    _distinct_rows("B9-expand", torch.nan_to_num(targets, nan=9.0), *carry)
    scan = functools.partial(pll_cuda.phase_scan_target, targets, kp_s, ki_s,
                             dth_s, carry, span=SPAN)
    k_phis, k_carry = scan(expand=per_sample)
    phi0, i0, b9_carry = scan()
    via_b9 = pll._span_expand(phi0, i0, targets, kp, ki, dth, SPAN)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    p_phis, p_carry = pll_cuda.phase_scan_target_plain(
        targets, kp_s, ki_s, dth_s, carry, span=SPAN, expand=per_sample)
    stop.record()
    torch.cuda.synchronize()
    k_flat, p_flat = (k_phis, *k_carry), (p_phis, *p_carry)
    label = f"B9-expand {label} {list(targets.shape)} span {SPAN}"
    if not (all(torch.equal(a, b) for a, b in zip(k_flat, p_flat))
            and all(torch.equal(a, b) for a, b in
                    zip(k_flat, (via_b9, *b9_carry)))):
        raise AssertionError(f"{label}: not bitwise equal to its plain "
                             f"version and to B9 + _span_expand: max "
                             f"|dphi| {_max_err(k_flat, p_flat)}")
    b9_torch_ms = _time_ms(lambda: pll._span_expand(
        *scan()[:2], targets, kp, ki, dth, SPAN), 20)
    _say(f"phase 7: {label}: phases [{', '.join(map(str, k_phis.shape))}] "
         f"and the carry bitwise equal to the plain version and to B9 + "
         f"_span_expand on the card (B9 + the torch expansion "
         f"{b9_torch_ms:.4f} ms)")
    # per span step: B9's 18 operations, lin and quad (4), and per phase
    # two multiplies and two adds
    return _Row(
        "B9x pll_span_expand", label.split(" ", 1)[1],
        "dy4tpu_torch/csrc/pll.cu", "dy4tpu/ops/pll_pallas.py:131",
        pll_cuda.phase_scan_target.expand, _max_err(k_flat, p_flat), 0.0,
        lambda: scan(expand=per_sample), plain_ms=start.elapsed_time(stop),
        where=where,
        nbytes=_nbytes(targets, kp_s, ki_s, dth_s, per_sample, carry, k_flat),
        flops=(B9_STEP_OPS + 4 + 4 * SPAN) * targets.numel(),
        chain_steps=targets.shape[-1], phase="phase 7",
        extra=dict(b9_torch_expand_ms=b9_torch_ms))


def _run_ab_chains(cfg, params, blocks, dev, smi, all_wrappers) -> dict:
    """Phase 7's main paths at one mode: ``run_blocks`` over N_BLOCKS x C
    with ``frontend="fused-rf"`` and ``"fused-phase"`` (B11 or B12 on
    every block, B1 on none), each decoded on channel 0 and held to the B1
    route on CHAIN_ROWS, its rate the median of RATE_REPS; then the span
    chain with ``pll_span_emit="kernel"`` (B9-expand on every block, B9 on
    none), decoded and bitwise equal to the span chain of B9 + the torch
    expansion.  Returns {wrapper: launches}."""
    import torch
    from dy4tpu_torch.ops import frontend_cuda, pll_cuda
    from dy4tpu_torch.pipeline import receiver as rx

    state = rx.init_state(cfg, (C,), device=dev)
    sel = torch.tensor(CHAIN_ROWS, device=dev)
    _, ref = rx.run_blocks(params, state, blocks, cfg)
    ref = _select(ref, sel)
    wrappers = {"fused-rf": frontend_cuda.fused_frontend_raw,
                "fused-phase": frontend_cuda.fused_frontend}
    launches = {}
    for front, wrap in wrappers.items():
        label = f"mode {cfg.mode} frontend={front!r}"
        run = functools.partial(rx.run_blocks, params, state, blocks, cfg,
                                frontend=front)
        (_, outs), counts = _run_path(label, cfg, run, all_wrappers,
                                      phase="phase 7", front=front)
        if counts[wrap] != N_BLOCKS:
            raise AssertionError(f"{label}: {wrap.__name__} launched "
                                 f"{counts[wrap]} times over {N_BLOCKS} "
                                 f"blocks")
        _check_outputs(label, cfg, outs, phase="phase 7")
        _compare_chain(f"{label} vs the B1 route (kernels)", cfg,
                       _select(outs, sel), ref, N_BLOCKS, phase="phase 7")
        del outs
        _say(f"phase 7: {label}: chain, median of {RATE_REPS}: "
             f"{_median_rate(cfg, run):.1f} MS/s complex IQ ({N_BLOCKS} "
             f"blocks x {C} channels, after warm-up) on {smi}")
        _device_split(label, run, N_BLOCKS, phase="phase 7")
        launches[wrap] = counts[wrap]

    expand = pll_cuda.phase_scan_target.expand
    label = (f"mode {cfg.mode} span PLL (pll_span={SPAN}, "
             f"pll_span_emit='kernel')")
    run = functools.partial(rx.run_blocks, params, state, blocks, cfg,
                            pll_span=SPAN, pll_span_emit="kernel")
    (_, outs), counts = _run_path(label, cfg, run, all_wrappers,
                                  phase="phase 7", span=True,
                                  span_emit="kernel")
    if counts[expand] != N_BLOCKS:
        raise AssertionError(f"{label}: B9-expand launched {counts[expand]} "
                             f"times over {N_BLOCKS} blocks")
    _check_outputs(label, cfg, outs, phase="phase 7")
    torch_run = functools.partial(rx.run_blocks, params, state, blocks, cfg,
                                  pll_span=SPAN)
    _, same = torch_run()
    for f, a, b in zip(rx.StepOutputs._fields, outs, same):
        if not (a is None and b is None or torch.equal(a, b)):
            raise AssertionError(f"{label}: {f} differs from the span chain "
                                 f"with the torch expansion")
    del outs, same
    rates = {name: _median_rate(cfg, r) for name, r in
             (("kernel", run), ("torch", torch_run))}
    _say(f"phase 7: {label}: every output over {N_BLOCKS} blocks x {C} "
         f"channels bitwise equal to pll_span_emit='torch'; chain, median "
         f"of {RATE_REPS}: {rates['kernel']:.1f} MS/s against "
         f"{rates['torch']:.1f} with the torch expansion on {smi}")
    launches[expand] = counts[expand]
    return launches


def _fir_other_plan(rows: int, n_out: int, d: int, k: int):
    """The wrapper's plan of B14 and a second one, unlike it: tiles of a
    third of the row and one output (so the last is shorter; 4 more where
    that is the wrapper's), passes of 64 outputs, three stages."""
    from dy4tpu_torch.ops import fir_cuda
    own = fir_cuda._fir_plan(n_out, d, k, rows=rows)
    tile = n_out // 3 + 1
    other = fir_cuda._fir_plan(n_out, d, k, rows=rows,
                               tile=tile + 4 if tile == own.tile else tile,
                               sub=64, stages=3)
    assert other != own
    return own, other


def _fir_sweep(label: str, args) -> dict:
    """B14's plans at ``args`` (x, h, state, d): the rule's pick and every
    plan of FIR_SWEEP's tiles, passes and stages, each alone from a cold
    L2 (``_cold_ms``), printed fastest first with the pick marked;
    nothing is fitted.  Returns the JSON keys of the geometry's row."""
    from dy4tpu_torch.ops import fir_cuda
    x, h, _, d = args
    n, k = x.shape[-1], h.shape[0]
    rows = x.numel() // n
    pick = fir_cuda._fir_plan(n // d, d, k, rows=rows)
    plans = [pick] + [fir_cuda._fir_plan(n // d, d, k, rows=rows, tile=tile,
                                         sub=sub, stages=st)
                      for tile in FIR_SWEEP["tile"]
                      for sub in FIR_SWEEP["sub"]
                      for st in FIR_SWEEP["stages"]]
    plans = list(dict.fromkeys(plans))
    timed = [(plan, _cold_ms(functools.partial(fir_cuda._launch, *args,
                                               plan),
                             fir_cuda.block_fir_decim)) for plan in plans]
    for plan, ms in sorted(timed, key=lambda r: (r[1] is None, r[1] or 0)):
        _say(f"phase 7: B14 {label} plan sweep: tiles of {plan.tile} x "
             f"{plan.n_tiles}, passes of {plan.sub}, {plan.stages} "
             f"stage(s): "
             + ("not measured" if ms is None else f"{ms:.4f} ms")
             + (" <- the rule's pick" if plan == pick else ""))
    measured = [(plan, ms) for plan, ms in timed if ms is not None]
    pick_ms = timed[0][1]
    fastest = min(measured, key=lambda r: r[1], default=(None, None))
    return dict(sweep_plans=len(plans),
                sweep=[dict(plan._asdict(), cold_ms=ms) for plan, ms in timed],
                sweep_pick_ms=("not measured" if pick_ms is None
                               else pick_ms),
                sweep_fastest_ms=("not measured" if fastest[0] is None
                                  else fastest[1]),
                sweep_fastest_plan=(None if fastest[0] is None
                                    else fastest[0]._asdict()))


def _check_fir(dev) -> list:
    """B14 against its plain version (``fir.block_fir_decim``'s conv1d,
    also the library call) at FIR_GEOMS, unit-normal inputs from a seed:
    y within FIR_TOL x max(1, max|y|), the new state exact; bit for bit
    under a second plan (``_fir_other_plan``); at FIR_GEOMS[0] its plans
    swept from a cold L2 (``_fir_sweep``).  Returns the rows."""
    import torch
    from dy4tpu_torch.ops import fir, fir_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    rows = []
    for batch, n, k, d in FIR_GEOMS:
        x = torch.randn(*batch, n, generator=gen, device=dev)
        h = torch.randn(k, generator=gen, device=dev)
        state = torch.randn(*batch, k - 1, generator=gen, device=dev)
        if batch:
            _distinct_rows("B14", x.reshape(-1, n), state.reshape(-1, k - 1))
        kern = functools.partial(fir.block_fir_decim, x, h, state, d,
                                 impl="kernel")
        plain = functools.partial(fir.block_fir_decim, x, h, state, d,
                                  impl="plain")
        own, other = _fir_other_plan(x.numel() // n, n // d, d, k)
        k_y, k_s = kern()
        p_y, p_s = plain()
        o_y, o_s = fir_cuda._launch(x, h, state, d, other)
        torch.cuda.synchronize()
        scale = max(1.0, float(p_y.abs().max()))
        geometry = f"{list(x.shape)} K={k} D={d}"
        if not torch.equal(k_s, p_s):
            raise AssertionError(f"B14 {geometry}: the state differs from "
                                 f"the plain version")
        if not (torch.equal(o_y, k_y) and torch.equal(o_s, k_s)):
            raise AssertionError(f"B14 {geometry}: not bitwise equal under "
                                 f"a second plan {other}")
        err = _max_err([k_y], [p_y])
        _say(f"phase 7: B14 {geometry}: max |kernel - plain| {err:.3g} "
             f"(tolerance {FIR_TOL:g} x {scale:.3g}), state exact; plan "
             f"{own}, bit for bit under {other}")
        extra = dict(plan=own._asdict(), second_plan=other._asdict())
        if (batch, n, k, d) == FIR_GEOMS[0]:
            extra.update(_fir_sweep(geometry, (x, h, state, d)))
        rows.append(_Row(
            "B14 fir_decim", geometry, "dy4tpu_torch/csrc/fir.cu",
            "dy4tpu/ops/fir_pallas.py:86", fir_cuda.block_fir_decim, err,
            FIR_TOL * scale, kern, plain, where="unit normals",
            nbytes=_nbytes(x, h, state, k_y, k_s),
            flops=2 * k * k_y.numel(), library=plain, phase="phase 7",
            extra=extra))
    return rows


def _run_direct(cfg, params, blocks, all_wrappers) -> dict:
    """The two kernels no receiver route runs, through their own ops calls
    at the receiver's geometry, over N_BLOCKS blocks of C channels, state
    carried: B13 (``fused_frontend_raw_pm``) on the u8 blocks and B14
    (``fir.block_fir_decim(impl="kernel")``) on the blocks' normalized RF
    legs [C, 2, n], its I/Q then through ``demod.fm_demod_diff``.  Each
    launches once a block and nothing else does.  On CHAIN_ROWS, B14's
    output is held to the plain RF LPF's over the whole stream and B13's
    fm to B11's where that LPF's power is above AB_POWER; on every
    channel, the fm of B14's I/Q, its last RF state and its last I/Q are
    B11's fm, iq_tail and prev_i/prev_q bit for bit.  Returns {wrapper:
    launches}."""
    import torch
    from dy4tpu_torch.ops import demod, fir, fir_cuda, frontend_cuda as fc

    h, d, s = params.rf_coeff, cfg.rf_decim, cfg.num_taps - 1
    dev = blocks.device
    sel = torch.tensor(CHAIN_ROWS, device=dev)
    zero = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731

    def legs(blk):
        x = (blk.to(torch.float32) - 128.0) / 128.0
        return x.reshape(blk.shape[0], -1, 2).movedim(-1, -2).contiguous()

    def stream(step, state, keep=lambda out: out[sel]):
        outs = []
        for blk in blocks:
            out, state = step(blk, state)
            outs.append(keep(out))
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs)), state
        return torch.stack(outs), state

    def front(wrap):
        def step(blk, st):
            fm, *st = wrap(blk, h, *st, d)
            return fm, st
        return step

    def b14(blk, st):
        tail, prev = st
        iq, tail = fir.block_fir_decim(legs(blk), h, tail, d, impl="kernel")
        fm, *prev = demod.fm_demod_diff(iq[:, 0], iq[:, 1], *prev)
        return (iq, fm), (tail, prev)

    def counted(name, wrap, step, state, keep):
        _zero(all_wrappers)
        t0 = time.perf_counter()
        out, end = stream(step, state, keep)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        off = _launches_off(all_wrappers, {wrap: N_BLOCKS})
        if off:
            raise AssertionError(f"phase 7: {name}: launches (got, "
                                 f"expected) {off}")
        launches[wrap] = wrap.launches
        return out, end, (f"phase 7: {name} over {N_BLOCKS} blocks x {C} "
                          f"channels, state carried: {wrap.__name__} "
                          f"{wrap.launches} launches, nothing else "
                          f"({secs:.2f} s, first run)")

    # the plain RF LPF of CHAIN_ROWS over the whole stream: [blocks, rows,
    # 2, n/d]
    rows = len(CHAIN_ROWS)
    ref_iq, _ = fir.block_fir_decim(
        torch.cat([legs(b[sel]) for b in blocks], -1), h, zero(rows, 2, s), d,
        impl="plain")
    ref_iq = ref_iq.reshape(rows, 2, N_BLOCKS, -1).permute(2, 0, 1, 3)
    live = (ref_iq * ref_iq).sum(2) > AB_POWER
    rf0 = (zero(C, 2, s), zero(C), zero(C))
    launches = {}

    out, end, said = counted("B13 fused_frontend_raw_pm",
                             fc.fused_frontend_raw_pm,
                             front(fc.fused_frontend_raw_pm), rf0,
                             lambda out: out[sel])
    b11, b11_end = stream(front(fc.fused_frontend_raw), rf0,
                          keep=lambda out: out)
    err = float((out - b11[:, sel]).abs()[live].max())
    _say(f"{said}; channels {CHAIN_ROWS}: fm against B11's where the power "
         f"is above {AB_POWER:g}, the last iq_tail exact, within {err:.3g} "
         f"(tolerance {AB_TOL:g})")
    if not (err <= AB_TOL and torch.equal(end[0], b11_end[0])):
        raise AssertionError(f"phase 7: B13: departs by {err:.3g}")

    (iq, fm), (tail, prev), said = counted(
        "B14 fir.block_fir_decim(impl='kernel')", fir_cuda.block_fir_decim,
        b14, (zero(C, 2, s), (zero(C), zero(C))),
        lambda out: (out[0][sel], out[1]))
    scale = max(1.0, float(ref_iq.abs().max()))
    err = float((iq - ref_iq).abs().max())
    same = (torch.equal(fm, b11) and torch.equal(tail, b11_end[0])
            and torch.equal(prev[0], b11_end[1])
            and torch.equal(prev[1], b11_end[2]))
    _say(f"{said}; channels {CHAIN_ROWS}: the RF legs against the plain RF "
         f"LPF's within {err:.3g} (tolerance {FIR_TOL * scale:.3g}); every "
         f"channel: fm of its I/Q (torch's demod) "
         + ("bit for bit" if same else "NOT bit for bit")
         + f" B11's over the {N_BLOCKS} blocks, its last RF state and last "
         f"I/Q B11's iq_tail and prev_i/prev_q")
    if not (err <= FIR_TOL * scale and same):
        raise AssertionError(f"phase 7: B14: departs by {err:.3g}, or its "
                             f"fm is not B11's bit for bit (max |fm - "
                             f"B11| {_max_err([fm], [b11]):.3g})")
    return launches


def _run_ab(dev, smi, all_wrappers) -> list[dict]:
    """Phase 7: the A/B front-end routes and the kernels no other phase
    runs (B11, B12, B13, B14, B9-expand) at modes 0 and 1, C=512.  Returns
    their JSON entries, each with its launches on its main path."""
    import torch
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import fir_cuda
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.tx import fm

    t_phase = time.perf_counter()
    results, direct = [], {}
    for mode in AB_MODES:
        cfg = get_mode(mode)
        torch.cuda.reset_peak_memory_stats()
        params = rx.make_params(cfg, device=dev)
        blocks = _channels(fm.stereo_rds_broadcast(cfg, N_BLOCKS + 1), cfg,
                           dev)
        st, _ = rx.run_blocks(params, rx.init_state(cfg, (C,), device=dev),
                              blocks[:AB_BLOCK], cfg)
        rows = _check_ab_kernels(cfg, params, blocks, st, dev)
        rows += _check_expand(cfg, params, blocks, st, dev)
        entries = [r.finish(smi, mode) for r in rows]
        counts = _run_ab_chains(cfg, params, blocks, dev, smi, all_wrappers)
        if not direct:       # B13 and B14 at the first mode's geometry
            direct = _run_direct(cfg, params, blocks, all_wrappers)
        counts.update(direct)
        for r in entries:
            r["launches"] = counts[r["wrapper"]]
        results += entries
        del blocks, st
        torch.cuda.empty_cache()
    for r in _check_fir(dev):
        results.append(r.finish(smi, AB_MODES[0]))
        results[-1]["launches"] = direct[fir_cuda.block_fir_decim]
    _say(f"phase 7: peak device memory "
         f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase 7 "
         f"{time.perf_counter() - t_phase:.1f} s on {smi}")
    return results


def _fleet_captures(tmp: Path) -> dict:
    """The port's synth writes phase 8's captures (all at once, as
    subprocesses), N_BLOCKS blocks each: {name: (path, pi, ps)}."""
    synth = [sys.executable, "-m", "dy4tpu_torch.tools.synth"]
    want = {f"m0_{i}": (0, pi, ps, []) for i, (pi, ps) in
            enumerate(FLEET_MODE0)}
    want["fault"] = (0, *FLEET_FAULTED, ["--dc", "0.12", "-0.08",
                                         "--iq-imbalance", "0.7", "25"])
    want.update({f"m2_{i}": (2, pi, ps, []) for i, (pi, ps) in
                 enumerate(FLEET_MODE2)})
    procs = {name: subprocess.Popen(
        [*synth, str(tmp / f"{name}.raw"), "--mode", str(mode), "--blocks",
         str(N_BLOCKS), "--pi", hex(pi), "--ps", ps, *extra],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for name, (mode, pi, ps, extra) in want.items()}
    try:
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"phase 8: synth {name} exited "
                                     f"{proc.returncode}:\n{err[-3000:]}")
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    return {name: (str(tmp / f"{name}.raw"), pi, ps)
            for name, (_, pi, ps, _) in want.items()}


def _fleet_decoded(label, paths, infos, caps) -> None:
    """Every station's PI and PS equal its capture's."""
    want = {path: (f"{pi:04X}", ps) for path, pi, ps in caps}
    bad = [(ch, info.pi_hex, info.ps_name) for ch, (path, info) in
           enumerate(zip(paths, infos))
           if (info.pi_hex, (info.ps_name or "").strip()) != want[path]]
    if bad:
        raise AssertionError(f"phase 8: {label}: {len(bad)} of {len(paths)} "
                             f"stations decode the wrong PI/PS, e.g. "
                             f"{bad[:4]}")


def _fleet_run_text(label, run, cfg, chain_msps=None) -> str:
    """Wall, MS/s, real-time factor and the four phase times of a run."""
    c = len(run.paths)
    iq = c * run.n_blocks * cfg.iq_per_block
    msps = iq / run.wall / 1e6
    text = (f"{label}: {c} stations x {run.n_blocks} blocks, chunk "
            f"{run.chunk}, {'sync' if run.sync_ingest else 'overlapped'}: "
            f"wall {run.wall * 1e3:.1f} ms = {msps:.1f} MS/s "
            f"({msps / (cfg.rf_fs / 1e6):.0f}x real time); put "
            f"{run.t_put * 1e3:.1f} ms (pinned fill {run.t_fill * 1e3:.1f} "
            f"ms), dispatch {run.t_dispatch * 1e3:.1f} ms, host decode "
            f"{run.t_drain * 1e3:.1f} ms")
    if chain_msps:
        text += (f"; phase 3's chain at this mode and C: {chain_msps:.1f} "
                 f"MS/s, fleet keeps {msps / chain_msps:.1%}")
    return text


def _run_fleet(dev, smi, all_wrappers, rates: dict) -> None:
    """Phase 8: fleet serving (``dy4tpu_torch.tools.fleet``) on the card
    over the port's synth captures: as a subprocess at C=512 (mode 0,
    overlapped, then ``--sync-ingest``), every station decoding its
    capture's PI/PS and the two runs' station lines equal; ``serve`` in
    process at C=512 with chunks of 8 (overlapped and sync), 3 and 1, the
    RDS outputs bitwise equal (the same kernels in the same order, so any
    difference is an ingest race), B1-B4 once a block (and once a block of
    the warm-up chunk) and nothing else; mode 2 with the envelope CDR
    (B1, B2, B4 at 171/640, B5) and mode 0 with ``iqcorr`` (B1's corr
    variant) over the faulted capture, at C=64, decoded."""
    import numpy as np
    import torch
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import (backend_cuda, frontend_cuda, pll_cuda,
                                  resample_cuda)
    from dy4tpu_torch.tools import fleet

    t_phase = time.perf_counter()
    cfg = get_mode(0)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        caps = _fleet_captures(Path(tmp))
        _say(f"setup phase 8: synth wrote {len(caps)} captures of {N_BLOCKS} "
             f"blocks in {time.perf_counter() - t_phase:.1f} s")
        m0 = [caps[f"m0_{i}"] for i in range(len(FLEET_MODE0))]
        paths = [c[0] for c in m0] * FLEET_REPEAT

        # ---- the command line, as a user runs it ----
        lines = {}
        for flag in ([], ["--sync-ingest"]):
            cmd = [sys.executable, "-m", "dy4tpu_torch.tools.fleet",
                   "--mode", "0", "--repeat", str(FLEET_REPEAT),
                   *flag, *(c[0] for c in m0)]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                               timeout=300)
            if r.returncode != 0:
                raise AssertionError(f"phase 8: {' '.join(cmd[1:])} exited "
                                     f"{r.returncode}:\n{r.stderr[-3000:]}")
            err = r.stderr.splitlines()
            stations = [ln for ln in err if ln.startswith("[")]
            if len(stations) != C or "stations x" not in err[0]:
                raise AssertionError(f"phase 8: fleet printed {len(stations)} "
                                     f"station lines:\n{r.stderr[-2000:]}")
            for ch, ln in enumerate(stations):
                pi, ps = m0[ch % len(m0)][1:]
                if f"PI={pi:04X} PS={ps.ljust(8)!r} " not in ln:
                    raise AssertionError(f"phase 8: station {ch}: {ln}")
            lines[bool(flag)] = stations
            _say(f"phase 8: python {' '.join(cmd[1:-len(m0)])} (4 "
                 f"captures; {time.perf_counter() - t0:.1f} s): {err[0]}; "
                 f"every station decodes its capture's PI/PS")
        if lines[False] != lines[True]:
            raise AssertionError("phase 8: --sync-ingest's station lines "
                                 "differ from the overlapped run's")
        _say(f"phase 8: --sync-ingest's {C} station lines equal the "
             f"overlapped run's")

        # ---- in process: chunks, sync, launches, bitwise outputs ----
        path0 = [frontend_cuda.fused_frontend_full, pll_cuda.phase_scan,
                 backend_cuda.fused_audio_backend,
                 resample_cuda.fused_rds_backend]
        first = None
        for chunk, sync in FLEET_CHUNKS:
            _zero(all_wrappers)
            run = fleet.serve(paths, cfg, chunk=chunk, sync_ingest=sync,
                              device=dev, record=True)
            torch.cuda.synchronize()
            n = run.n_blocks + min(chunk, run.n_blocks)   # + the warm-up
            off = _launches_off(all_wrappers, {w: n for w in path0})
            label = f"serve chunk {chunk}{' sync' if sync else ''}"
            if off:
                raise AssertionError(f"phase 8: {label}: launches (got, "
                                     f"expected): {off}")
            _fleet_decoded(label, paths, run.infos, m0)
            if first is None:
                first = run
            for f in ("rds_symbols", "rds_resync", "rds_offset"):
                a, b = getattr(run, f), getattr(first, f)
                if not (a.shape == b.shape == (N_BLOCKS, C, *a.shape[2:])
                        and np.array_equal(a, b)):
                    raise AssertionError(f"phase 8: {label}: {f} differs "
                                         f"from chunk 8's overlapped run")
            _say("phase 8: " + _fleet_run_text(label, run, cfg,
                                                rates.get(0))
                 + f"; B1-B4 {n} launches each ({run.n_blocks} blocks + "
                 f"{n - run.n_blocks} of the warm-up), nothing else; RDS "
                 f"outputs bitwise chunk 8's; every station decoded")
        del first, run

        # ---- mode 2, envelope CDR; mode 0, IQ tracker ----
        side = (("mode 2 --cdr envelope", get_mode(2), "envelope", False,
                 [caps[f"m2_{i}"] for i in range(len(FLEET_MODE2))],
                 [frontend_cuda.fused_frontend_full, pll_cuda.phase_scan,
                  resample_cuda.fused_audio_backend_rational,
                  resample_cuda.fused_rds_backend]),
                ("mode 0 --iqcorr", cfg, "peak", True, [caps["fault"]],
                 [frontend_cuda.fused_frontend_full.corr,
                  pll_cuda.phase_scan, backend_cuda.fused_audio_backend,
                  resample_cuda.fused_rds_backend]))
        for label, c_cfg, cdr, corr, c_caps, path in side:
            c_paths = [c[0] for c in c_caps] * (FLEET_SIDE_C // len(c_caps))
            _zero(all_wrappers)
            run = fleet.serve(c_paths, c_cfg, cdr=cdr, iqcorr=corr,
                              device=dev)
            torch.cuda.synchronize()
            n = run.n_blocks + min(8, run.n_blocks)
            off = _launches_off(all_wrappers, {w: n for w in path})
            if off:
                raise AssertionError(f"phase 8: {label}: launches (got, "
                                     f"expected): {off}")
            _fleet_decoded(label, c_paths, run.infos, c_caps)
            _say("phase 8: " + _fleet_run_text(label, run, c_cfg)
                 + f"; {', '.join(w.__name__ for w in path)} {n} launches "
                 f"each, nothing else; every station decoded")
    _say(f"phase 8: peak device memory "
         f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase 8 "
         f"{time.perf_counter() - t_phase:.1f} s on {smi}")


def _stereo_capture(cfg, n_blocks, lf, rf, amp, pi=None, pty=10, ps=None,
                    repeats=60, **kw):
    """The port's synth: ``n_blocks`` of a broadcast of tones ``lf`` /
    ``rf`` and, with ``pi``, RDS groups 0A carrying ``ps``."""
    from dy4tpu_torch.rds import coding
    from dy4tpu_torch.tx import fm
    n_audio = n_blocks * cfg.audio_per_block
    bits = (None if pi is None else
            coding.make_ps_bitstream(pi, pty, ps, repeats=repeats))
    return fm.synthesize(cfg, n_blocks,
                         left=fm.tone(lf, cfg.audio_fs, n_audio, amp),
                         right=fm.tone(rf, cfg.audio_fs, n_audio, amp),
                         rds_bits=bits, **kw)


def _rds_info(symbols, resync, offsets=None):
    """One row's RDS decode ([blocks, n] symbols, [blocks] flags):
    ``(station info, decoder, the block of each group)``."""
    from dy4tpu_torch.rds.app import ApplicationLayer
    from dy4tpu_torch.rds.decoder import RDSDecoder
    app = ApplicationLayer()
    dec = RDSDecoder(on_group=app.process)
    group_blocks = []
    for b in range(len(symbols)):
        got = dec.push_block(symbols[b], bool(resync[b]),
                             offset=None if offsets is None
                             else int(offsets[b]))
        group_blocks.extend([b] * len(got))
    return app.info, dec, group_blocks


def _sep_db(cfg, left, right) -> float:
    """Stereo separation (dB, the worse side) of [blocks, n] left / right
    of an 800 / 2400 Hz broadcast from block 4, as tests/test_iqcorr.py
    and test_noise.py measure it."""
    from dy4tpu_torch.tx import fm
    return min(fm.stereo_separation_db(cfg, left, right, skip_blocks=4))


def _soak_bounded(label, state) -> tuple[float, float]:
    """Every float state leaf finite and the pilot and RDS PLLs'
    ``phase_est`` / ``angle`` inside ``2*PLL_WRAP + 1`` (test_soak.py's
    band); returns the largest |phase_est| and |angle|."""
    import numpy as np
    import torch
    from dy4tpu_torch.pipeline import convert
    for k, a in convert.leaves_by_path(state).items():
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            raise AssertionError(f"phase 9: {label}: state leaf {k} is not "
                                 f"finite")
    worst = []
    for field in ("phase_est", "angle"):
        m = max(float(torch.abs(getattr(loop, field)).max())
                for loop in (state.audio.pll, state.rds.pll))
        if not m <= 2 * PLL_WRAP + 1.0:
            raise AssertionError(f"phase 9: {label}: |{field}| reaches "
                                 f"{m:.4f}, outside 2*WRAP + 1 = "
                                 f"{2 * PLL_WRAP + 1.0:.4f}")
        worst.append(m)
    return worst[0], worst[1]


def _same_state(label, a, b) -> None:
    import numpy as np
    from dy4tpu_torch.pipeline import convert
    x, y = convert.leaves_by_path(a), convert.leaves_by_path(b)
    bad = [k for k in x if not (k in y and x[k].dtype == y[k].dtype
                               and np.array_equal(x[k], y[k]))]
    if bad or x.keys() != y.keys():
        raise AssertionError(f"phase 9: {label}: state leaves differ: "
                             f"{bad or sorted(set(x) ^ set(y))}")


def _soak(mode, cycles, timing, dev, smi, all_wrappers, tmp) -> dict:
    """The soak at one mode: SOAK_STATIONS x SOAK_ROWS rows, ``cycles``
    loops of one SOAK_CYCLE-block cycle put on the card once.  Raises on
    any failed check; returns what it measured."""
    import numpy as np
    import torch
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.utils import checkpoint as ckpt

    cfg = get_mode(mode)
    label = f"soak mode {mode} ({timing} CDR)"
    caps = [_stereo_capture(cfg, SOAK_CYCLE, lf, rf, 0.7, pi=pi, ps=ps,
                            repeats=3 * SOAK_CYCLE)
            for pi, ps, lf, rf in SOAK_STATIONS]
    rows = np.repeat(np.stack([x.reshape(SOAK_CYCLE, -1) for x in caps],
                              axis=1), SOAK_ROWS, axis=1)
    c = rows.shape[1]
    cycle = torch.from_numpy(rows).to(dev)            # [cycle, C, block]
    params = rx.make_params(cfg, device=dev)
    state = rx.init_state(cfg, (c,), device=dev)
    ckpt_at = min(SOAK_CKPT, (3 * cycles) // 4)

    def run_cycle(st):
        outs = []
        for b in range(SOAK_CYCLE):
            st, o = rx.receiver_step(params, st, cycle[b], cfg,
                                     cdr_timing=timing)
            outs.append(o)
        return st, outs

    _zero(all_wrappers)
    twin, t_run, timed, worst = None, 0.0, 0, (0.0, 0.0)
    for k in range(cycles):
        t0 = time.perf_counter()
        state, outs = run_cycle(state)
        if twin is None:
            torch.cuda.synchronize()
            t_run += time.perf_counter() - t0
            timed += 1
        else:
            twin, touts = run_cycle(twin)
            for b, (o, t) in enumerate(zip(outs, touts)):
                for f, x, y in zip(o._fields, o, t):
                    if x is not None and not torch.equal(x, y):
                        raise AssertionError(
                            f"phase 9: {label}: the resumed twin's {f} "
                            f"differs at block {k * SOAK_CYCLE + b}")
            if k == ckpt_at + SOAK_TWIN - 1:
                _same_state(f"{label}, resumed twin", state, twin)
                twin = None
        if (k + 1) % SOAK_CHECK_EVERY == 0 or k == cycles - 1:
            worst = tuple(max(a, b) for a, b in zip(
                worst, _soak_bounded(f"{label}, cycle {k}", state)))
        if k == ckpt_at - 1:
            path = str(tmp / f"soak{mode}.ckpt")
            ckpt.save(path, state, meta={"block": ckpt_at * SOAK_CYCLE})
            twin, _, meta = ckpt.load(path, rx.init_state(cfg, (c,),
                                                          device=dev))
            if meta.get("block") != ckpt_at * SOAK_CYCLE:
                raise AssertionError(f"phase 9: {label}: checkpoint meta "
                                     f"{meta}")
            _same_state(f"{label}, loaded checkpoint", state, twin)
    torch.cuda.synchronize()
    n_blocks = (cycles + SOAK_TWIN) * SOAK_CYCLE
    want = {w: n_blocks for w in _path(cfg)}
    off = _launches_off(all_wrappers, want)
    if off:
        raise AssertionError(f"phase 9: {label}: launches (got, expected): "
                             f"{off}")
    # RDS still locked: no resync in the last cycle, every row's PI/PS
    resync = torch.stack([o.rds_resync for o in outs]).cpu().numpy()
    if resync.any():
        raise AssertionError(f"phase 9: {label}: {int(resync.any(0).sum())} "
                             f"rows resync in the last cycle")
    symbols = torch.stack([o.rds_symbols for o in outs]).cpu().numpy()
    for row in range(c):
        pi, ps = SOAK_STATIONS[row // SOAK_ROWS][:2]
        info, _, _ = _rds_info(symbols[:, row], resync[:, row])
        if (info.pi_hex, (info.ps_name or "").strip()) != (f"{pi:04X}",
                                                           ps.strip()):
            raise AssertionError(f"phase 9: {label}: row {row} decodes PI "
                                 f"{info.pi_hex} PS {info.ps_name!r} in the "
                                 f"last cycle, not {pi:04X} {ps!r}")
    ms = t_run / (timed * SOAK_CYCLE) * 1e3
    msps = c * cfg.iq_per_block / (ms * 1e-3) / 1e6
    _say(f"phase 9: {label}: {c} rows x {cycles * SOAK_CYCLE} blocks "
         f"(+{SOAK_TWIN * SOAK_CYCLE} of the resumed twin): {ms:.4f} ms a "
         f"block over the {timed} cycles without the twin, {msps:.1f} MS/s "
         f"complex IQ ({msps / (cfg.rf_fs / 1e6):.0f}x real time); state "
         f"finite and max |phase_est| {worst[0]:.4f}, |angle| "
         f"{worst[1]:.4f} <= 2*WRAP + 1 = {2 * PLL_WRAP + 1.0:.4f} over "
         f"the checks every {SOAK_CHECK_EVERY} cycles; checkpoint at block "
         f"{ckpt_at * SOAK_CYCLE} through disk, the resumed twin bitwise "
         f"over {SOAK_TWIN} cycles; last cycle: no resync, every row's "
         f"PI/PS; launches " + ", ".join(f"{w.__name__} {n}" for w, n in
                                        want.items()) + f" ({smi})")
    return {"ms": ms, "msps": msps}


def _rec_captures(cfg) -> list:
    """Phase 9's mode-0 recovery batch: test_noise.py's two captures,
    test_recovery.py's dropout stream and test_multichannel.py's three
    stations."""
    import numpy as np
    noisy = _stereo_capture(cfg, 20, 800.0, 2400.0, 0.6, pi=0x5A5A, pty=9,
                            ps="NOISY OK", noise=0.05, seed=3)
    echo = _stereo_capture(cfg, 14, 800.0, 2400.0, 0.6, pi=0x54A7, pty=9,
                           ps="ECHO  OK",
                           multipath=[(24, 0.5 * np.exp(1j * 2.1)),
                                      (60, 0.32 * np.exp(-1j * 0.9))])
    seg = dict(pi=0xD00D, pty=7, ps="RECOVERY", repeats=80)
    drop = np.concatenate([
        _stereo_capture(cfg, REC_SEG, 700.0, 1900.0, 0.6, **seg),
        _stereo_capture(cfg, 4, 700.0, 1900.0, 0.6),
        _stereo_capture(cfg, REC_SEG, 700.0, 1900.0, 0.6, **seg)])
    stations = [_stereo_capture(cfg, 20, tone, tone, 0.6, pi=pi, ps=ps,
                                repeats=50)
                for pi, ps, tone in REC_STATIONS]
    return [noisy, echo, drop, *stations]


def _batch(cfg, captures):
    """[max blocks, len(captures), block] u8, each capture a channel,
    padded with u8 128 (no signal)."""
    import numpy as np
    bs = cfg.block_size
    n = max(len(x) for x in captures) // bs
    blocks = np.full((n, len(captures), bs), 128, np.uint8)
    for ch, x in enumerate(captures):
        blocks[:len(x) // bs, ch] = x.reshape(-1, bs)
    return blocks


def _run_batch(label, cfg, captures, dev, all_wrappers, corr=False,
               **step_kwargs):
    """``run_blocks`` on the card over the captures as channels, every
    path kernel on every block (``_run_path``); the outputs on the host."""
    import torch
    from dy4tpu_torch.pipeline import receiver as rx
    blocks = torch.from_numpy(_batch(cfg, captures)).to(dev)
    params = rx.make_params(cfg, device=dev)
    state = rx.init_state(cfg, (len(captures),), with_iqcorr=corr,
                          device=dev)
    (_, outs), _ = _run_path(
        label, cfg, lambda: rx.run_blocks(params, state, blocks, cfg,
                                          **step_kwargs),
        all_wrappers, n_blocks=blocks.shape[0], phase="phase 9", corr=corr)
    return rx.StepOutputs(*(None if f is None else f.cpu().numpy()
                            for f in outs))


def _check(label, ok, detail) -> None:
    if not ok:
        raise AssertionError(f"phase 9: {label}: {detail}")


def _recovery_mode0(dev, all_wrappers) -> None:
    """test_noise.py, test_recovery.py and test_multichannel.py at their
    bars, one batch on the card."""
    import numpy as np
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.tx import fm
    cfg = get_mode(0)
    outs = _run_batch("recovery mode 0 (noise, echoes, dropout, 3 "
                      "stations)", cfg, _rec_captures(cfg), dev,
                      all_wrappers)
    fs = cfg.audio_fs

    def info(ch, n):
        return _rds_info(outs.rds_symbols[:n, ch], outs.rds_resync[:n, ch])

    # noise 0.05: PI, >= 3 groups, the left tone 10x the right's leak
    got, _, _ = info(0, 20)
    sep_l, _ = fm.stereo_separation_db(cfg, outs.left[:20, 0],
                                       outs.right[:20, 0], skip_blocks=4)
    _check("noise", got.pi == 0x5A5A and got.groups_seen >= 3
           and sep_l > 20.0, (got.pi_hex, got.groups_seen, sep_l))
    msg = [f"noise 0.05: PI {got.pi_hex}, {got.groups_seen} groups, left "
           f"tone {sep_l:.1f} dB over the right's"]
    # two echoes: separation > 15 dB, PI, >= 2 groups
    got, _, _ = info(1, 14)
    sep = _sep_db(cfg, outs.left[:14, 1], outs.right[:14, 1])
    _check("echoes", got.pi == 0x54A7 and got.groups_seen >= 2
           and sep > 15.0, (got.pi_hex, got.groups_seen, sep))
    msg.append(f"two echoes: separation {sep:.1f} dB, PI {got.pi_hex}, "
               f"{got.groups_seen} groups")
    # the dropout: groups before it, re-acquired after, PI, resync inside
    n = 2 * REC_SEG + 4
    got, _, blocks = info(2, n)
    resync = outs.rds_resync[REC_SEG:REC_SEG + 6, 2]
    _check("dropout", any(b < REC_SEG for b in blocks)
           and any(b >= REC_SEG + 8 for b in blocks) and got.pi == 0xD00D
           and resync.any(), (got.pi_hex, blocks, resync))
    msg.append(f"4-block RDS dropout: resync at blocks "
               f"{(REC_SEG + np.nonzero(resync)[0]).tolist()}, groups at "
               f"{sorted(set(blocks))}, PI {got.pi_hex}")
    # three stations: each its own PI / PS, its tone 10x the others'
    for k, (pi, ps, tone) in enumerate(REC_STATIONS):
        ch = 3 + k
        got, _, _ = info(ch, 20)
        mono = outs.mono[3:20, ch].ravel()
        t = np.arange(len(mono)) / fs
        own = np.abs(mono @ np.exp(-2j * np.pi * tone * t))
        leaks = [np.abs(mono @ np.exp(-2j * np.pi * other * t))
                 for _, _, other in REC_STATIONS if other != tone]
        _check(f"station {ps!r}", got.pi == pi and got.ps_name == ps
               and all(own > 10 * x for x in leaks),
               (got.pi_hex, got.ps_name, own, leaks))
    msg.append(f"{len(REC_STATIONS)} stations: each its own PI/PS, its "
               f"tone 10x the others' in mono")
    _say("phase 9: recovery mode 0: " + "; ".join(msg))


def _recovery_tracker(dev, all_wrappers) -> None:
    """The IQ tracker (B1's corr variant) on test_iqcorr.py's faulted
    and multipath captures, against the tracker off."""
    import numpy as np
    from dy4tpu_torch.config import get_mode
    cfg = get_mode(0)
    caps = {"clean": _stereo_capture(cfg, 10, 800.0, 2400.0, 0.8),
            "dirty": _stereo_capture(cfg, 10, 800.0, 2400.0, 0.8, **FAULT),
            "multipath": _stereo_capture(
                cfg, 12, 800.0, 2400.0, 0.8,
                multipath=[(24, 0.35 * np.exp(1j * 2.0)),
                           (60, 0.2 * np.exp(-1j * 0.7))],
                dc_i=0.1, dc_q=-0.06, iq_gain=0.72, iq_phase_deg=18.0)}
    sep = {}
    for on, names in ((False, ("clean", "dirty", "multipath")),
                      (True, ("dirty", "multipath"))):
        outs = _run_batch(f"tracker {'on' if on else 'off'} "
                          f"({', '.join(names)})", cfg,
                          [caps[n] for n in names], dev, all_wrappers,
                          corr=on)
        for ch, name in enumerate(names):
            n = len(caps[name]) // cfg.block_size
            sep[name, on] = _sep_db(cfg, outs.left[:n, ch],
                                    outs.right[:n, ch])
    clean, dirty = sep["clean", False], sep["dirty", False]
    fixed = sep["dirty", True]
    mp_off, mp_on = sep["multipath", False], sep["multipath", True]
    _check("tracker", clean - dirty > 10.0 and fixed - dirty > TRACK_GAIN_DB
           and fixed > clean - 4.0 and mp_on - mp_off > TRACK_GAIN_DB
           and mp_on > 28.0, sep)
    _say(f"phase 9: IQ tracker: separation clean {clean:.1f} dB, faulted "
         f"{dirty:.1f} -> {fixed:.1f} with the tracker; through two echoes "
         f"{mp_off:.1f} -> {mp_on:.1f} (bars: the fault costs > 10, the "
         f"tracker wins > {TRACK_GAIN_DB:g} back, within 4 of clean; "
         f"multipath > {TRACK_GAIN_DB:g} and > 28)")


def _recovery_mode2(dev, all_wrappers) -> None:
    """test_mode2_rds_property.py's CDR dropouts at mode 2, C=2: row 0 its
    capture, row 1 another station through the same dropouts; each row
    at the four properties."""
    import numpy as np
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.rds.fleet import FleetDecoder
    from dy4tpu_torch.rds import coding
    from dy4tpu_torch.tx import fm
    cfg = get_mode(2)
    bs = cfg.block_size
    caps = []
    for pi, pty, ps in MODE2_ROWS:
        bits = coding.make_ps_bitstream(pi, pty, ps, repeats=80)
        iq = fm.synthesize(cfg, MODE2_BLOCKS, rds_bits=bits).copy()
        iq[14 * bs:16 * bs] = 128                     # edge-aligned
        start = 30 * bs + 20011 * 2                   # mid-block, mid-symbol
        iq[start:start + int(1.4 * bs) // 2 * 2] = 128
        caps.append(iq)
    outs = _run_batch("recovery mode 2 (CDR dropouts, C=2)", cfg, caps, dev,
                      all_wrappers)
    fleet = FleetDecoder(len(caps))
    for k in range(MODE2_BLOCKS):
        fleet.push_block(outs.rds_symbols[k], resync=outs.rds_resync[k],
                         offsets=outs.rds_offset[k])
    for row, (pi, _, ps) in enumerate(MODE2_ROWS):
        sym = outs.rds_symbols[:, row]
        rs = outs.rds_resync[:, row]
        off = outs.rds_offset[:, row]
        label = f"mode 2 row {row} ({ps!r})"
        _check(label, rs[15:18].any() and rs[31:34].any()
               and not rs[24:30].any() and not rs[40:].any(),
               f"resync at blocks {np.nonzero(rs)[0].tolist()}")
        _, gated, blocks = _rds_info(sym, rs, off)
        _, raw, _ = _rds_info(sym, rs)
        after_b = sum(b >= 36 for b in blocks)
        _check(label, len(gated.groups) >= 8 and after_b >= 2
               and all(g.blocks["A"] == pi for g in gated.groups),
               f"{len(gated.groups)} groups, {after_b} after block 36, PIs "
               f"{sorted({g.blocks['A'] for g in gated.groups})}")
        raw_by_pos = {g.bit_position: g.blocks for g in raw.groups}
        _check(label, len(gated.groups) >= len(raw.groups) and all(
            g.blocks == raw_by_pos[g.bit_position] for g in gated.groups
            if g.bit_position in raw_by_pos),
            f"gated {len(gated.groups)} groups, raw {len(raw.groups)}")
        _check(label, [(g.blocks, g.bit_position) for g in fleet.groups[row]]
               == [(g.blocks, g.bit_position) for g in gated.groups],
               "the fleet decoder's groups differ from the scalar one's")
        _say(f"phase 9: {label}: resync at blocks "
             f"{np.nonzero(rs)[0].tolist()}, {len(gated.groups)} groups "
             f"(offset-gated; {len(raw.groups)} raw), all PI {pi:04X}, "
             f"{after_b} after the second dropout; the fleet decoder's "
             f"groups equal the scalar one's")


def _run_recovery(dev, smi, all_wrappers) -> None:
    """Phase 9: the soak at modes 0 and 2, then the recovery runs.  No
    check is caught: a failed property ends the script."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, cycles, timing in SOAK_RUNS:
            rates[mode] = _soak(mode, cycles, timing, dev, smi, all_wrappers,
                                Path(tmp))
            torch.cuda.empty_cache()
    _recovery_mode0(dev, all_wrappers)
    _recovery_tracker(dev, all_wrappers)
    _recovery_mode2(dev, all_wrappers)
    _say(f"phase 9: soak " + "; ".join(
        f"mode {m}: {r['ms']:.4f} ms a block, {r['msps']:.1f} MS/s"
        for m, r in rates.items())
        + f"; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB; phase 9 {time.perf_counter() - t_phase:.1f} s on {smi}")


def main() -> None:
    t_start = time.perf_counter()
    import torch

    # ---- 0. the card ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's kernels run only on a CUDA device")
    from dy4tpu_torch.ops import (backend_cuda, channelizer_cuda, fft_cuda,
                                  fir_cuda, frontend_cuda, pll_cuda,
                                  resample_cuda)
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
                    pll_cuda.phase_scan_coded,
                    backend_cuda.fused_audio_backend,
                    resample_cuda.fused_audio_backend_rational,
                    resample_cuda.fused_rds_backend,
                    channelizer_cuda.channelize_branches, fft_cuda.fft,
                    frontend_cuda.fused_frontend_raw,
                    frontend_cuda.fused_frontend,
                    frontend_cuda.fused_frontend_raw_pm,
                    fir_cuda.block_fir_decim,
                    pll_cuda.phase_scan_target.expand]
    # ---- 2 + 3, mode by mode, then the wideband front door ----
    results: list[dict] = []
    rates: dict = {}
    for mode in (0, 1, 2, 3):
        results += _run_mode(mode, dev, smi, all_wrappers, rates)
        torch.cuda.empty_cache()
    _plan_fit()
    results += _run_wideband(dev, smi, all_wrappers)
    torch.cuda.empty_cache()
    _run_cli(smi)
    torch.cuda.empty_cache()
    results += _run_sharded(dev, smi, all_wrappers)
    torch.cuda.empty_cache()
    results += _run_psd(dev, smi, all_wrappers)
    torch.cuda.empty_cache()
    results += _run_ab(dev, smi, all_wrappers)
    torch.cuda.empty_cache()
    _run_fleet(dev, smi, all_wrappers, rates)
    torch.cuda.empty_cache()
    _run_recovery(dev, smi, all_wrappers)

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

"""Command-line receiver on the card: the counterpart of ``dy4tpu/app.py``,
flag for flag, plus ``--device``.

Contract (the reference CLI, src/project.cpp:137-174): read interleaved
8-bit unsigned IQ on stdin, write S16LE PCM on stdout, keep stderr for
human-facing output:

    cat samples.raw | python -m dy4tpu_torch 0 s | aplay -f S16_LE -c 2 -r 48000
    rtl_sdr -f 99.9M -s 2.4M - | python -m dy4tpu_torch 0 r

Paths: ``m``/``mono``, ``s``/``stereo``, ``r``/``rds`` (mono audio + RDS
console output), plus ``sr`` (stereo audio + RDS).

Pipeline shape: each chunk of ``--chunk`` blocks is ``receiver_step``
(plus the stereo blend and the de-emphasis) a block, then one quantize,
run by ``pipeline/graph.py``'s ``cli_runner``: on the card one replay of
the chunk's captured CUDA graph (dy4tpu's jitted ``run_chunk``; a ragged
last chunk has a graph of its own), on the CPU the same body eagerly.
Its PCM and RDS outputs go to pinned host buffers by asynchronous copies
on the stream, ahead of the next replay, and a CUDA event marks their
arrival; the host writes chunk k (waiting on chunk k's event alone) after
it has enqueued chunk k+1, so host I/O overlaps the card's work.  (A
plain ``.cpu()`` of chunk k issued after chunk k+1 was enqueued would
wait for chunk k+1 too.)  ``--device cpu`` runs the plain versions on the
CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np

from dy4tpu_torch.config import get_mode
from dy4tpu_torch.utils import io as dio

_PATHS = {"m": "mono", "mono": "mono",
          "s": "stereo", "stereo": "stereo",
          "r": "rds", "rds": "rds",
          # beyond the constraints contract (m|s|r): stereo audio AND RDS
          # console output in one run
          "sr": "stereo_rds", "stereo-rds": "stereo_rds"}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dy4tpu_torch",
        description="FM broadcast receiver (mono/stereo/RDS) on an NVIDIA "
                    "GPU: the PyTorch / CUDA port of dy4tpu",
        epilog="Environment (defaults = reference parity): "
               "DY4TPU_PLL_SPAN=K opts into the decimated-feedback span "
               "PLL (one loop update per K samples; the block's IF length "
               "must divide by K); DY4TPU_CDR=envelope selects whole-block "
               "RDS timing (as --cdr envelope; recommended for mode 2); "
               "DY4TPU_SPAN_EMIT=kernel has the span PLL's scan emit the "
               "within-span phases itself (B9-expand; 'torch', the "
               "default, rebuilds them after the scan).  "
               "dy4tpu's A/B knobs DY4TPU_FRONTEND, DY4TPU_BACKEND and "
               "DY4TPU_NCO_TRIG are not honoured: on a CUDA device every "
               "stage runs its hand-written kernel, on --device cpu its "
               "plain torch version.")
    p.add_argument("mode", type=int, choices=[0, 1, 2, 3],
                   help="operating mode (sample-rate preset)")
    p.add_argument("path", choices=sorted(_PATHS),
                   help="m=mono, s=stereo, r=mono+RDS, sr=stereo+RDS")
    p.add_argument("--input", default=None, metavar="FILE",
                   help="u8 IQ capture file (default: stdin)")
    p.add_argument("--output", default=None, metavar="FILE",
                   help="PCM output file (default: stdout)")
    p.add_argument("--wav", default=None, metavar="FILE",
                   help="also write decoded audio to a WAV file")
    p.add_argument("--max-blocks", type=int, default=None,
                   help="stop after N blocks")
    p.add_argument("--stats", action="store_true",
                   help="per-100-block throughput on stderr")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="save receiver state here on EOF/interrupt")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint every N blocks")
    p.add_argument("--resume", default=None, metavar="FILE",
                   help="resume from a checkpoint file of this package or "
                        "of dy4tpu (trusted input only: checkpoints embed "
                        "pickled host state)")
    p.add_argument("--chunk", type=int, default=1, metavar="N",
                   help="blocks per device round trip: higher amortises "
                        "the host's per-chunk work for throughput, 1 = "
                        "lowest latency")
    p.add_argument("--no-native", action="store_true",
                   help="use pure-Python stream I/O instead of the native "
                        "runtime (ring buffers + I/O threads)")
    p.add_argument("--audio-filter", choices=["reference", "kaiser"],
                   default="reference",
                   help="audio resampler design: reference Hann "
                        "windowed-sinc (parity default) or Kaiser "
                        "(~30 dB more alias rejection at the same tap "
                        "count)")
    p.add_argument("--stereo-blend", action="store_true",
                   help="fade the stereo difference channel out as the "
                        "pilot-lock SNR weakens (default keeps the "
                        "reference's always-full-stereo matrix)")
    p.add_argument("--deemphasis", choices=["off", "us", "eu"],
                   default="off",
                   help="FM de-emphasis (75 us / 50 us single-pole IIR) "
                        "on the decoded audio; 'off' (parity default) "
                        "matches the reference")
    p.add_argument("--cdr", choices=["peak", "envelope"], default=None,
                   help="RDS symbol-timing acquisition: 'peak' (reference "
                        "parity) or 'envelope' (square-law estimate over "
                        "the whole block, more robust at mode 2's SPS=27); "
                        "default honours DY4TPU_CDR, else peak")
    p.add_argument("--iqcorr", action="store_true",
                   help="blind DC-offset + IQ-imbalance correction on the "
                        "tuner stream (ops/iqcorr.py; default off = "
                        "reference parity)")
    p.add_argument("--rds-json", default=None, metavar="FILE",
                   help="write one JSON-lines event per decoded RDS group "
                        "to FILE ('-' = stderr): the accumulated station "
                        "snapshot plus the carrying group type")
    p.add_argument("--rds-standard", choices=["rds", "rbds"],
                   default="rds",
                   help="PTY name table: 'rds' = European list, 'rbds' = "
                        "the North-American NRSC-4-B list")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; the hand-written "
                        "kernels) or 'cpu' (the plain versions)")
    return p


def _env_settings(cli_cdr: Optional[str]) -> tuple[int, str, str]:
    """(pll_span, pll_span_emit, cdr_timing) from the flags and the
    environment, as dy4tpu's CLI resolves them; the library reads no
    environment."""
    raw = os.environ.get("DY4TPU_PLL_SPAN", "1")
    try:
        span = int(raw)
    except ValueError:
        raise SystemExit(f"DY4TPU_PLL_SPAN={raw!r}: expected an integer")
    if span < 1:
        raise SystemExit(f"DY4TPU_PLL_SPAN={span}: expected >= 1")
    # dy4tpu's name for the default is "xla"
    raw = os.environ.get("DY4TPU_SPAN_EMIT", "torch")
    emit = {"xla": "torch"}.get(raw, raw)
    if emit not in ("torch", "kernel"):
        raise SystemExit(f"DY4TPU_SPAN_EMIT={raw!r}: expected torch (or "
                         f"xla) or kernel")
    cdr = cli_cdr or os.environ.get("DY4TPU_CDR", "peak")
    if cdr not in ("peak", "envelope"):
        raise SystemExit(f"DY4TPU_CDR={cdr!r}: expected peak or envelope")
    return span, emit, cdr


def rds_event(info, group) -> dict:
    """The ``--rds-json`` event of a decoded group: the accumulated station
    snapshot ``info`` (``ApplicationLayer.process``'s) and the carrying
    group type."""
    return {"group": f"{info.group_type}{info.version}",
            "bit_position": group.bit_position, **info.to_dict()}


def main(argv: Optional[list[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    path = _PATHS[args.path]
    cfg = get_mode(args.mode)

    want_rds = path in ("rds", "stereo_rds")
    if want_rds and not cfg.supports_rds:
        print(f"mode {args.mode} does not support RDS "
              f"(constraints pdf p.1: SPS defined for modes 0 and 2)",
              file=sys.stderr)
        return 2
    pll_span, span_emit, cdr = _env_settings(args.cdr)
    if cfg.if_per_block % pll_span:
        raise SystemExit(f"DY4TPU_PLL_SPAN={pll_span} does not divide mode "
                         f"{args.mode}'s {cfg.if_per_block} IF samples per "
                         f"block")
    if want_rds and args.mode == 2 and cdr == "peak":
        # the reference's two-symbol peak-search CDR mislocks even a
        # noiseless mode-2 capture (SPS=27): say so, and which flag fixes it
        print("hint: mode 2 RDS with the default 'peak' timing "
              "acquisition (reference parity) mislocks easily at SPS=27 "
              "— pass --cdr envelope (or DY4TPU_CDR=envelope) for "
              "robust decode (measured: BER 0 through 8 dB SNR vs 17.7%)",
              file=sys.stderr)

    import torch

    from dy4tpu_torch.runtime import kernels

    dev = kernels.cli_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        # float32 throughout (dy4tpu's precision=HIGHEST): no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from dy4tpu_torch.ops import deemph as deemphops
    from dy4tpu_torch.ops import iqcorr as iqcorr_ops
    from dy4tpu_torch.pipeline import graph, receiver
    from dy4tpu_torch.rds.app import ApplicationLayer
    from dy4tpu_torch.rds.decoder import RDSDecoder
    from dy4tpu_torch.utils import checkpoint as ckpt

    stereo = path in ("stereo", "stereo_rds")
    params = receiver.make_params(cfg, with_rds=want_rds,
                                  audio_filter=args.audio_filter, device=dev)
    state = receiver.init_state(cfg, batch=(1,), with_rds=want_rds,
                                with_iqcorr=args.iqcorr, device=dev)
    block0 = 0
    decoder = RDSDecoder() if want_rds else None
    applayer = (ApplicationLayer(verbose=True, standard=args.rds_standard)
                if want_rds else None)

    resume_host: dict = {}
    if args.resume:
        # the tracker goes with the file, as in dy4tpu: resumed where the
        # checkpoint holds one (with or without --iqcorr), started afresh
        # for --iqcorr where it holds none
        tracked = receiver.init_state(cfg, batch=(1,), with_rds=want_rds,
                                      with_iqcorr=True, device=dev)
        if not ckpt.holds(args.resume, "iqcorr", tracked):
            tracked = tracked._replace(iqcorr=None)
        state, resume_host, meta = ckpt.load(args.resume, tracked)
        if args.iqcorr and state.iqcorr is None:
            state = state._replace(iqcorr=iqcorr_ops.init_iqcorr_state(
                (1,), device=dev))
        block0 = int(meta.get("block", 0))
        if want_rds and "manchester" in resume_host:
            decoder.manchester = resume_host["manchester"]
            decoder.framer = resume_host["framer"]
            decoder._last_offset = resume_host.get("last_offset")
        print(f"resumed from {args.resume} at block {block0}",
              file=sys.stderr)

    de_a = None
    if args.deemphasis != "off":
        tau = (deemphops.TAU_US_75 if args.deemphasis == "us"
               else deemphops.TAU_EU_50)
        de_a = deemphops.deemph_coeff(cfg.audio_fs, tau)
    de_state = deemphops.init_deemph_state((1,), stereo=stereo, device=dev)
    if ("deemph" in resume_host
            and len(resume_host["deemph"]) == len(de_state)):
        de_state = tuple(torch.as_tensor(np.asarray(d, np.float32),
                                         device=dev)
                         for d in resume_host["deemph"])

    # the chunk body, captured as a CUDA graph a chunk size on the card;
    # it owns the carried receiver and de-emphasis state from here on
    runner = graph.cli_runner(
        params, state, de_state, cfg, stereo=stereo,
        blend=args.stereo_blend, de_a=de_a, keep_rds=decoder is not None,
        with_rds=want_rds, cdr_timing=cdr, pll_span=pll_span,
        pll_span_emit=span_emit)

    def save_checkpoint(block: int) -> None:
        if not args.checkpoint:
            return
        state, de_state = runner.read()
        host = {}
        if decoder is not None:
            host = {"manchester": decoder.manchester,
                    "framer": decoder.framer,
                    "last_offset": decoder._last_offset}
        # de-emphasis carry (one sample per stream; resumes seamlessly)
        host["deemph"] = tuple(d.cpu().numpy() for d in de_state)
        ckpt.save(args.checkpoint, state, host_state=host,
                  meta={"block": block, "mode": args.mode, "path": path})

    rds_json = None
    if applayer is not None:
        if args.rds_json:
            import json as _json
            rds_json = (sys.stderr if args.rds_json == "-"
                        else open(args.rds_json, "w"))

            def _on_group(group):
                evt = rds_event(applayer.process(group), group)
                print(_json.dumps(evt), file=rds_json, flush=True)

            decoder.on_group = _on_group
        else:
            decoder.on_group = applayer.process

    fin = open(args.input, "rb") if args.input else None
    fout = open(args.output, "wb") if args.output else None
    wav_chunks: list[np.ndarray] = []

    # native streaming runtime: reader/writer threads + SPSC rings keep the
    # pipes flowing while the card computes (replaces the reference's
    # frontend-thread + threadSafeQ, project.cpp:289-305)
    source = sink = None
    if not args.no_native:
        try:
            from dy4tpu_torch.runtime.native import (NativeSink,
                                                     NativeSource,
                                                     available)
            if available():
                in_fd = fin.fileno() if fin else sys.stdin.buffer.fileno()
                out_fd = (fout.fileno() if fout
                          else sys.stdout.buffer.fileno())
                source = NativeSource(in_fd, cfg.block_size,
                                      capacity_blocks=8)
                sink = NativeSink(out_fd)
        except Exception as e:  # fall back to Python I/O
            print(f"native runtime unavailable ({e}); using Python I/O",
                  file=sys.stderr)
            source = sink = None

    def to_host(t):
        """``t`` copied to host memory: on the card, an asynchronous copy
        into a pinned buffer (complete once the chunk's event is)."""
        if not on_card:
            return t
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    def run_chunk(blocks):
        """``blocks`` [k, 1, block_size] u8 on the card -> (pcm, symbols,
        resync, offsets) on the host, an event marking their arrival (None
        on the CPU), and k.  Advances the runner's state.  The copies out
        are issued before the next replay can overwrite the outputs."""
        host = [to_host(t) for t in runner.run(blocks)]
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record()
        return host, event, int(blocks.shape[0])

    n_done = 0
    pending = None  # (host buffers, event, k) of a chunk not written yet
    t0 = time.perf_counter()
    t_report = t0
    last_n = 0

    def drain(p, ignore_sink_errors: bool = False) -> None:
        nonlocal n_done, t_report, last_n
        host, event, k = p
        if event is not None:
            event.synchronize()            # this chunk's copies, no more
        pcm = host[0].numpy()              # [k, 1, n]
        flat = np.ascontiguousarray(pcm.reshape(-1), dtype="<i2")
        try:
            if sink is not None:
                sink.push(flat)
            else:
                dio.write_pcm(fout, flat)
        except (BrokenPipeError, TimeoutError, OSError):
            # on the shutdown path the host decoder and the block counter
            # still advance, so the checkpoint stays consistent even when
            # the PCM consumer is already gone
            if not ignore_sink_errors:
                raise
        if args.wav:
            wav_chunks.append(flat.astype(np.float32) / 16384.0)
        if decoder is not None:
            syms, res, offs = (h.numpy() for h in host[1:])
            for j in range(k):
                decoder.push_block(syms[j, 0], resync=bool(res[j, 0]),
                                   offset=int(offs[j, 0]))
        n_done += k
        if args.stats and n_done // 100 != (n_done - k) // 100:
            now = time.perf_counter()
            iq_rate = (n_done - last_n) * cfg.iq_per_block / (now - t_report)
            last_n = n_done
            print(f"block {block0 + n_done}: {iq_rate/1e6:.1f} MS/s "
                  f"({iq_rate / cfg.rf_fs:.1f}x real-time)",
                  file=sys.stderr)
            t_report = now

    def read_chunks():
        blocks_iter = (iter(source) if source is not None
                       else dio.read_iq_blocks(fin, cfg.block_size))
        buf = []
        n_in = 0
        for blk in blocks_iter:
            if args.max_blocks is not None and n_in >= args.max_blocks:
                break
            buf.append(blk)
            n_in += 1
            if len(buf) == max(1, args.chunk):
                yield np.stack(buf)[:, None, :]
                buf = []
        if buf:
            yield np.stack(buf)[:, None, :]

    def to_device(chunk_np):
        t = torch.from_numpy(chunk_np)
        if not on_card:
            return t
        # through pinned memory, so the copy does not wait for the card
        return t.pin_memory().to(dev, non_blocking=True)

    try:
        done_blocks = 0
        for chunk_np in read_chunks():
            nxt = run_chunk(to_device(chunk_np))
            if pending is not None:
                drain(pending)
            pending = nxt
            done_blocks += nxt[2]
            if (args.checkpoint_every and args.checkpoint
                    and done_blocks % args.checkpoint_every == 0):
                # drain first so device state and host decoder state refer
                # to the same block boundary in the snapshot
                drain(pending)
                pending = None
                save_checkpoint(block0 + done_blocks)
        if pending is not None:
            drain(pending)
            pending = None
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
    except BrokenPipeError:
        # downstream (e.g. `| aplay` or `| head`) went away: stop cleanly,
        # as the reference exits at EOF (project.cpp:293-296)
        print("downstream closed; stopping", file=sys.stderr)
    finally:
        # drain any chunk in flight BEFORE checkpointing, so the saved
        # device state, host decoder state and block counter all refer to
        # the same block boundary
        if pending is not None:
            try:
                drain(pending, ignore_sink_errors=True)
            except Exception as e:
                print(f"warning: could not drain final chunk ({e}); "
                      f"checkpoint reflects the last drained block",
                      file=sys.stderr)
            pending = None
        save_checkpoint(block0 + n_done)
        if source is not None:
            source.close()
        if sink is not None:
            try:
                sink.flush()
            except (BrokenPipeError, TimeoutError):
                pass
            sink.close()
        if fin:
            fin.close()
        if args.wav and wav_chunks:
            audio = np.concatenate(wav_chunks)
            if stereo:
                audio = audio.reshape(-1, 2)
            dio.write_wav(args.wav, audio, cfg.audio_fs)
        if fout:
            fout.close()

    if rds_json is not None and rds_json is not sys.stderr:
        rds_json.close()

    dt = time.perf_counter() - t0
    iq = n_done * cfg.iq_per_block
    print(f"processed {n_done} blocks ({iq/1e6:.1f} MIQ samples) in "
          f"{dt:.2f}s = {iq/dt/1e6:.1f} MS/s "
          f"({iq/dt/cfg.rf_fs:.1f}x real-time) on {dev}", file=sys.stderr)
    if applayer is not None:
        info = applayer.info
        print(f"RDS: PI={info.pi_hex} PTY={info.pty_name!r} "
              f"PS={info.ps_name!r} ({info.groups_seen} groups)"
              + (f" RT={info.radiotext!r}" if info.radiotext else "")
              + (" AF=" + ",".join(f"{f:.1f}" for f in info.af_mhz)
                 if info.af_mhz else "")
              + (f" PTYN={info.ptyn!r}" if info.ptyn else "")
              + (f" PIN={info.pin_str}" if info.pin else "")
              + (f" CT={info.clock_time_str}" if info.clock_time else "")
              + (" ODA=" + ",".join(f"{g}:{aid:04X}"
                                    for g, aid in sorted(info.oda.items()))
                 if info.oda else "")
              + (f" eRT={info.ert!r}" if info.ert else "")
              + (" RT+=" + ",".join(f"{k}={v!r}"
                                    for k, v in info.rtplus.items())
                 if info.rtplus else "")
              + (" TMC=[" + "; ".join(info.tmc_str) + "]"
                 if info.tmc_messages else "")
              + ("".join(
                  f" EON[{on.pi:04X}]={on.ps_name or '?'!r}"
                  + (f" TA={on.ta}" if on.ta is not None else "")
                  for on in info.eon.values())
                 if info.eon else ""),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

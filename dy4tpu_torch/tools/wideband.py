"""Wideband multi-station CLI of the port: one capture in, every station
out.  The counterpart of ``dy4tpu/tools/wideband.py``, with the same
arguments and output, plus ``--device``.

The input is one complex u8 IQ capture of a whole band at ``fs_w =
channels * if_fs(mode)``; the polyphase DFT filter bank
(``ops/channelizer.py``, kernel B7 on the card) splits it into per-station
basebands on the receiver's batch axis, and every station rides the same
chain.

    # which channels are alive?
    python -m dy4tpu_torch.tools.wideband band.raw --mode 0 --channels 8 --scan

    # decode stations 1 and 3: WAVs + RDS console
    python -m dy4tpu_torch.tools.wideband band.raw --mode 0 --channels 8 \\
        --stations 1,3 --out-dir decoded/

``--device`` defaults to ``cuda`` (the kernels) and fails when the machine
has no CUDA device; ``--device cpu`` runs the plain versions on the CPU.
``--stations auto`` (default) squelches on RSSI: channels at least
``--squelch-db`` above the quietest channel are decoded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _parse_stations(spec: str, channels: int):
    if spec == "auto":
        return None
    out = sorted({int(s) for s in spec.split(",") if s.strip()})
    for c in out:
        if not 0 <= c < channels:
            raise SystemExit(f"station {c} outside [0, {channels})")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="channelize a wideband capture and decode every "
                    "station (scan / WAV / RDS)")
    p.add_argument("capture", help="wideband u8 IQ file ('-' = stdin), "
                                   "fs = channels * if_fs(mode)")
    p.add_argument("--mode", type=int, default=0, choices=[0, 1, 2, 3])
    p.add_argument("--channels", type=int, required=True,
                   help="filter-bank size C (band width = C * if_fs)")
    p.add_argument("--stations", default="auto",
                   help="comma-separated channel indices, or 'auto' "
                        "(RSSI squelch, >=15 dB over the floor)")
    p.add_argument("--scan", action="store_true",
                   help="print the per-channel RSSI table and exit")
    p.add_argument("--out-dir", default=".",
                   help="directory for per-station WAV files")
    p.add_argument("--stereo", action="store_true",
                   help="write stereo WAVs (default: mono)")
    p.add_argument("--no-rds", action="store_true",
                   help="skip the RDS chain/decoders")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--chunk", type=int, default=4,
                   help="wideband blocks per copy to the device")
    p.add_argument("--squelch-db", type=float, default=15.0,
                   help="'auto' threshold above the quietest channel")
    p.add_argument("--afc", action="store_true",
                   help="track per-channel carrier offsets (stations "
                        "off the channel grid) and report them")
    p.add_argument("--iqcorr", action="store_true",
                   help="blind wideband-tuner fault correction applied "
                        "before the channel bank (a faulted tuner images "
                        "every station into its mirrored channel)")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; the hand-written "
                        "kernels) or 'cpu' (the plain versions)")
    args = p.parse_args(argv)

    import torch

    from dy4tpu.config import get_mode
    from dy4tpu.utils import io as dio
    from dy4tpu_torch.ops import afc as afc_ops
    from dy4tpu_torch.pipeline import receiver, wideband

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch finds no CUDA device on this "
                         "machine (pass --device cpu for the plain "
                         "versions on the CPU)")
    cfg = get_mode(args.mode)
    c = args.channels
    step_u8 = 2 * c * cfg.if_per_block
    raw = (np.frombuffer(sys.stdin.buffer.read(), np.uint8)
           if args.capture == "-" else dio.read_raw_u8(args.capture))
    n_steps = len(raw) // step_u8
    if args.max_steps:
        n_steps = min(n_steps, args.max_steps)
    if n_steps == 0:
        print(f"capture shorter than one wideband step ({step_u8} B)",
              file=sys.stderr)
        return 1
    rds_on = cfg.supports_rds and not args.no_rds
    host = raw[:n_steps * step_u8].reshape(n_steps, step_u8)
    k = max(1, args.chunk)

    params = receiver.make_params(cfg, device=dev)
    chan = wideband.make_wideband(cfg, c, device=dev)
    state = wideband.wideband_init(cfg, chan, with_rds=rds_on,
                                   afc=args.afc, iqcorr=args.iqcorr)

    # ---- pass 1 (or the whole run when scanning): RSSI ----
    t0 = time.perf_counter()
    rssi_acc, outs_all = np.zeros(c), []
    for i in range(0, n_steps, k):
        blocks = torch.from_numpy(host[i:i + k]).to(dev)
        state, outs = wideband.run_wideband_blocks(
            params, chan, state, blocks, cfg, with_rds=rds_on)
        rssi_acc += outs.rssi.mean(0).cpu().numpy() * blocks.shape[0]
        outs_all.append(receiver.StepOutputs(*(
            None if f is None else f.cpu().numpy() for f in outs.rx)))
    rssi = rssi_acc / n_steps
    floor = rssi.min()

    if args.scan or args.stations == "auto":
        live = np.flatnonzero(rssi >= floor + args.squelch_db)
        print(f"# band scan: {c} x {cfg.if_fs / 1e3:.0f} kHz channels, "
              f"{n_steps} steps, floor {floor:.1f} dBFS", file=sys.stderr)
        for ch in range(c):
            bar = "#" * max(0, int(rssi[ch] - floor))
            mark = " *" if ch in live else ""
            print(f"ch {ch:3d}  {rssi[ch]:7.1f} dBFS  {bar}{mark}",
                  file=sys.stderr)
        if args.scan:
            return 0
        stations = list(live)
    else:
        stations = _parse_stations(args.stations, c)
    if not stations:
        print("no stations above squelch", file=sys.stderr)
        return 1

    # ---- assemble per-station audio + drain RDS ----
    cat = lambda f: np.concatenate(  # noqa: E731
        [getattr(o, f).reshape(-1, c, cfg.audio_per_block)
         for o in outs_all], 0)
    os.makedirs(args.out_dir, exist_ok=True)
    for ch in stations:
        if args.stereo:
            audio = np.stack([cat("left")[:, ch].ravel(),
                              cat("right")[:, ch].ravel()], -1)
        else:
            audio = cat("mono")[:, ch].ravel()
        path = os.path.join(args.out_dir, f"station{ch:03d}.wav")
        dio.write_wav(path, audio, int(cfg.audio_fs))
        extra = ""
        if args.afc:
            hz = float(afc_ops.freq_hz(state.afc, cfg.if_fs)[ch])
            extra = f", carrier {hz / 1e3:+.1f} kHz off-grid"
        print(f"ch {ch:3d}: wrote {path} ({len(audio)} frames, "
              f"RSSI {rssi[ch]:.1f} dBFS{extra})", file=sys.stderr)

    if rds_on:
        from dy4tpu.rds.app import ApplicationLayer
        from dy4tpu.runtime import native
        apps = {ch: ApplicationLayer() for ch in stations}
        sel = np.asarray(stations)
        if native.available():
            from dy4tpu.rds.fleet import FleetDecoder
            dec = FleetDecoder(
                len(stations),
                on_group=lambda i, g: apps[stations[i]].process(g))
            push = lambda o, b: dec.push_block(  # noqa: E731
                o.rds_symbols[b, sel], resync=o.rds_resync[b, sel],
                offsets=o.rds_offset[b, sel])
        else:  # pure-Python fallback: one RDSDecoder per station
            from dy4tpu.rds.decoder import RDSDecoder
            decs = {ch: RDSDecoder(on_group=apps[ch].process)
                    for ch in stations}
            push = lambda o, b: [  # noqa: E731
                decs[ch].push_block(o.rds_symbols[b, ch],
                                    resync=bool(o.rds_resync[b, ch]),
                                    offset=int(o.rds_offset[b, ch]))
                for ch in stations]
        for o in outs_all:
            for b in range(o.rds_symbols.shape[0]):
                push(o, b)
        for ch in stations:
            info = apps[ch].info
            print(f"ch {ch:3d}: RDS PI={info.pi_hex} PS={info.ps_name!r} "
                  f"PTY={info.pty} groups={info.groups_seen}",
                  file=sys.stderr)

    dt = time.perf_counter() - t0
    wb_sps = n_steps * c * cfg.if_per_block / dt
    print(f"{n_steps} steps x {c} ch in {dt:.2f} s on {dev} "
          f"({wb_sps / 1e6:.1f} MS/s wideband, "
          f"{wb_sps / (c * cfg.if_fs):.1f}x real time)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

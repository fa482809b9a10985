"""Capture synthesiser CLI of the port: fabricate test broadcasts, the
counterpart of ``dy4tpu/tools/synth.py`` with the same arguments and
byte for byte the same output (numpy and scipy only, no device).

The reference relies on an RTL-SDR dongle or pre-recorded captures
(constraints pdf p.2-3); this tool generates spec-shaped multiplex
captures from the port's transmitter copy (``tx/fm.py``) so any
mode/path can be exercised end-to-end without hardware:

    python -m dy4tpu_torch.tools.synth out.raw --mode 0 --blocks 20 \\
        --left 800 --right 2400 --pi 0xF205 --ps "DY4 TPU!"
    python -m dy4tpu_torch 0 r --input out.raw --rds-json events.jsonl
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="synthesize a u8 IQ FM broadcast capture")
    p.add_argument("outfile")
    p.add_argument("--mode", type=int, default=0, choices=[0, 1, 2, 3])
    p.add_argument("--blocks", type=int, default=20)
    p.add_argument("--left", type=float, default=800.0,
                   help="left-channel tone in Hz (0 = silence)")
    p.add_argument("--right", type=float, default=2400.0,
                   help="right-channel tone in Hz (0 = silence)")
    p.add_argument("--pi", type=lambda s: int(s, 0), default=None,
                   help="RDS programme identification, e.g. 0xF205")
    p.add_argument("--ps", default="DY4 TPU!",
                   help="8-char RDS programme-service name")
    p.add_argument("--pty", type=int, default=10)
    p.add_argument("--radiotext", default=None,
                   help="with --pi: schedule a full station stream "
                        "(0A + 2A radiotext + optional RT+/PTYN/AF) "
                        "instead of PS-only groups")
    p.add_argument("--rt-title", default=None,
                   help="RadioText+ ITEM.TITLE substring of --radiotext")
    p.add_argument("--rt-artist", default=None,
                   help="RadioText+ ITEM.ARTIST substring of --radiotext")
    p.add_argument("--af", default=None,
                   help="comma-separated alternative frequencies in "
                        "MHz, e.g. '98.5,101.1'")
    p.add_argument("--ptyn", default=None,
                   help="programme type name (group 10A)")
    p.add_argument("--noise", type=float, default=0.0,
                   help="additive IQ noise sigma")
    p.add_argument("--dc", type=float, nargs=2, default=(0.0, 0.0),
                   metavar=("I", "Q"),
                   help="tuner LO-leakage DC offsets in signal units "
                        "(ops/iqcorr.py impairment model; single-"
                        "station only)")
    p.add_argument("--iq-imbalance", type=float, nargs=2,
                   default=(1.0, 0.0), metavar=("GAIN", "PHASE_DEG"),
                   help="tuner Q-branch gain and quadrature-phase "
                        "error (exercise the receiver's --iqcorr)")
    p.add_argument("--multipath", default=None,
                   help="static echo profile 'delay:gain[:phase_deg]"
                        "[,...]' in RF samples, e.g. '24:0.5:120,"
                        "60:0.32:-52' (single-station only)")
    p.add_argument("--wideband", type=int, default=0, metavar="C",
                   help="synthesize a C-channel wideband capture at "
                        "fs = C * if_fs instead of one RF station "
                        "(input for dy4tpu_torch.tools.wideband)")
    p.add_argument("--stations", default="1",
                   help="with --wideband: comma-separated channel "
                        "indices to place stations on; station on "
                        "channel c gets tones 500+100c / 2000+100c Hz, "
                        "PI 0x5400+c, PS 'WB CH-xx'")
    args = p.parse_args(argv)

    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.rds import coding
    from dy4tpu_torch.tx import fm

    cfg = get_mode(args.mode)
    n_audio = args.blocks * cfg.audio_per_block

    if args.wideband:
        c = args.wideband
        chans = sorted({int(s) for s in args.stations.split(",")
                        if s.strip()})
        stations = {}
        for ch in chans:
            if not 0 <= ch < c:
                print(f"station channel {ch} outside [0, {c})",
                      file=sys.stderr)
                return 2
            kw: dict = {
                "left": fm.tone(500.0 + 100.0 * ch, cfg.audio_fs,
                                n_audio, amp=0.8),
                "right": fm.tone(2000.0 + 100.0 * ch, cfg.audio_fs,
                                 n_audio, amp=0.8)}
            if cfg.supports_rds:
                repeats = max(8, int(args.blocks * cfg.audio_per_block
                                     / cfg.audio_fs * 1187.5 / 104) + 8)
                kw["rds_bits"] = coding.make_ps_bitstream(
                    0x5400 + ch, args.pty, f"WB CH-{ch:02d}"[:8],
                    repeats=repeats)
            stations[ch] = kw
        iq = fm.synthesize_wideband(cfg, c, args.blocks,
                                    stations=stations, noise=args.noise)
        iq.tofile(args.outfile)
        secs = args.blocks * cfg.if_per_block / cfg.if_fs
        print(f"wrote {args.outfile}: mode {args.mode} wideband x{c} "
              f"({cfg.if_fs * c / 1e6:.2f} MHz), stations {chans}, "
              f"{args.blocks} steps ({secs:.2f}s, {len(iq)} bytes)",
              file=sys.stderr)
        return 0
    left = (fm.tone(args.left, cfg.audio_fs, n_audio, amp=0.7)
            if args.left else None)
    right = (fm.tone(args.right, cfg.audio_fs, n_audio, amp=0.7)
             if args.right else None)
    bits = None
    if args.pi is not None:
        if not cfg.supports_rds:
            print(f"mode {args.mode} does not support RDS", file=sys.stderr)
            return 2
        ps = (args.ps + " " * 8)[:8]
        n_groups = max(32, int(args.blocks * cfg.audio_per_block
                               / cfg.audio_fs * 1187.5 / 104) + 32)
        af = ([float(f) for f in args.af.split(",")] if args.af else ())
        if args.radiotext or args.af or args.ptyn:
            bits = coding.make_station_bitstream(
                args.pi, args.pty, ps, groups=n_groups,
                radiotext=args.radiotext, rt_title=args.rt_title,
                rt_artist=args.rt_artist, af_mhz=af, ptyn=args.ptyn)
        else:
            bits = coding.make_ps_bitstream(args.pi, args.pty, ps,
                                            repeats=n_groups // 4)
    multipath = None
    if args.multipath:
        import numpy as np
        multipath = []
        for part in args.multipath.split(","):
            f = part.split(":")
            gain = float(f[1]) * np.exp(
                1j * np.deg2rad(float(f[2]) if len(f) > 2 else 0.0))
            multipath.append((int(f[0]), gain))
    iq = fm.synthesize(cfg, args.blocks, left=left, right=right,
                       rds_bits=bits, noise=args.noise,
                       dc_i=args.dc[0], dc_q=args.dc[1],
                       iq_gain=args.iq_imbalance[0],
                       iq_phase_deg=args.iq_imbalance[1],
                       multipath=multipath)
    iq.tofile(args.outfile)
    secs = args.blocks * cfg.iq_per_block / cfg.rf_fs
    print(f"wrote {args.outfile}: mode {args.mode}, {args.blocks} blocks "
          f"({secs:.2f}s of broadcast, {len(iq)} bytes)"
          + (f", RDS PI={args.pi:04X} PS={ps!r}" if bits is not None
             else ""),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""PSD inspection tool of the port (the fmMonoAnim.py equivalent), the
counterpart of ``dy4tpu/tools/psdview.py`` with the same arguments plus
``--device``.

Walks a u8 IQ capture block by block through the receiver and renders
per-block PSDs (RF input, RDS baseband, mono audio) either as a single
summary figure, an interactive matplotlib animation, an animated GIF, or
a headless PNG frame sequence (model/fmMonoAnim.py:44-141 FuncAnimation;
fmPlotPSD fmSupportLib.py:164-192).  On the card every PSD's segment
transforms run through kernel B10 (``ops/fft_cuda.py``).

    python -m dy4tpu_torch.tools.psdview capture.raw --mode 0 --out psd.png
    python -m dy4tpu_torch.tools.psdview capture.raw --animate --out psd.gif
    python -m dy4tpu_torch.tools.psdview capture.raw --animate --out frames_%02d.png

``--device`` defaults to ``cuda`` and fails when the machine has no CUDA
device; ``--device cpu`` runs the plain versions on the CPU.  matplotlib
is needed only to draw: ``_block_psds`` computes without it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _block_psds(args, cfg):
    """First pass: per-block PSD curves for every panel, on
    ``args.device``."""
    import torch

    from dy4tpu_torch.ops import fft
    from dy4tpu_torch.pipeline import receiver
    from dy4tpu_torch.utils import io as dio

    dev = torch.device(args.device)
    iq = dio.read_raw_u8(args.infile)
    n_blocks = min(args.blocks, len(iq) // cfg.block_size)
    if n_blocks == 0:
        return None, 0

    params = receiver.make_params(cfg, device=dev)
    state = receiver.init_state(cfg, device=dev)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    frames = []
    for b in range(n_blocks):
        blk = torch.from_numpy(
            iq[b * cfg.block_size:(b + 1) * cfg.block_size]).to(dev)
        x = (blk.to(torch.float32) - 128.0) / 128.0
        i = x[0::2]
        state, outs = receiver.receiver_step(params, state, blk, cfg)
        f1, p1 = fft.estimate_psd(i, nfft=args.nfft, fs=cfg.rf_fs)
        mono = outs.mono
        f3, p3 = fft.estimate_psd(mono, nfft=min(args.nfft, mono.shape[-1]),
                                  fs=cfg.audio_fs)
        panel2 = None
        if outs.rds_bb_i is not None:
            bb = outs.rds_bb_i
            f2, p2 = fft.estimate_psd(bb, nfft=min(args.nfft, bb.shape[-1]),
                                      fs=cfg.rds_fs)
            panel2 = (f2 / 1e3, host(p2))
        frames.append(((f1 / 1e3, host(p1)), panel2, (f3 / 1e3, host(p3))))
    return frames, n_blocks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="per-block PSD inspection")
    p.add_argument("infile", help="u8 interleaved IQ capture")
    p.add_argument("--mode", type=int, default=0, choices=[0, 1, 2, 3])
    p.add_argument("--blocks", type=int, default=8,
                   help="number of blocks to process")
    p.add_argument("--block", type=int, default=None,
                   help="render only this block index (default: last)")
    p.add_argument("--animate", action="store_true",
                   help="one frame per block (fmMonoAnim.py parity): "
                        "--out .gif = animated GIF, --out with %%d = PNG "
                        "sequence, no --out = interactive window")
    p.add_argument("--out", default=None,
                   help="write image(s) here instead of showing a window")
    p.add_argument("--nfft", type=int, default=512)
    p.add_argument("--fps", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; kernel B10 and the "
                        "receiver's kernels) or 'cpu' (the plain versions)")
    args = p.parse_args(argv)

    from dy4tpu_torch.runtime import kernels

    kernels.cli_device(args.device)
    try:
        import matplotlib
        if args.out:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available", file=sys.stderr)
        return 1

    from dy4tpu_torch.config import get_mode

    cfg = get_mode(args.mode)
    frames, n_blocks = _block_psds(args, cfg)
    if n_blocks == 0:
        print("capture shorter than one block", file=sys.stderr)
        return 1

    titles = ("RF input I", "RDS baseband (post-RRC)", "mono audio")
    fig, axes = plt.subplots(3, 1, figsize=(9, 9))
    for ax, t in zip(axes, titles):
        ax.set_title(t)
        ax.set_xlabel("kHz")
        ax.set_ylabel("dB/Hz")
        ax.grid(True)

    def draw(b: int) -> None:
        for ax, panel, t in zip(axes, frames[b], titles):
            for ln in list(ax.lines):
                ln.remove()
            if panel is not None:
                ax.plot(panel[0], panel[1], color="C0")
            ax.relim()
            ax.autoscale_view()
        axes[0].set_title(f"{titles[0]} (block {b})")
        fig.tight_layout()

    if not args.animate:
        draw(args.block if args.block is not None else n_blocks - 1)
        if args.out:
            fig.savefig(args.out, dpi=110)
            print(f"wrote {args.out}", file=sys.stderr)
        else:
            plt.show()
        return 0

    if args.out and "%" in args.out:
        for b in range(n_blocks):
            draw(b)
            path = args.out % b
            fig.savefig(path, dpi=90)
        print(f"wrote {n_blocks} frames ({args.out})", file=sys.stderr)
        return 0

    from matplotlib.animation import FuncAnimation, PillowWriter
    anim = FuncAnimation(fig, draw, frames=n_blocks,
                         interval=1000 // max(args.fps, 1))
    if args.out:
        anim.save(args.out, writer=PillowWriter(fps=args.fps))
        print(f"wrote {args.out} ({n_blocks} frames)", file=sys.stderr)
    else:
        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())

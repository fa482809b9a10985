"""Fingerprint the port's float32 path on one GPU, to hold it bit for bit
against another checkout of the port (the one before a change).

    python3 highest_bitwise.py CHECKOUT [CHECKOUT ...]

For each checkout (a directory holding ``dy4tpu_torch``), in a fresh
process: build its kernels, run its receiver with no ``precision``
keyword (the float32 path, "highest" where the keyword exists) on the
bench broadcast at C=512 x 8 blocks (channel c from byte 74*c on, odd
channels I/Q swapped) at modes 0-3, the IF entry at mode 0, the IQ
tracker, ``frontend="fused-rf"`` and ``"fused-phase"`` at mode 0, and the
wideband step (4 bands x 16 channels, 4 steps), and print the SHA-256 of
every output and end-state leaf.  Then say which leaves differ between
the checkouts (none: bitwise equal), and exit 1 where any does.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

C, N_BLOCKS, SHIFT = 512, 8, 74


def _leaves(tree, prefix=""):
    import torch
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for k, v in enumerate(tree):
        name = tree._fields[k] if hasattr(tree, "_fields") else str(k)
        out.update(_leaves(v, f"{prefix}.{name}" if prefix else name))
    return out


def _digest(tree) -> dict:
    return {k: hashlib.sha256(t.contiguous().cpu().numpy().tobytes())
            .hexdigest() for k, t in _leaves(tree).items()}


def fingerprint(checkout: str) -> dict:
    """The SHA-256 of every leaf of the runs named in the module
    docstring, by the port in ``checkout``."""
    sys.path.insert(0, checkout)
    import numpy as np
    import torch
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import frontend_cuda
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.pipeline import wideband as wb
    from dy4tpu_torch.runtime import kernels
    from dy4tpu_torch.tx import fm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_all()
    dev = torch.device("cuda", 0)
    out = {}
    for mode in (0, 1, 2, 3):
        cfg = get_mode(mode)
        flat = fm.stereo_rds_broadcast(cfg, N_BLOCKS + 1).ravel()
        n = N_BLOCKS * cfg.block_size
        rows = np.stack([flat[SHIFT * c:SHIFT * c + n] for c in range(C)])
        odd = rows[1::2].reshape(C // 2, -1, 2)[..., ::-1]
        rows[1::2] = odd.reshape(C // 2, -1)
        blocks = torch.from_numpy(rows.reshape(C, N_BLOCKS, -1)).permute(
            1, 0, 2).contiguous().to(dev)
        params = rx.make_params(cfg, device=dev)

        def init(**kw):
            return rx.init_state(cfg, (C,), device=dev, **kw)

        runs = {f"mode{mode}": lambda: rx.run_blocks(params, init(), blocks,
                                                      cfg)}
        if mode == 0:
            runs.update({
                "mode0 tracker": lambda: rx.run_blocks(
                    params, init(with_iqcorr=True), blocks, cfg),
                "mode0 fused-rf": lambda: rx.run_blocks(
                    params, init(), blocks, cfg, frontend="fused-rf"),
                "mode0 fused-phase": lambda: rx.run_blocks(
                    params, init(), blocks, cfg, frontend="fused-phase")})

            def if_entry():
                st, outs = init(), []
                tail = torch.zeros(C, 2, cfg.num_taps - 1, device=dev)
                for blk in blocks:
                    i, q, tail = frontend_cuda.rf_lpf_plain(
                        blk, params.rf_coeff, tail, cfg.rf_decim)
                    st, o = rx.receiver_step_if(params, st, i, q, cfg)
                    outs.append(o)
                return st, outs
            runs["mode0 IF entry"] = if_entry

            def wideband():
                chan = wb.make_wideband(cfg, 16, device=dev)
                g = torch.Generator(device=dev)
                g.manual_seed(0)
                x = torch.randint(0, 256, (4, 4, 2 * 16 * cfg.if_per_block),
                                  generator=g, device=dev,
                                  dtype=torch.uint8)
                return wb.run_wideband_blocks(
                    params, chan, wb.wideband_init(cfg, chan, (4,)), x, cfg)
            runs["mode0 wideband"] = wideband
        for label, run in runs.items():
            for k, v in _digest(run()).items():
                out[f"{label}:{k}"] = v
        torch.cuda.synchronize()
    return out


def main() -> int:
    if sys.argv[1] == "--one":
        print(json.dumps(fingerprint(sys.argv[2])))
        return 0
    prints = {}
    for checkout in sys.argv[1:]:
        done = subprocess.run([sys.executable, __file__, "--one", checkout],
                              capture_output=True, text=True)
        if done.returncode:
            print(done.stderr[-4000:])
            return done.returncode
        prints[checkout] = json.loads(done.stdout.splitlines()[-1])
        print(f"{checkout}: {len(prints[checkout])} leaves fingerprinted")
    first, *rest = prints.values()
    bad = 0
    for name, other in zip(sys.argv[2:], rest):
        diff = sorted(k for k in first.keys() | other.keys()
                      if first.get(k) != other.get(k))
        bad += len(diff)
        print(f"{sys.argv[1]} against {name}: " + (
            "every leaf bitwise equal" if not diff else
            f"{len(diff)} leaves differ: {diff[:20]}"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""B3, B4 and B5 alone: the device time of the polyphase resampler's
kernels, ``dy4tpu_torch.ops.backend_cuda.fused_audio_backend`` (B3, modes 0
and 1), ``resample_cuda.fused_rds_backend`` (B4, modes 0 and 2) and
``resample_cuda.fused_audio_backend_rational`` (B5, modes 2 and 3), on the
card, at each mode's block at C=512, at ``precision="default"`` and
``"highest"``.

Run from the root of a checkout on a machine with a CUDA device::

    python3 rational_alone.py

It imports the ``dy4tpu_torch`` beside it, so a copy of this file in
another checkout times that checkout's kernels (any version with the
wrappers' ``precision=`` keyword).  Each case: float32 rows and tails from
a seed (the kernels' work does not depend on the values), 20 calls under
``torch.profiler``, the mean device time of the kernel, back to back
(``warm``) and each call after a read of twice the L2 cache (``cold``, the
read's own time left out); up to three sessions where one records none.
Each case is also held once to its plain version on the same inputs: the
largest difference, and for B4 the share of its baseband past 1e-5 (bf16
flips of its resampled stream at "default").  Prints the card's name and
power limit, one line a case, then the numbers as one JSON line.
"""

import json
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

C, CALLS = 512, 20


def text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _device_ms(fn, kernel: str) -> float | None:
    """Mean device milliseconds of ``kernel`` over CALLS calls of ``fn``;
    None where the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages() if kernel in e.key
            and getattr(e, "device_time_total", 0.0) > 0]
    count = sum(e.count for e in mine)
    if not count:
        return None
    return sum(e.device_time_total for e in mine) / count / 1e3


def _measured(fn, kernel: str) -> float | None:
    for _ in range(3):
        ms = _device_ms(fn, kernel)
        if ms is not None:
            return ms
    return None


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("rational_alone: no CUDA device")
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import backend_cuda
    from dy4tpu_torch.ops import resample_cuda as rc
    from dy4tpu_torch.pipeline import receiver as rx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(0)
    flush = torch.empty(2 * getattr(props, "L2_cache_size", 50 * 2 ** 20),
                        dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    out = []
    for mode in (0, 1, 2, 3):
        cfg = get_mode(mode)
        p = rx.make_params(cfg, device=dev)
        n = cfg.if_per_block
        rnd = lambda *s: torch.randn(  # noqa: E731
            *s, generator=gen, device=dev)
        s_a = (cfg.audio_taps - 1) // cfg.audio_up
        aargs = (rnd(C, n), rnd(C, n), rnd(C, n), p.audio_coeff,
                 rnd(C, s_a), rnd(C, s_a))
        if cfg.audio_up == 1:
            cases = [("B3", "audio_rational", lambda pr: (
                backend_cuda.fused_audio_backend, aargs + (cfg.audio_down,),
                pr), lambda pr: backend_cuda.fused_audio_backend_plain(
                    *aargs, cfg.audio_down, pr))]
        else:
            rate = (cfg.audio_up, cfg.audio_down)
            cases = [("B5", "audio_rational", lambda pr: (
                rc.fused_audio_backend_rational, aargs + rate, pr),
                lambda pr: rc.fused_audio_backend_rational_plain(
                    *aargs, *rate, pr))]
        if cfg.supports_rds:
            s_r = (cfg.rds_taps - 1) // cfg.rds_up
            s2 = cfg.rds_rrc_taps - 1
            rargs = (rnd(C, n), rnd(C, n), rnd(C, n), p.rds_lpf_coeff,
                     p.rds_rrc_coeff, rnd(C, s_r), rnd(C, s_r), rnd(C, s2),
                     rnd(C, s2), cfg.rds_up, cfg.rds_down)
            cases.append(("B4", "rds_backend", lambda pr: (
                rc.fused_rds_backend, rargs, pr),
                lambda pr: rc.fused_rds_backend_plain(*rargs, pr)))
        for name, kernel, call, plain in cases:
            for pr in ("default", "highest"):
                wrap, args, _ = call(pr)

                def once(wrap=wrap, args=args, pr=pr):
                    return wrap(*args, precision=pr)

                def cold(once=once):
                    flush.sum()
                    once()
                got, want = once(), plain(pr)
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                share = (max(float(((a - b).abs() > 1e-5).double().mean())
                             for a, b in zip(got[:2], want[:2]))
                         if name == "B4" else None)
                del got, want
                warm_ms = _measured(once, kernel)
                cold_ms = _measured(cold, kernel)
                print(f"{name} alone, mode {mode} [{C}, {n}] {pr}: warm "
                      f"{text(warm_ms)} ms, cold L2 {text(cold_ms)} ms; "
                      f"max |kernel - plain| {err:.3g}"
                      + (f", {share:.4%} of the baseband past 1e-5"
                         if share is not None else "") + f" ({smi})",
                      flush=True)
                out.append(dict(kernel=name, mode=mode, precision=pr,
                                warm_ms=warm_ms, cold_ms=cold_ms,
                                max_err=err, share_past_1e5=share))
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "rational_alone": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

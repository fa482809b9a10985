"""B1, B1-corr and B6 alone: the device time of the fused front end's
kernels, ``dy4tpu_torch.ops.frontend_cuda.fused_frontend_full`` (with and
without ``corr=``) and ``fused_frontend_if``, on the card, at each mode's
block at C=512, at ``precision="default"`` and ``"highest"``.

Run from the root of a checkout on a machine with a CUDA device::

    python3 b1_b6_alone.py

It imports the ``dy4tpu_torch`` beside it, so a copy of this file in
another checkout times that checkout's kernels (any version with the
wrappers' ``precision=`` keyword).  Each case: u8 rows and float32 state
from a seed (the kernels' work does not depend on the values), 20 calls
under ``torch.profiler``, the mean device time of the kernel, back to back
(``warm``) and each call after a read of twice the L2 cache (``cold``, the
read's own time left out); up to three sessions where one records none.
B1-corr and B6 at modes 0 and 1 (the tracker's and the IF entry's modes).
Prints the card's name and power limit, one line a case, then the numbers
as one JSON line.
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
        raise SystemExit("b1_b6_alone: no CUDA device")
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import frontend_cuda as fc
    from dy4tpu_torch.pipeline import receiver as rx
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
    gen.manual_seed(22)
    out = []
    for mode in (0, 1, 2, 3):
        cfg = get_mode(mode)
        rds = cfg.supports_rds
        p = rx.make_params(cfg, device=dev)
        k, kb, n = cfg.num_taps, cfg.num_taps, cfg.if_per_block
        rnd = lambda *s: 0.1 * torch.randn(  # noqa: E731
            *s, generator=gen, device=dev)
        blk = torch.randint(0, 256, (C, cfg.block_size), generator=gen,
                            device=dev, dtype=torch.uint8)
        state = (rnd(C, 2, k - 1), rnd(C), rnd(C), rnd(C, kb - 1),
                 rnd(C, kb // 2), rnd(C, kb - 1), rnd(C, kb // 2))
        fargs = (blk, p.rf_coeff, p.bank_coeff, p.rds_carrier_coeff, *state,
                 cfg.rf_decim)
        corr = torch.stack([rnd(C), rnd(C), rnd(C), 1.0 + rnd(C)], -1)
        i_if, q_if = rnd(C, n), rnd(C, n)
        iargs = (i_if, q_if, state[1], state[2], p.bank_coeff,
                 p.rds_carrier_coeff, *state[3:])
        cases = [("B1", "frontend_full_kernel",
                  lambda pr: fc.fused_frontend_full(*fargs, rds=rds,
                                                    precision=pr))]
        if mode in (0, 1):
            cases += [
                ("B1-corr", "frontend_full_kernel",
                 lambda pr: fc.fused_frontend_full(*fargs, rds=rds, corr=corr,
                                                   precision=pr)),
                ("B6", "frontend_if_kernel",
                 lambda pr: fc.fused_frontend_if(*iargs, rds=rds,
                                                 precision=pr))]
        for name, kernel, call in cases:
            for pr in ("default", "highest"):
                def cold(call=call, pr=pr):
                    flush.sum()
                    call(pr)
                warm_ms = _measured(lambda: call(pr), kernel)
                cold_ms = _measured(cold, kernel)
                print(f"{name} alone, mode {mode} [{C}, {n}] {pr}: warm "
                      f"{text(warm_ms)} ms, cold L2 {text(cold_ms)} ms "
                      f"({smi})", flush=True)
                out.append(dict(kernel=name, mode=mode, precision=pr,
                                warm_ms=warm_ms, cold_ms=cold_ms))
        del blk, fargs, iargs, i_if, q_if
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "b1_b6_alone": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

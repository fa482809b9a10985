"""B7 alone: the device time of the wideband channelizer's branch-FIR
kernel, ``dy4tpu_torch.ops.channelizer_cuda.channelize_branches``, on the
card, at the bank geometries ``chip_smoke.py``'s phase 2 runs beyond its
six ``WB_GEOMS`` (and at its bench point, for reference).

Run from the root of a checkout on a machine with a CUDA device::

    python3 b7_alone.py

It imports the ``dy4tpu_torch`` beside it, so a copy of this file in
another checkout times that checkout's kernel: an older version of the
port needs only ``channelize_branches(x_u8, p, tail_i, tail_q)`` and
``channelizer.make_channelizer``.  Each geometry: random u8 rows and tails
from a seed, 20 calls under ``torch.profiler``, the mean device time of
the channelizer's kernel (up to three sessions where one records none).
Prints the card's name and power limit, then one line a geometry.
"""

import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

# (bands, rows of w a band or 0 for a wideband step's, C, T): the bench
# point, the wideband tool's one band at C = 8 and C = 25, 37 ragged bands,
# T = 24, and C = 128 at T = 32
GEOMS = ((32, 0, 16, 12), (1, 0, 8, 12), (1, 0, 25, 12), (37, 1531, 16, 12),
         (32, 0, 16, 24), (1, 0, 128, 32))
CALLS = 20


def _device_ms(fn) -> float | None:
    """Mean device milliseconds of the channelizer kernel over CALLS
    calls of ``fn``; None where the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages() if "channelizer" in e.key
            and getattr(e, "device_time_total", 0.0) > 0]
    count = sum(e.count for e in mine)
    if not count:
        return None
    return sum(e.device_time_total for e in mine) / count / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("b7_alone: no CUDA device")
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import channelizer as chz
    from dy4tpu_torch.ops import channelizer_cuda as chc
    cfg = get_mode(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for bands, m, c, t in GEOMS:
        m = m or cfg.if_per_block
        p = chz.make_channelizer(c, cfg.if_fs, taps_per_branch=t,
                                 device=dev).p
        x = torch.randint(0, 256, (bands, 2 * c * m), generator=gen,
                          device=dev, dtype=torch.uint8)
        ti, tq = (torch.randn(bands, c * t - 1, generator=gen, device=dev)
                  for _ in range(2))
        ms = None
        for _ in range(3):
            ms = _device_ms(lambda: chc.channelize_branches(x, p, ti, tq))
            if ms is not None:
                break
        print(f"B7 alone, {bands} bands x {m} rows, C={c} T={t}: "
              + ("not measured" if ms is None else f"{ms:.4f} ms")
              + f" ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

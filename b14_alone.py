"""B14 alone: the device time of the decimating block FIR's kernel,
``dy4tpu_torch.ops.fir_cuda.block_fir_decim``, on the card, at the
geometries ``chip_smoke.py``'s phase 7 holds it to its plain version.

Run from the root of a checkout on a machine with a CUDA device::

    python3 b14_alone.py

It imports the ``dy4tpu_torch`` beside it, so a copy of this file in
another checkout times that checkout's kernel: an older version of the
port needs only ``fir_cuda.block_fir_decim(x, h, state, decim)``.  Each
geometry: unit-normal rows, taps and state from a seed, 20 calls under
``torch.profiler``, the mean device time of the FIR's kernel, back to back
(``warm``) and each call after a read of twice the L2 cache (``cold``, the
read's own time left out); up to three sessions where one records none.
Prints the card's name and power limit, one line a geometry, then the
numbers as one JSON line.
"""

import json
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

# (rows, N, K, D): mode 0's RF legs at C=512, 128 rows, the four of
# tests/test_fir_pallas.py (batch dims flattened), 37 ragged rows
GEOMS = ((1024, 76800, 101, 10), (128, 76800, 101, 10), (4, 76800, 101, 10),
         (3, 640, 101, 5), (1, 1280, 7, 2), (5, 256, 33, 4),
         (37, 15310, 101, 10))
CALLS = 20


def text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _device_ms(fn) -> float | None:
    """Mean device milliseconds of the FIR kernel over CALLS calls of
    ``fn``; None where the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages() if "fir_decim_kernel" in e.key
            and getattr(e, "device_time_total", 0.0) > 0]
    count = sum(e.count for e in mine)
    if not count:
        return None
    return sum(e.device_time_total for e in mine) / count / 1e3


def _measured(fn) -> float | None:
    for _ in range(3):
        ms = _device_ms(fn)
        if ms is not None:
            return ms
    return None


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("b14_alone: no CUDA device")
    from dy4tpu_torch.ops import fir_cuda
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
    gen.manual_seed(14)
    out = []
    for rows, n, k, d in GEOMS:
        x = torch.randn(rows, n, generator=gen, device=dev)
        h = torch.randn(k, generator=gen, device=dev)
        state = torch.randn(rows, k - 1, generator=gen, device=dev)

        def cold():
            flush.sum()
            fir_cuda.block_fir_decim(x, h, state, d)
        warm_ms = _measured(lambda: fir_cuda.block_fir_decim(x, h, state, d))
        cold_ms = _measured(cold)
        print(f"B14 alone, [{rows}, {n}] K={k} D={d}: warm "
              f"{text(warm_ms)} ms, cold L2 {text(cold_ms)} ms ({smi})",
              flush=True)
        out.append(dict(rows=rows, n=n, k=k, d=d, warm_ms=warm_ms,
                        cold_ms=cold_ms))
    print(json.dumps({"device": smi, "b14_alone": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

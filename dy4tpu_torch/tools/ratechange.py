"""IQ capture sample-rate converter of the port (equivalent of
model/fmRateChange.py), the counterpart of ``dy4tpu/tools/ratechange.py``
with the same arguments plus ``--device``.

Converts a u8 interleaved-IQ capture between the canonical RF rates so one
recording can exercise every mode (fmRateChange.py:14-67).  The resampling
runs through the port's own polyphase FIR (``ops/fir.py ::
block_fir_resample``, one ``conv1d``) instead of scipy.resample_poly.

    python -m dy4tpu_torch.tools.ratechange in.raw out.raw --to 1440 [--from 2400]

``--device`` defaults to ``cuda`` and fails when the machine has no CUDA
device; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

# canonical RF rates in kS/s (fmRateChange.py:14)
RATES_KSPS = [2400, 2880, 2304, 1920, 1440, 1152, 960]


def resample_iq(iq_u8: np.ndarray, fs_in: float, fs_out: float,
                taps_per_phase: int = 101, device="cuda") -> np.ndarray:
    """u8 interleaved IQ at fs_in -> u8 interleaved IQ at fs_out, the
    filter run on ``device`` (the card unless the caller asks for the
    CPU)."""
    import torch

    from dy4tpu_torch.ops import fir, firdes
    from dy4tpu_torch.utils import io as dio

    t, s = int(round(fs_out)), int(round(fs_in))
    g = math.gcd(t, s)
    up, down = t // g, s // g

    x = dio.u8_to_float(iq_u8)
    i, q = x[0::2], x[1::2]
    # trim so the polyphase output length is integral
    n = (len(i) // down) * down
    i, q = i[:n], q[:n]

    taps = taps_per_phase * up
    fc = 0.45 * min(fs_in, fs_out)
    h = firdes.lpf(fs_in * up, fc, taps, up_factor=up)
    st = fir.init_state(taps, up, batch=(2,), device=device)
    y, _ = fir.block_fir_resample(
        torch.from_numpy(np.stack([i, q]).astype(np.float32)).to(device),
        torch.as_tensor(h, dtype=torch.float32, device=device), st,
        up=up, down=down)
    y = y.cpu().numpy()
    out = np.empty(2 * y.shape[-1], np.float32)
    out[0::2], out[1::2] = y[0], y[1]
    return dio.float_to_u8(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="convert a u8 IQ capture between canonical RF rates")
    p.add_argument("infile")
    p.add_argument("outfile")
    p.add_argument("--to", type=int, required=True, metavar="KSPS",
                   choices=RATES_KSPS, help="target rate in kS/s")
    p.add_argument("--from", dest="src", type=int, default=2400,
                   metavar="KSPS", choices=RATES_KSPS,
                   help="source rate in kS/s (default 2400)")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    from dy4tpu_torch.runtime import kernels

    dev = kernels.cli_device(args.device)
    iq = np.fromfile(args.infile, np.uint8)
    out = resample_iq(iq, args.src * 1e3, args.to * 1e3, device=dev)
    out.tofile(args.outfile)
    print(f"{args.infile} ({args.src} kS/s, {len(iq)//2} IQ) -> "
          f"{args.outfile} ({args.to} kS/s, {len(out)//2} IQ)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

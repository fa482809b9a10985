"""The readings that the check's limits are set from: for one cell, on
many seeds in one process, the numbers ``check.py`` compares, read from
the program at the configuration's precision (the lower readings) and
from the control (the program at ``precision="default"``, bf16 operands:
the upper readings), each after a short window at the cell's own size.

    python3 rxbench/readings.py --workload m0-c64-k8 --seeds 1-12 \\
        --seconds 4 [--precisions highest,default] [--out FILE]

Each reading is one ``run.run_cell`` (set-up, window, check) at that
precision.  Prints one JSON line a (seed, precision): the numbers, the
verdict under the cell's limits and the chunks the window ran; appends
the same lines to ``--out``.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 1-12 or 5,9,40")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--precisions", default="highest,default")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from dy4tpu_torch.pipeline import graph
    from rxbench import spec
    from rxbench.run import run_cell

    _, wl, cfg = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for seed in _seeds(args.seeds):
        for prec in args.precisions.split(","):
            t0 = time.perf_counter()
            res = run_cell(args.workload, wl, cfg, seed, args.seconds, False,
                           dev, precision=prec, t_start=t0)
            line = {"workload": args.workload, "seed": seed,
                    "precision": prec, **res["numbers"],
                    "correct": res["correct"], "chunks": res["chunks"],
                    "seconds": time.perf_counter() - t0}
            graph.clear()
            torch.cuda.empty_cache()
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

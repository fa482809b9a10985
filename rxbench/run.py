"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 rxbench/run.py --workload m0-c2048-k8 --seed 12345 \\
        --seconds 20 --trace 0

Set-up (timed as ``setup_s``): the card, the cell's files, the traffic
from the seed onto the card, the program's params and state, the chunk
graph captured and a short closed loop run.  Then the measured window
(``harness.py``), with ``--trace 1`` a few more chunks under the
profiler (``trace.py``), the check against the plain reference
(``check.py``) and, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, each read
by ``metrics/<name>.py``), ``device`` and, traced, ``breakdown``; last
``checks``, every number compared with its limit, which also close
standard error.

Without a CUDA card (or with fewer than the cell asks for) it exits 2 and
prints no result; so it does, with 3, when ``jax``, ``jaxlib``, ``flax``
or ``dy4tpu`` (top-level module names, compared whole) is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dy4tpu"})


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell: str, wl: dict, cfg: dict, seed: int, seconds: float,
             trace: bool, device, *, precision=None, run_blocks=None,
             t_start: float = None) -> dict:
    """One run of ``cell`` on ``device``: the result's keys, with
    ``numbers`` (every number the check reads, compared or not) and
    ``checks`` last.  ``run_blocks`` and ``precision`` as
    ``harness.Bench`` takes them (a test's broken entry; the control's
    precision); on the CPU nothing is traced and no memory is read."""
    import torch

    from rxbench import check, measure, spec
    from rxbench import trace as tracing
    from rxbench.harness import Bench

    t_start = T_START if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    bench = Bench(wl, cfg, seed, dev, precision=precision,
                  run_blocks=run_blocks)
    if on_card:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    parts = bench.setup_parts
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f", before the bench {setup_s - sum(parts.values()):.3f}",
          file=sys.stderr)
    window = bench.window(seconds)
    traced = None
    peak = 0
    if on_card:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        if trace:
            traced = tracing.run(bench, window.chunks[-1].index + 1,
                                 int(wl["trace_chunks"]))
        peak_all = max(setup_peak, torch.cuda.max_memory_allocated(dev))
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    run = measure.Run(bench, window, setup_s, peak, name, traced)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(cell, kind):
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if traced is not None:
        print("traced device ms a block: " + ", ".join(
            f"{k} {v:.4f}" for k, v in run.split_ms().items()),
            file=sys.stderr)
        waits, span = run.stream_idle()
        print(f"idle: traced {100 * (1 - traced.busy_s / traced.window_s):.4f}"
              f"%, the window's stream between calls {100 * waits / span:.4f}"
              f"% ({len(window.counted())} calls)", file=sys.stderr)
    t_check = time.perf_counter()
    got = check.compare(bench, window)
    print(f"check s: {time.perf_counter() - t_check:.3f}", file=sys.stderr)
    del bench, run
    ok, table = check.verdict(got, wl["limits"])
    result = {"correct": ok, "attempted": len(window.chunks), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": name, "count": 1,
                         "memory_peak_bytes": peak_all if on_card else 0}}
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s,
                                window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    result["chunks"] = len(window.counted())
    result["numbers"] = got
    result["checks"] = table
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from rxbench import spec

    entry, wl, cfg = spec.cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(entry["chips"])):
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); torch "
              f"finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(args.workload, wl, cfg, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0))
    card = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 3
    result["power_limit"] = card
    result["checks"] = result.pop("checks")
    print(f"{args.workload} seed {args.seed}: {card}; "
          f"{result['chunks']} chunks in the window; setup and metrics "
          f"{json.dumps(result['metrics'])}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What a run reads besides the program: ``BENCHMARK.json`` at the root
of the checkout, and under ``rxbench/`` one file for each configuration
(``configs/<name>.json``), traffic mix (``workloads/<cell>.json``),
metric (``metrics/<name>.py``) and kernel roofline
(``rooflines/<name>.py``), each found by the name ``BENCHMARK.json`` or
a workload gives it.  Nothing here names a cell, a configuration or a
metric: a new one is a new file."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return _json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def peaks() -> dict:
    return _json(HERE / "peaks.json")


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"rxbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader module of metric ``name`` (``metrics/<name>.py``): its
    ``read(run)`` returns the value, or None where the run has nothing
    to read."""
    return _module(HERE / "metrics" / f"{name}.py")


def rooflines() -> dict:
    """Every roofline module by name (``rooflines/<name>.py``): its
    ``KERNELS`` (the ``__global__`` names its profiler events carry) and
    ``work(cfg, geo, stations)`` (bytes and float operations a launch)."""
    return {p.stem: _module(p)
            for p in sorted((HERE / "rooflines").glob("*.py"))
            if not p.stem.startswith("_")}


def cell(name: str) -> tuple[dict, dict, dict]:
    """``(the cell's BENCHMARK.json entry, its workload file, its
    configuration file)``; raises ``KeyError`` for a cell the benchmark
    does not list."""
    bench = benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    wl = workload(name)
    if wl["config"] != entry["config"]:
        raise ValueError(f"{name}: the workload file's config "
                         f"{wl['config']!r} is not BENCHMARK.json's "
                         f"{entry['config']!r}")
    return entry, wl, config(entry["config"])


def metrics_of(cell_name: str, kind: str) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics the cell
    reports: those that list it under ``workloads`` or have no such key,
    and of the per-layer ones only those whose ``moves`` it reports."""
    bench = benchmark()

    def listed(m):
        return cell_name in m.get("workloads", [cell_name])
    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench[kind] if listed(m) and m["moves"] in moved]

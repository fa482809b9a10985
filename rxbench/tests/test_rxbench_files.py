"""BENCHMARK.json against the contract it is written to and against the
files it names; the modules' imports; the generator's determinism; the
roofline arithmetic against the kernel table's bounds."""

import ast
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parents[1]          # rxbench/
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from rxbench import check, spec  # noqa: E402
from rxbench.gen import traffic  # noqa: E402
from rxbench.ref.receiver import Geometry  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "dy4tpu"}


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rxbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e


def test_files_named_exist_and_parse():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        Geometry.of(cfg)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        wl = spec.workload(w["name"])
        assert wl["config"] == w["config"] in configs
        assert w["traffic"] == w["name"] and w["chips"] in (1, 4)
        cfg = spec.config(w["config"])
        assert set(wl["limits"]) == check.compared(cfg), w["name"]
        assert all(isinstance(v, float) for v in wl["limits"].values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
    for name, mod in spec.rooflines().items():
        assert mod.KERNELS and callable(mod.work)
        assert any(m["name"] == f"roofline_pct.{name}"
                   for m in BENCH["per_layer"])


def test_compared_numbers_follow_the_configuration():
    cfg = spec.config("fm-mode0")
    assert check.compared(cfg) == {"mono_err", "stereo_off", "rds_off"}
    assert check.compared(dict(cfg, rds=False)) == {"mono_err", "stereo_off"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name for a in node.names}
        elif (isinstance(node, ast.ImportFrom) and node.module
              and not node.level):
            found.add(node.module)
    return found


def test_nothing_imports_jax_or_dy4tpu():
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_and_generator_import_nothing_of_the_port():
    plain = [HERE / "firdes.py", *(HERE / "ref").rglob("*.py"),
             *(HERE / "gen").rglob("*.py")]
    for path in plain:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "math", "dataclasses", "numpy",
                        "scipy", "torch", "rxbench"}, (path, tops)
        assert "dy4tpu_torch" not in tops


def test_run_refuses_jax_by_whole_top_level_name(monkeypatch):
    from rxbench import run
    monkeypatch.setitem(sys.modules, "dy4tpu_torch_like", object())
    monkeypatch.delitem(sys.modules, "dy4tpu", raising=False)
    assert "dy4tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dy4tpu.ops", object())
    assert run.forbidden_modules() == ["dy4tpu"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_generator_same_bytes_for_same_seed(cell):
    _, wl, cfg = spec.cell(cell)
    wl = dict(wl, ring_blocks=2, programs=2, stations=6)
    geo = Geometry.of(cfg)
    big = 2**31 + 12345
    a, b, c = (traffic.draw(wl, geo, s) for s in (big, big, big + 1))
    assert a.programs == b.programs and np.array_equal(a.offsets, b.offsets)
    assert a.programs != c.programs
    la = traffic.synthesize(a, wl, cfg, geo)
    assert np.array_equal(la, traffic.synthesize(b, wl, cfg, geo))
    assert la.shape == (2, 2 * 2 * geo.iq) and la.dtype == np.uint8
    assert (a.offsets % 2 == 0).all() and a.swapped.tolist() == [
        False, True] * 3


def test_ring_rows_are_the_programs_loops():
    import torch
    _, wl, cfg = spec.cell("m0-c64-k8")
    geo = Geometry.of(cfg)
    wl = dict(wl, ring_blocks=3, chunk=2, stations=4, programs=2)
    t = traffic.draw(wl, geo, 9)
    loops = np.random.default_rng(0).integers(0, 256, (2, 3 * 2 * geo.iq),
                                              dtype=np.uint8)
    ring = traffic.ring(loops, t, wl, geo, torch.device("cpu")).numpy()
    bs = 2 * geo.iq
    assert ring.shape == (4, 4, bs)
    for r in range(4):
        loop = loops[r % 2]
        if t.swapped[r]:
            loop = loop.reshape(-1, 2)[:, ::-1].reshape(-1)
        want = np.roll(loop, -int(t.offsets[r]))
        want = np.concatenate([want, want[:bs]])
        assert np.array_equal(ring[:, r].reshape(-1), want)


# bounds in ms at C=512 from the kernel table (PERF.md, section 6)
BOUNDS = [("fm-mode0", "b1_frontend", 0.0476, 0.0717),
          ("fm-mode2", "b1_frontend", 0.0593, 0.0896),
          ("fm-mode0", "b2_pll", 0.0188, None),
          ("fm-mode0", "audio_backend", 0.0171, None),
          ("fm-mode2", "audio_backend", 0.0211, None),
          ("fm-mode0", "b4_rds", 0.0161, None),
          ("fm-mode2", "b4_rds", 0.0213, None)]


@pytest.mark.parametrize("config,roofline,bytes_ms,ops_ms", BOUNDS)
def test_roofline_arithmetic(config, roofline, bytes_ms, ops_ms):
    cfg = spec.config(config)
    peaks = spec.peaks()["H100"]
    nbytes, flops = spec.rooflines()[roofline].work(cfg, Geometry.of(cfg),
                                                    512, "highest")
    assert round(nbytes / peaks["hbm_bytes_per_s"] * 1e3, 4) == bytes_ms
    if ops_ms is not None:
        assert round(flops / peaks["fp32_flop_per_s"] * 1e3, 4) == ops_ms


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in spec.metrics_of(w["name"], "end_to_end")}
        per_layer = spec.metrics_of(w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert per_layer and all(m["moves"] in e2e for m in per_layer)

"""On the card: the cell's control, the program at precision "default"
(bf16 operands), comes out not correct on three seeds, and the program
at the configuration's precision comes out correct, each after a short
window at the cell's own size (``python -m pytest rxbench/tests -m
cuda`` on a machine with a card; the full readings the limits were set
from are ``rxbench/readings.py``'s)."""

import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rxbench import spec  # noqa: E402
from rxbench.run import run_cell  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, card):
    _, wl, cfg = spec.cell(cell)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        for precision, want in (("default", False), (None, True)):
            res = run_cell(cell, wl, cfg, seed, 2.0, False, card,
                           precision=precision, t_start=time.perf_counter())
            assert res["correct"] is want, (seed, precision, res["checks"])

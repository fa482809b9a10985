"""A run with the timed path broken underneath must come out not
correct: the whole run of a cell (set-up, window, check) on the CPU at a
tiny size, the harness's look for a card skipped, with the program's
``run_blocks`` wrapped to plant one fault, under the cell's own limits;
and the same run unbroken comes out correct.

The faults a stream receiver's step can have: a call that returns the
state it was given (every chunk restarts the stream), half of the
stations left out (their outputs never written), and an answer altered
where it is produced (one audio sample of every block).  Besides, one
that only a check which works out the state itself can see: the RDS
carrier loop slipped by half a turn once, between the first and the
later spans, after which every hand-over is consistent with the slipped
state (the RDS symbols come out inverted)."""

import math

import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rxbench import check, harness, spec  # noqa: E402
from rxbench.run import run_cell  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _broken(fault):
    from dy4tpu_torch.pipeline import graph

    calls = []

    def run_blocks(params, state, blocks, cfg, **kw):
        new, outs = graph.run_blocks(params, state, blocks, cfg, **kw)
        calls.append(None)
        # the call of the window's chunk SPAN, after the warm-up's chunks
        slip_at = 1 + harness.WARM_CHUNKS + harness.SPAN + 1
        if (fault == "carrier loop slipped between spans"
                and len(calls) == slip_at):
            new.rds.pll.phase_est.add_(2 * math.pi)
        if fault == "state returned unchanged":
            return state, outs
        if fault == "half the stations left out":
            c = blocks.shape[1]
            for t in outs:
                if t is not None:
                    t[:, c // 2:] = 0
        if fault == "an answer altered":
            outs.left[:, :, 100] += 0.05
        return new, outs
    return run_blocks


def _run(cell, fault, monkeypatch):
    monkeypatch.setattr(harness, "WARM_CHUNKS", 1)
    _, wl, cfg = spec.cell(cell)
    wl = dict(wl, stations=8, chunk=1, ring_blocks=4, programs=2)
    t0 = time.perf_counter()
    return run_cell(cell, wl, cfg, 2**31 + 99, 20.0, False, "cpu",
                    run_blocks=None if fault is None else _broken(fault),
                    t_start=t0)


@pytest.mark.parametrize("fault", ["state returned unchanged",
                                   "half the stations left out",
                                   "an answer altered",
                                   "carrier loop slipped between spans"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    res = _run(cell, fault, monkeypatch)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, monkeypatch):
    res = _run(cell, None, monkeypatch)
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    cfg = spec.cell(cell)[2]
    assert set(res["checks"]) == check.compared(cfg) <= set(res["numbers"])

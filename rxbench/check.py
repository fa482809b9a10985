"""The comparison that decides ``correct``: the landed outputs of the
window's checked spans against the plain reference (``ref/receiver.py``)
run over the same rows and blocks.

A span is two chunks, one call boundary.  The reference never takes the
program's state: it works out the station's state at any block of the
window from the initial state, because every row plays a loop of
``ring_blocks`` blocks over and over.  The PLLs lock and the filters fill
within three blocks, so from the loop's second pass on everything but
the CDR repeats itself (a float64 run: to 1e-15).  The CDR feeds nothing
back; it keeps a sampling phase until it loses lock, and a poor phase
may be lost, and a poor one taken again, a pass or two later.  So the
reference runs the whole chain over the loop's first two passes, then
the CDR alone over the second pass's input, pass after pass, until its
carry at the start of a pass repeats the one a pass before: from there
on every pass is that one (``cdr_passes`` counts the passes to it).  A
block of the window takes the first pass's outputs in the first pass
and the second pass's from then on, with the CDR's of its own pass, or
of the settled one.  What the program carried over the hundreds of
chunks between the spans is judged by what it gives.

Three numbers, gaps taken as a share of the largest reference value of
their output over the check:

- ``mono_err``: the widest gap of the mono audio (the front end and the
  audio back end; no PLL);
- ``stereo_off``: the share of checked (station, block) units whose widest
  left or right gap exceeds ``UNIT_GAP``: the pilot PLL and the stereo
  mix too;
- ``rds_off`` (with RDS): the share of units whose widest soft RDS symbol
  gap exceeds ``UNIT_GAP``, or where a hard symbol differs from a
  reference symbol larger than that, or the CDR's offset or resync flag
  differs: the carrier PLL, the RDS back end and the CDR.

The loops are shares, not widest gaps, because a loop reads only the
sign of its input: where a sample lies within rounding of zero the
program's float32 and the reference's float64 can take opposite signs,
and one such sample moves the NCO by kp * pi (0.084 rad on the pilot,
0.0042 on the RDS carrier) for some hundred samples: in sound runs a
unit or two of a check, with bf16 operands (the control) nearly all.

``stereo_err`` and ``rds_err``, the widest gaps, are reported beside
them and not compared.  Each compared number has its limit in the
workload file (``limits``); NaN fails.
"""

from __future__ import annotations

import numpy as np

from rxbench.harness import SPAN
from rxbench.ref.receiver import Receiver

UNIT_GAP = 1e-4


def compared(cfg: dict) -> set:
    """The numbers ``compare`` gives for configuration ``cfg`` that a
    workload's ``limits`` hold."""
    return {"mono_err", "stereo_off"} | ({"rds_off"} if cfg["rds"] else set())


CDR_KEYS = ("rds.cdr.offset", "rds.cdr.found")
MAX_PASSES = 32


def reference(bench, ref: Receiver):
    """The reference's outputs at any block of the window, from the
    initial state: ``(outputs_at(block) -> dict, the pass from which the
    CDR repeats itself)``."""
    n = bench.ring_blocks
    loop = bench.loop_inputs(2 * n)
    state = ref.init_state(len(bench.rows))
    outs, starts = [], []
    for t in range(2 * n):
        if t == n:
            starts.append({k: state.get(k) for k in CDR_KEYS})
        state, out = ref.step(state, loop[t])
        outs.append(out)
    passes = [outs[:n], outs[n:]]
    carry = {k: state.get(k) for k in CDR_KEYS}
    while ref.geo.rds and not _same(carry, starts[-1]):
        if len(passes) == MAX_PASSES:
            raise RuntimeError(f"the reference's CDR did not settle in "
                               f"{MAX_PASSES} passes of the loop")
        starts.append(carry)
        run = []
        for out in outs[n:]:
            new = {}
            run.append({**out, **ref.cdr(out["bb_i"], carry, new)})
            carry = new
        passes.append(run)

    def at(block: int) -> dict:
        return passes[min(block // n, len(passes) - 1)][block % n]
    return at, len(passes) - 1


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


def compare(bench, window) -> dict:
    """Judge the window's checked spans by the reference run from the
    initial state; returns ``{number: value}``."""
    ref = Receiver(bench.cfg)
    firsts = window.spans
    if not firsts:
        raise RuntimeError("the window kept no span to check")
    n = SPAN * bench.k
    at, cdr_passes = reference(bench, ref)

    def prog(field):
        """The program's ``field`` [S * n, R, ...]: the spans' blocks."""
        return np.concatenate([window.kept[f + j][field]
                               for f in firsts for j in range(SPAN)])

    def want(field):
        """The reference's ``field`` at the same blocks."""
        return np.stack([at(f * bench.k + t)[field]
                         for f in firsts for t in range(n)])

    def widest(fields):
        gap = max(float(np.max(np.abs(prog(p) - want(w))))
                  for p, w in fields)
        scale = max(float(np.max(np.abs(want(w)))) for _, w in fields)
        return gap / scale

    got = {"mono_err": widest([("mono", "mono")]),
           "stereo_err": widest([("left", "left"), ("right", "right")])}
    scale = max(float(np.max(np.abs(want(f)))) for f in ("left", "right"))
    unit = np.maximum(*(np.max(np.abs(prog(f) - want(f)), axis=-1)
                        for f in ("left", "right")))    # [blocks, rows]
    got["stereo_off"] = float(np.mean(~(unit <= UNIT_GAP * scale)))
    if ref.geo.rds:
        soft, ref_soft = prog("rds_sym_i"), want("sym_i")
        scale = float(np.max(np.abs(ref_soft)))
        gap = np.abs(soft - ref_soft)
        decided = np.abs(ref_soft) > UNIT_GAP * scale
        off = (~(np.max(gap, axis=-1) <= UNIT_GAP * scale)
               | np.any((prog("rds_symbols") != want("symbols")) & decided,
                        axis=-1)
               | (prog("rds_offset") != want("offset"))
               | (prog("rds_resync") != want("resync")))
        got["rds_err"] = float(np.max(gap)) / scale
        got["rds_off"] = float(np.mean(off))
        got["cdr_passes"] = cdr_passes
    return got


def verdict(got: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {number: {"value", "limit"}})`` for the numbers that
    ``limits`` names: every one at or under its limit (NaN fails)."""
    table = {k: {"value": got.get(k, float("nan")), "limit": v}
             for k, v in limits.items()}
    ok = bool(table) and all(t["limit"] is not None
                             and t["value"] <= t["limit"]
                             for t in table.values())
    return ok, table

"""The third traced pass, after ``trace.py``'s two: the card's work split
by the program's own spans, and the host's per-call work by span.

It traces ``trace_chunks`` chunks of the closed loop twice, with the
harness's spans (``rxbench.run_blocks``, ``rxbench.land``,
``rxbench.wait``) and the program's (``dy4tpu_torch/utils/profiling.py``:
``graph.*`` around ``run_blocks``' per-call steps, ``rx.*`` in the
receiver step) on.

* The host's span durations come from a profiler with the host's
  activity alone.  With the card's activity on too, CUPTI instruments
  every node of a graph's launch and the call runs about three times
  as long as untraced.  On the host alone the tracer costs a few
  microseconds an op.
* The device's split comes from a profiler with both activities.  Each
  device event (kernel, copy, memset) takes the innermost span around
  the host call that launched it.  A replay's events are all launched
  by one ``cudaGraphLaunch`` under ``graph.replay``.  They take
  instead, place for place, the span of the launch the graph's capture
  recorded (``ChunkRunner.span_map``, the chunk's body run eagerly with
  the spans on).  The names of both lists must agree one for one.  A
  kernel is a roofline file's where its name holds one of the file's
  ``KERNELS``, else glue (``measure.Run.glue_s``'s rule).

The device pass also holds each roofline file's traced launches against
the launch counters of the wrappers that launch its kernels
(``graph.counters()``, ``WRAPPERS``).  A mismatch, or a wrapper that
launched kernels no file maps, is printed on standard error.

It also prints the device pass's longest idle gaps, each named by the
innermost span (the harness's or the program's) that holds its start.
The breakdown's gaps stay ``trace.py``'s, named by the harness's spans
alone.

The readers call ``of(run)``: the pass runs at the first reader's call,
after ``run.py`` has read the run's memory peak and ``trace.py``'s two
passes, on the chunks after theirs, and is kept on the run.  It runs only
where the run was traced, the bench drives ``graph.run_blocks`` and the
program has spans (``ChunkRunner.span_map``).  Elsewhere ``of`` returns
None and the readers read nothing.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

from rxbench import spec
from rxbench import trace as tracing

try:
    from dy4tpu_torch.utils.profiling import SPAN_PREFIXES
except ImportError:         # a program without spans
    SPAN_PREFIXES = ()

PREFIXES = ("rxbench.",) + SPAN_PREFIXES   # the harness's and the program's
GAPS = 5                    # the idle gaps printed
# the wrappers (``graph.counters()`` by ``__name__``) whose launches run
# each roofline file's kernels
WRAPPERS = {"b1_frontend": ("fused_frontend_full",
                            "fused_frontend_full[corr]"),
            "b2_pll": ("phase_scan",),
            "audio_backend": ("fused_audio_backend",
                              "fused_audio_backend_rational"),
            "b4_rds": ("fused_rds_backend",)}


@dataclass
class Spans:
    blocks: int                  # blocks the traced chunks ran
    chunks: int
    device: dict                 # (kind, span, replayed) -> seconds
    host: dict                   # span -> host seconds over the chunks

    def device_ms(self, kind: str, labels=None, replayed=None) -> float:
        """Device milliseconds a block of the ``kind`` ("glue", "copy" or
        a roofline file's name) events under any of ``labels`` (all
        where None), inside a replay or outside it (either where None)."""
        s = sum(v for (k, label, r), v in self.device.items()
                if k == kind and (labels is None or label in labels)
                and (replayed is None or r == replayed))
        return 1e3 * s / self.blocks

    def host_ms(self, *names: str) -> float:
        """Host milliseconds a chunk of the spans ``names``."""
        return 1e3 * sum(self.host.get(n, 0.0) for n in names) / self.chunks


def kind_of(name: str, rooflines: dict) -> str:
    if tracing._is_copy(name):
        return "copy"
    return next((r for r, mod in rooflines.items()
                 if any(k in name for k in mod.KERNELS)), "glue")


def same(got: str, want: str) -> bool:
    """Whether a replay's device event is the eager run's: the same name,
    or both copies (or both memsets), which a graph may run as CUDA's own
    copy kernels (``memcpy32_post``, ``memcpy128``) where the eager run
    has ``Memcpy DtoD``."""
    return got == want or (tracing._is_copy(got) and tracing._is_copy(want)
                           and got[:6].lower() == want[:6].lower())


def label(events, span_map) -> list:
    """``(event, span, replayed)`` for ``profiling.device_spans``'
    ``(event, span, call)`` triples: a replay's events (one
    ``cudaGraphLaunch`` each) by their place in ``span_map``'s
    ``(name, span)`` list, which they must match one for one
    (``same``); every other event by its own span."""
    replays, out = {}, []
    for e, name, call in events:
        if call is not None and "GraphLaunch" in call:
            replays.setdefault(e.id, []).append(e)
        else:
            out.append((e, name, False))
    want = [n for n, _ in span_map]
    for launch, evs in replays.items():
        got = [e.name for e in evs]
        if len(got) != len(want) or not all(map(same, got, want)):
            at = next((i for i, (a, b) in enumerate(zip(got, want))
                       if not same(a, b)), min(len(got), len(want)))
            raise RuntimeError(
                f"replay {launch}: {len(got)} device events against the "
                f"capture's {len(want)}; they first differ at {at}: "
                f"{got[at] if at < len(got) else None!r} against "
                f"{want[at] if at < len(want) else None!r}")
        out += [(e, s, True) for e, (_, s) in zip(evs, span_map)]
    return out


def _profile(bench, start: int, chunks: int, profiling, device: bool):
    """The profiler's events of ``chunks`` chunks of the closed loop from
    chunk index ``start``, with every span on, the host's activity and,
    where ``device``, the card's, and the loop's ``Window``.  The
    profiler's first and last moments are kept clear of the chunks
    (``profiling.settle``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device
                                     else [])
    with profiling.spans(), profile(activities=acts) as prof:
        profiling.settle(bench.device)
        window = bench.loop(start, chunks=chunks, record=record_function)
        profiling.settle(bench.device)
    return prof.events(), window


def of(run):
    """The pass of ``run`` (a ``measure.Run``), made at the first call
    and kept on the run: a ``Spans``, or None where ``run`` has no trace
    or ``split`` returns None."""
    if "_spans" not in vars(run):
        got = None
        if getattr(run, "trace", None) is not None:
            n = run.trace.blocks // run.bench.k
            got = split(run.bench, run.window.chunks[-1].index + 1 + n
                        + tracing.LABEL_CHUNKS, n)
        run._spans = got
    return run._spans


def split(bench, start: int, chunks: int):
    """The third pass, the host's ``chunks`` chunks from chunk index
    ``start`` and the card's the next ``chunks``: a ``Spans``, or None
    where the bench or the program has no spans."""
    from torch.autograd import DeviceType

    from dy4tpu_torch.pipeline import graph
    from dy4tpu_torch.utils import profiling

    if (bench.run_blocks is not graph.run_blocks
            or not hasattr(graph.ChunkRunner, "span_map")):
        return None
    events, window = _profile(bench, start, chunks, profiling, device=False)
    host = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(PREFIXES):
            host[e.name] = (host.get(e.name, 0.0)
                            + (e.time_range.end - e.time_range.start) * 1e-6)
    call_s = sum(c.t_call - c.t_sent for c in window.chunks) / chunks

    runner = graph.cached_runner(bench.params, bench.state, bench.mcfg,
                                 "rf", dict(bench.step_kw))
    span_map = runner.span_map(bench.ring[:bench.k])
    wrappers = graph.counters()
    before = [w.launches for w in wrappers]
    events, _ = _profile(bench, start + chunks, chunks, profiling,
                         device=True)
    launched = {w.__name__: w.launches - n for w, n in zip(wrappers, before)}

    rooflines = spec.rooflines()
    device, traced = {}, {}
    launched_by = profiling.device_spans(events, PREFIXES)
    gaps = _named_gaps(events, launched_by)
    for e, name, replayed in label(launched_by, span_map):
        kind = kind_of(e.name, rooflines)
        key = (kind, name, replayed)
        device[key] = (device.get(key, 0.0)
                       + (e.time_range.end - e.time_range.start) * 1e-6)
        traced[kind] = traced.get(kind, 0) + 1
    out = Spans(blocks=chunks * bench.k, chunks=chunks, device=device,
                host=host)
    _report(out, rooflines, traced, launched, call_s)
    print("spans, longest idle gaps ms (innermost span at the start): "
          + ", ".join(f"{n} {1e3 * g:.4f}" for g, n in gaps[:GAPS]),
          file=sys.stderr)
    return out


def _named_gaps(events, launched_by) -> list:
    """The idle gaps between the device events of ``launched_by``
    (``profiling.device_spans``' triples): [(seconds, innermost span at
    the gap's start, or "host")], longest first."""
    from torch.autograd import DeviceType

    dev = [(e.time_range.start, e.time_range.end, e.name)
           for e, _, _ in launched_by]
    if not dev:
        return []
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name.startswith(PREFIXES)]
    named = []
    for g0, g1 in tracing._union(dev)[1]:
        held = [(s, -e, n) for s, e, n in host if s <= g0 < e]
        named.append(((g1 - g0) * 1e-6, max(held)[2] if held else "host"))
    return sorted(named, key=lambda x: -x[0])


def _report(s: Spans, rooflines: dict, traced: dict, launched: dict,
            call_s: float):
    """The pass's split on standard error: glue and copies by span (with
    what no span names), host ms a chunk by span beside the whole call
    under the same profiler, and the launch counters against the traced
    launches."""
    def split(kind):
        by = {}
        for (k, where, _), v in s.device.items():
            if k == kind:
                by[where] = by.get(where, 0.0) + v
        return {where: 1e3 * v / s.blocks for where, v in sorted(
            by.items(), key=lambda kv: -kv[1])}

    glue = split("glue")
    unnamed = sum(v for where, v in glue.items()
                  if where is None or not where.startswith(("rx.", "graph.")))
    print("spans, glue device ms a block: " + ", ".join(
        f"{k} {v:.4f}" for k, v in glue.items())
        + f"; total {sum(glue.values()):.4f}, unnamed {unnamed:.4f}",
        file=sys.stderr)
    print("spans, copies device ms a block: " + ", ".join(
        f"{k} {v:.4f}" for k, v in split("copy").items())
        + f"; inside replays {s.device_ms('copy', replayed=True):.4f}",
        file=sys.stderr)
    print("spans, host ms a chunk (host activity alone): " + ", ".join(
        f"{k} {1e3 * v / s.chunks:.4f}" for k, v in sorted(s.host.items()))
        + f"; the call {1e3 * call_s:.4f}", file=sys.stderr)
    checks = []
    for r in rooflines:
        names = WRAPPERS.get(r)
        if names is None:
            checks.append(f"{r}: no wrapper known: MISMATCH")
            continue
        counted = sum(launched.get(n, 0) for n in names)
        seen = traced.get(r, 0)
        checks.append(f"{r} {seen} traced / {counted} counted"
                      + ("" if seen == counted else ": MISMATCH"))
    mapped = {n for names in WRAPPERS.values() for n in names}
    extra = {n: c for n, c in launched.items() if c and n not in mapped}
    if extra:
        checks.append(f"wrappers no roofline file maps launched {extra}: "
                      f"MISMATCH")
    print("spans, launch counters: " + "; ".join(checks), file=sys.stderr)

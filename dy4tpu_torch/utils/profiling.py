"""Profiling of the port: the operator's Chrome trace and the program's
own spans, the counterpart of ``dy4tpu/utils/profiling.py``.

* ``trace(logdir)``: context manager around ``torch.profiler`` (host ops,
  and the card's kernels and copies where there is a card), with the
  spans on; writes a Chrome trace into ``logdir`` (TensorBoard's torch
  profiler plugin and ``chrome://tracing`` read it).
* ``span(name)``: a ``torch.profiler.record_function`` range named
  ``name`` while the spans are on, else one shared no-op context: off,
  a span costs one flag test.  ``spans()`` switches them on for its
  block.
* ``device_spans(events)``: each device event of a profiler's events
  with the innermost span around the host call that launched it;
  ``settle(device)`` keeps a profiler's first and last moments clear of
  the work it traces.

The spans name the code that makes the card's work: ``graph.*`` around
``run_blocks``' per-call steps in ``pipeline/graph.py`` (the runner's
lookup, the state's ``load`` and ``read``, the chunk's input copy, the
replay, the output copy; inside a chunk's body its ``stack`` and the
carry's ``assign``), ``rx.*`` around the receiver step's parts in
``pipeline/receiver.py`` and ``ops/pll.py`` (``front``, ``pll_lanes``,
``pll_scan``, ``nco``, ``pilot_snr``, ``back``, ``cdr``).  A replayed
graph runs no Python, so its kernels carry no span of their own:
``graph.ChunkRunner.span_map`` names them from the launches its
capture recorded.

Under a profiler with CUDA activity a span also shows on the device's
timeline, as an annotation over the kernels it launched: a reader of
device time drops those annotations (``is_span``).
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

SPAN_PREFIXES = ("graph.", "rx.")

_on = False
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while the spans are on; else the
    shared no-op context."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def spans():
    """Switch the spans on for the block (and back to what they were)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def is_span(name: str, prefixes=SPAN_PREFIXES) -> bool:
    return name.startswith(prefixes)


def settle(device) -> None:
    """Wait for the card, then 50 ms: called inside a profiler before
    and after the work it traces.  A profiler drops the card's work of
    its first and last moments (on the H100 under torch 2.11 the first
    1-2 ms of kernels), which would cut a traced replay short."""
    torch.cuda.synchronize(device)
    time.sleep(0.05)


def device_spans(events, prefixes=SPAN_PREFIXES) -> list[tuple]:
    """``(device event, innermost span, launching call)`` for each device
    event (kernel, copy, memset) of a profiler's ``events()``, by start.
    A device event is tied to the host runtime call that launched it
    (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cudaGraphLaunch``, ...)
    by their correlation id, and takes the name of the innermost span
    whose name has one of ``prefixes`` and that holds that call's start
    (None where no span does, or the call was not recorded).  The spans'
    own annotations on the device timeline (any name with one of
    ``prefixes``) are left out."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    launch = {e.id: e for e in cpu if e.name.startswith("cu")}
    ranges = sorted(((e.time_range.start, -e.time_range.end, e.name)
                     for e in cpu if is_span(e.name, prefixes)))
    starts = [s for s, _, _ in ranges]
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and not is_span(e.name, prefixes)),
                 key=lambda e: e.time_range.start)

    def innermost(t):
        # ranges nest: the latest-starting one that still holds t
        for s, neg_end, name in reversed(ranges[:bisect.bisect_right(
                starts, t)]):
            if t < -neg_end:
                return name
        return None

    named = {}                  # a replay's events share one call
    out = []
    for e in dev:
        call = launch.get(e.id)
        if call is None:
            out.append((e, None, None))
            continue
        if e.id not in named:
            named[e.id] = innermost(call.time_range.start)
        out.append((e, named[e.id], call.name))
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block with the spans on, its trace
    written into ``logdir`` as ``<host>_<pid>.<time>.pt.trace.json`` when
    the block ends, also when it raises.  Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    with spans():
        prof.start()
        try:
            yield prof
        finally:
            prof.stop()

"""The traced chunks, after the measured window, and their reduction to
what the per-layer readers and the result's ``device`` and ``breakdown``
take.

Two passes of the closed loop under ``torch.profiler``.  The first traces
the workload's ``trace_chunks`` chunks with CUDA activity alone: no host
op is recorded, so the host keeps the pace it has in the window, and the
card's idle share is the system's and not the tracer's.  Its window runs
from the first device event's start to the last one's end; ``busy_s`` is
the union of every device event's interval (kernels, copies, memsets, on
any stream); the kernels' times feed the rooflines and the glue.  The
second pass, of ``LABEL_CHUNKS`` chunks, adds the host's activity and the
harness's spans (``rxbench.run_blocks``, ``rxbench.land``,
``rxbench.wait``) only to name the idle gaps of the breakdown: each gap
by the span that holds its start, or "host" where none does.  Those gaps
carry the tracer's own host work, so no metric reads them.
"""

from __future__ import annotations

from dataclasses import dataclass

LABEL_CHUNKS = 4


@dataclass
class Trace:
    window_s: float
    busy_s: float
    blocks: int                  # blocks the traced chunks ran
    kernels: dict                # kernel name -> (seconds, launches)
    copies_s: float              # copies and memsets
    gaps: list                   # [(seconds, host span)] longest first

    def breakdown(self) -> dict:
        by = {}
        for name, (s, _) in self.kernels.items():
            short = _short(name)
            by[short] = by.get(short, 0.0) + s
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[name, s] for s, name in self.gaps[:10]]}


def _short(name: str) -> str:
    """A kernel's demangled name without its return type, anonymous
    namespaces and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    return name.split("(")[0][:160]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _profile(bench, start: int, chunks: int, host: bool):
    """The profiler's events of ``chunks`` chunks of ``bench``'s closed
    loop from chunk index ``start`` (the card idle before and after)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize(bench.device)
    with profile(activities=activities) as prof:
        bench.loop(start, chunks=chunks,
                   record=record_function if host
                   else lambda name: contextlib.nullcontext())
        torch.cuda.synchronize(bench.device)
    return prof.events()


def _intervals(events) -> list:
    """The device events' (start, end, name), in µs, by start.  The
    harness's own spans also show on the device's timeline (as
    annotations covering the kernels they launched): not device work."""
    from torch.autograd import DeviceType

    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("rxbench.")),
                 key=lambda x: x[0])
    if not dev:
        raise RuntimeError("the profiler recorded no device event")
    return dev


def _union(dev) -> tuple[float, list]:
    """Busy µs of the union of ``dev``'s intervals, and its gaps."""
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s, gaps


def _named_gaps(bench, start: int) -> list:
    """The idle gaps of ``LABEL_CHUNKS`` chunks traced with the host's
    activity: [(seconds, host span)], longest first."""
    from torch.autograd import DeviceType

    events = _profile(bench, start, LABEL_CHUNKS, host=True)
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CPU
                  and e.name.startswith("rxbench."))
    named = []
    for g0, g1 in _union(_intervals(events))[1]:
        label = next((n for s, e, n in host if s <= g0 < e), "host")
        named.append(((g1 - g0) * 1e-6, label))
    return sorted(named, key=lambda x: -x[0])


def run(bench, start: int, chunks: int) -> Trace:
    """Trace ``chunks`` chunks of ``bench``'s closed loop from chunk
    index ``start``, then name the idle gaps of a few more."""
    dev = _intervals(_profile(bench, start, chunks, host=False))
    kernels, copies = {}, 0.0
    for s, e, name in dev:
        if _is_copy(name):
            copies += e - s
        else:
            t, n = kernels.get(name, (0.0, 0))
            kernels[name] = (t + (e - s) * 1e-6, n + 1)
    busy, _ = _union(dev)
    return Trace(window_s=(max(e for _, e, _ in dev) - dev[0][0]) * 1e-6,
                 busy_s=busy * 1e-6, blocks=chunks * bench.k,
                 kernels=kernels, copies_s=copies * 1e-6,
                 gaps=_named_gaps(bench, start + chunks))

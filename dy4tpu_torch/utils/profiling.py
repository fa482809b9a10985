"""Profiling & observability, the counterpart of
``dy4tpu/utils/profiling.py``.

* ``trace(logdir)``: context manager around ``torch.profiler`` (host ops,
  and the card's kernels and copies where there is a card); writes a
  Chrome trace into ``logdir`` (TensorBoard's torch profiler plugin and
  ``chrome://tracing`` read it).
* ``StageTimer``: lightweight named wall-clock accumulator for host-side
  stage breakdowns (synchronizes the card before it reads the clock, so
  timings are honest under asynchronous launches).
* ``Throughput``: running samples/s + x-real-time meter used by the CLI.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def _sync(result) -> None:
    """Wait for the work that makes ``result``: synchronize the device of
    every CUDA tensor in it (tuples, lists and NamedTuples are walked);
    CPU tensors are ready when they are returned."""
    devices = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, (tuple, list)):
            for u in v:
                walk(u)

    walk(result)
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block, its trace written into
    ``logdir`` as ``<host>_<pid>.<time>.pt.trace.json`` when the block
    ends, also when it raises.  Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


class StageTimer:
    """Accumulate wall-clock per named stage; waits for device outputs."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            _sync(result)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def time_fn(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return out

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<30} {tot * 1e3:9.2f} ms total "
                         f"({tot / n * 1e3:8.3f} ms/call, {n} calls)")
        return "\n".join(lines)


class Throughput:
    """Running IQ-samples/s and x-real-time meter."""

    def __init__(self, rf_fs: float, ema: float = 0.9):
        self.rf_fs = rf_fs
        self.ema = ema
        self.rate: Optional[float] = None
        self._last: Optional[float] = None

    def update(self, iq_samples: int) -> float:
        now = time.perf_counter()
        if self._last is not None:
            inst = iq_samples / (now - self._last)
            self.rate = (inst if self.rate is None
                         else self.ema * self.rate + (1 - self.ema) * inst)
        self._last = now
        return self.rate or 0.0

    @property
    def x_realtime(self) -> float:
        return (self.rate or 0.0) / self.rf_fs

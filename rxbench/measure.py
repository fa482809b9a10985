"""What a metric reader reads: one run's window, its traced chunks, its
set-up time and memory, and the arithmetic the readers share."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from rxbench import spec


@dataclass
class Run:
    bench: object                # harness.Bench
    window: object               # harness.Window
    setup_s: float
    window_peak_bytes: int       # max_memory_allocated over the window
    device_name: str
    trace: Optional[object] = None   # trace.Trace, with --trace 1

    def counted(self) -> list:
        return self.window.counted()

    def peaks(self) -> Optional[dict]:
        for key, row in spec.peaks().items():
            if key in self.device_name:
                return row
        return None

    def stream_idle(self) -> Optional[tuple[float, float]]:
        """Seconds the compute stream waited between calls, and the span
        from the first call's start to the last one's end, by the timing
        events around each counted chunk's call (None off the card): a
        wait is the time from one call's end to the next one's start
        where the host handed the next call over late."""
        done = self.counted()
        if not done or done[0].events is None:
            return None
        waits = sum(max(0.0, a.events[1].elapsed_time(b.events[0]))
                    for a, b in zip(done, done[1:]))
        span = done[0].events[0].elapsed_time(done[-1].events[1])
        return waits * 1e-3, span * 1e-3

    def kernel_time(self, names) -> tuple[float, int]:
        """Seconds and launches of the traced kernels whose name holds any
        of ``names``."""
        t, n = 0.0, 0
        for name, (s, count) in self.trace.kernels.items():
            if any(k in name for k in names):
                t, n = t + s, n + count
        return t, n

    def roofline_pct(self, roofline: str) -> Optional[float]:
        """The kernels of ``rooflines/<roofline>.py``: the least time the
        card could take for one launch (the larger of its bytes over the
        memory bandwidth and its float operations over the float32 peak)
        as a percentage of the mean traced launch.  None without a trace,
        a launch of them, or the card's peaks."""
        mod = spec.rooflines()[roofline]
        peaks = self.peaks()
        if self.trace is None or peaks is None:
            return None
        t, n = self.kernel_time(mod.KERNELS)
        if n == 0:
            return None
        b = self.bench
        nbytes, flops = mod.work(b.cfg, b.geo, b.c, b.precision)
        rate = (peaks["fp32_flop_per_s"] if b.precision == "highest"
                else peaks["bf16_flop_per_s"])
        bound = max(nbytes / peaks["hbm_bytes_per_s"], flops / rate)
        return 100.0 * bound / (t / n)

    def glue_s(self) -> Optional[float]:
        """Traced kernel seconds under no roofline file's names."""
        if self.trace is None:
            return None
        mapped = [k for m in spec.rooflines().values() for k in m.KERNELS]
        return sum(s for name, (s, _) in self.trace.kernels.items()
                   if not any(k in name for k in mapped))

    def split_ms(self) -> dict:
        """Traced device milliseconds a block by roofline file, glue,
        copies (and memsets) and busy: the stderr summary of a traced run."""
        t, blocks = self.trace, self.trace.blocks
        out = {name: 1e3 * self.kernel_time(mod.KERNELS)[0] / blocks
               for name, mod in spec.rooflines().items()}
        out.update(glue=1e3 * self.glue_s() / blocks,
                   copies=1e3 * t.copies_s / blocks,
                   busy=1e3 * t.busy_s / blocks,
                   window=1e3 * t.window_s / blocks)
        return out


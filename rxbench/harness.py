"""One run of one cell: set-up, the measured window, the traced chunks
and what the check needs, on the program's compiled step.

The window drives ``dy4tpu_torch.pipeline.graph.run_blocks(params,
state, blocks, cfg, chunk=K, precision=..., cdr_timing=...)`` in a
closed loop: chunk k+1 is handed over, then chunk k is waited for, so at
most two chunks are in flight.  Each call gets the state the call before
it returned and K blocks of the device-resident ring
(``gen/traffic.py``), walked chunk by chunk.  A chunk is done when its
outputs (audio ``mono`` / ``left`` / ``right``; RDS ``rds_symbols``,
``rds_sym_i``, ``rds_resync``, ``rds_offset``) have landed in pinned host
memory: a side stream copies them once the compute stream's event says
the chunk is through.  Timing events on the compute stream around each
call give the waits between calls (``measure.Run.stream_idle``).

The check keeps, for a few rows drawn from the seed, the landed outputs
of three spans of two chunks each: the window's first two (from the
initial state), two drawn from the seed in the window's first half, and
its last two.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from rxbench.gen import traffic as gen_traffic
from rxbench.ref.receiver import Geometry

OUTPUTS = ("mono", "left", "right", "rds_symbols", "rds_sym_i",
           "rds_resync", "rds_offset")
SPAN = 2              # chunks a checked span holds: one call boundary
WARM_CHUNKS = 4       # closed-loop chunks of set-up after the capture


def program_config(cfg: dict):
    """The program's ``ModeConfig`` for a configuration file: its mode's
    entry with every field the file sets taken from the file; raises
    where the program's block is not the file's."""
    import dataclasses

    from dy4tpu_torch.config import get_mode

    base = get_mode(int(cfg["mode"]))
    names = {f.name for f in dataclasses.fields(base)}
    mcfg = dataclasses.replace(base, **{k: v for k, v in cfg.items()
                                        if k in names})
    if mcfg.iq_per_block != int(cfg["block_iq_samples"]):
        raise ValueError(f"{cfg['name']}: the program's block holds "
                         f"{mcfg.iq_per_block} samples, the file "
                         f"{cfg['block_iq_samples']}")
    if bool(cfg["rds"]) != mcfg.supports_rds:
        has = "has" if mcfg.supports_rds else "lacks"
        raise ValueError(f"{cfg['name']}: rds={cfg['rds']} but the "
                         f"program's mode {has} RDS")
    return mcfg


@dataclass
class Chunk:
    """One chunk of the window: its index, host times (handed over, call
    returned, outputs landed), on the card the timing events recorded on
    the compute stream before and after its call and, until it lands, its
    device outputs."""
    index: int
    t_sent: float
    t_call: float
    slot: int
    outs: object = None
    t_land: float = 0.0
    events: tuple = None


@dataclass
class Window:
    """What a closed loop measured: every chunk landed, in order; the
    nominal end; the chunks' kept rows for the check."""
    chunks: list
    t_start: float
    t_end: float
    kept: dict = field(default_factory=dict)     # index -> {output: rows}
    spans: list = field(default_factory=list)    # first chunks, all kept

    def counted(self) -> list:
        return [c for c in self.chunks if c.t_land <= self.t_end]


class Bench:
    """A cell set up on ``device`` from ``seed``: the ring, the program's
    params and state, the landing buffers, the graph captured.

    ``run_blocks`` is the program's entry (a test substitutes a broken
    one); ``precision`` overrides the configuration's (the control)."""

    def __init__(self, wl: dict, cfg: dict, seed: int, device, *,
                 precision: Optional[str] = None,
                 run_blocks: Optional[Callable] = None):
        import torch

        from dy4tpu_torch.pipeline import graph
        from dy4tpu_torch.pipeline import receiver as rx

        self.cfg = cfg
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.geo = Geometry.of(cfg)
        self.mcfg = program_config(cfg)
        self.k = int(wl["chunk"])
        self.c = int(wl["stations"])
        self.ring_blocks = int(wl["ring_blocks"])
        self.in_flight = int(wl["in_flight"])
        self.block_s = self.geo.iq / cfg["rf_fs"]
        self.precision = precision or cfg["precision"]
        self.step_kw = dict(precision=self.precision,
                            cdr_timing=cfg["cdr_timing"])
        self.run_blocks = run_blocks or graph.run_blocks
        self._rx = rx

        rng = np.random.default_rng([int(seed), 1])
        check = wl["check"]
        strata = np.array_split(np.arange(self.c), int(check["rows"]))
        self.rows = np.array([int(rng.choice(s)) for s in strata])
        self.mid_frac = float(rng.uniform(*check["mid_span"]))

        t0 = time.perf_counter()
        traffic = gen_traffic.draw(wl, self.geo, seed)
        loops = gen_traffic.synthesize(traffic, wl, cfg, self.geo)
        t1 = time.perf_counter()
        self.ring = gen_traffic.ring(loops, traffic, wl, self.geo,
                                     self.device)
        self.params = rx.make_params(self.mcfg, device=self.device)
        self._lander = _Lander(self) if self.on_card else None
        self._sync()
        t2 = time.perf_counter()
        self.state = None
        self.chunk_s = None
        self._warm()
        # seconds of set-up by part (the stderr summary)
        self.setup_parts = {"synthesis": t1 - t0,
                            "ring_params_pinned": t2 - t1,
                            "capture_and_warm": time.perf_counter() - t2}

    # ---- the program's calls ----
    def init_state(self):
        return self._rx.init_state(self.mcfg, (self.c,), device=self.device)

    def _event(self):
        """A timing event recorded on the compute stream (on the card)."""
        if not self.on_card:
            return None
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _sync(self):
        if self.on_card:
            import torch
            torch.cuda.synchronize(self.device)

    def _send(self, index: int, record) -> Chunk:
        b0 = (index * self.k) % self.ring_blocks
        blocks = self.ring[b0:b0 + self.k]
        t0 = time.perf_counter()
        with record("rxbench.run_blocks"):
            before = self._event()
            state, outs = self.run_blocks(self.params, self.state, blocks,
                                          self.mcfg, chunk=self.k,
                                          **self.step_kw)
            after = self._event()
        ch = Chunk(index, t0, time.perf_counter(), index % self.in_flight,
                   outs, events=(before, after) if self.on_card else None)
        self.state = state
        if self._lander is not None:
            with record("rxbench.land"):
                self._lander.copy(ch)
        return ch

    def _land(self, ch: Chunk, record) -> dict:
        """Wait for ``ch``'s outputs on the host: returns them as numpy
        arrays (views of the pinned buffers on the card, valid until the
        slot is reused)."""
        with record("rxbench.wait"):
            if self._lander is not None:
                host = self._lander.wait(ch)
            else:
                host = {f: getattr(ch.outs, f).numpy() for f in OUTPUTS
                        if getattr(ch.outs, f) is not None}
        ch.t_land = time.perf_counter()
        ch.outs = None
        return host

    def loop(self, start: int, *, seconds: Optional[float] = None,
             chunks: Optional[int] = None, keep: Callable = None,
             record=None) -> Window:
        """The closed loop from chunk index ``start``: for ``seconds`` of
        host clock (no chunk is handed over after that) or for ``chunks``
        chunks.  ``keep(ch, host)`` sees every chunk as it lands."""
        import contextlib

        record = record or (lambda name: contextlib.nullcontext())
        t0 = time.perf_counter()
        t_end = t0 + seconds if seconds is not None else float("inf")
        pending, done, index = deque(), [], start

        def land():
            ch = pending.popleft()
            host = self._land(ch, record)
            if keep:
                keep(ch, host)
            done.append(ch)

        while (time.perf_counter() < t_end if chunks is None
               else index < start + chunks):
            pending.append(self._send(index, record))
            index += 1
            if len(pending) >= self.in_flight:
                land()
        while pending:
            land()
        t_first = done[0].t_sent if done else t0
        return Window(done, t_first,
                      t_first + seconds if seconds is not None else t_end)

    def _warm(self) -> None:
        """Capture the chunk graph and run the closed loop a few chunks,
        on a throwaway state; time a chunk."""
        self.state = self.init_state()
        w = self.loop(0, chunks=1 + WARM_CHUNKS)
        self._sync()
        steady = w.chunks[1:]
        self.chunk_s = ((steady[-1].t_land - steady[0].t_land)
                        / (len(steady) - 1) if len(steady) > 1
                        else steady[0].t_land - steady[0].t_sent)
        self.state = None

    # ---- the window ----
    def window(self, seconds: float) -> Window:
        """The measured window from the initial state at ring block 0,
        keeping what the check needs: the first span, one drawn from the
        seed in the window's first half and the last two chunks counted."""
        expected = max(2 * SPAN + 2, int(seconds / max(self.chunk_s, 1e-6)))
        mid = max(SPAN, int(self.mid_frac * expected))
        planned = set(range(SPAN)) | set(range(mid, mid + SPAN))
        rows = self.rows
        kept, last = {}, deque(maxlen=SPAN + self.in_flight)

        def keep(ch, host):
            data = {f: np.array(a[:, rows]) for f, a in host.items()}
            if ch.index in planned:
                kept[ch.index] = data
            last.append((ch.index, data))

        self.state = self.init_state()
        w = self.loop(0, seconds=seconds, keep=keep)
        counted = {c.index for c in w.counted()}
        tail = [x for x in last if x[0] in counted][-SPAN:]
        after = mid + SPAN if mid + SPAN - 1 in counted else SPAN
        if len(tail) == SPAN and tail[0][0] >= after:
            kept.update(tail)
        w.kept = {i: d for i, d in kept.items() if i in counted}
        w.spans = [f for f in sorted({0, mid, *(i for i, _ in tail[:1])})
                   if all(f + j in w.kept for j in range(SPAN))]
        return w

    def loop_inputs(self, blocks: int) -> np.ndarray:
        """The checked rows' u8 loop from its first block, ``blocks``
        blocks of it: [blocks, rows, 2 * iq]."""
        import torch

        rows = torch.as_tensor(self.rows, device=self.device)
        loop = self.ring[:self.ring_blocks].index_select(1, rows).cpu().numpy()
        return loop[np.arange(blocks) % self.ring_blocks]


class _Lander:
    """Two slots of pinned host buffers, one for each chunk in flight, and
    a copy stream: a chunk's outputs are copied out once the compute
    stream's event has passed, and its slot's event marks them landed."""

    def __init__(self, bench: Bench):
        import torch

        g, k, c = bench.geo, bench.k, bench.c
        shapes = {"mono": ((k, c, g.n_audio), torch.float32),
                  "left": ((k, c, g.n_audio), torch.float32),
                  "right": ((k, c, g.n_audio), torch.float32)}
        if g.rds:
            shapes.update(
                rds_symbols=((k, c, g.n_sym), torch.int8),
                rds_sym_i=((k, c, g.n_sym), torch.float32),
                rds_resync=((k, c), torch.bool),
                rds_offset=((k, c), torch.int32))
        n = bench.in_flight
        self.slots = [{f: torch.empty(s, dtype=d, pin_memory=True)
                       for f, (s, d) in shapes.items()} for _ in range(n)]
        self.done = [torch.cuda.Event() for _ in range(n)]
        self.landed = [torch.cuda.Event() for _ in range(n)]
        self.stream = torch.cuda.Stream(bench.device)

    def copy(self, ch: Chunk) -> None:
        import torch

        j = ch.slot
        self.done[j].record()
        self.stream.wait_event(self.done[j])
        with torch.cuda.stream(self.stream):
            for f, pin in self.slots[j].items():
                pin.copy_(getattr(ch.outs, f), non_blocking=True)
            self.landed[j].record(self.stream)

    def wait(self, ch: Chunk) -> dict:
        self.landed[ch.slot].synchronize()
        return {f: pin.numpy() for f, pin in self.slots[ch.slot].items()}

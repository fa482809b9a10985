"""The compiled step: the receiver's chunk of K blocks as one captured
CUDA graph, the port's counterpart of dy4tpu's jitted scans.

dy4tpu runs every production path as one compiled program a chunk of
blocks: ``run_blocks`` is a ``lax.scan``, the CLI's ``run_chunk`` a jitted
scan of ``--chunk`` blocks, fleet serving a jitted scan a chunk
(``receiver_step_jit``'s closure form), ``run_wideband_blocks`` a
``lax.scan`` of wideband steps (``wideband_dp``'s ``run`` and the wideband
tool's ``run_chunk`` the same, jitted), and the sharded receiver's
``step_c`` one jitted step with its carry donated.  The port's eager step is a
Python loop of torch ops and kernel launches: the host issues some 250
of them a block, and the card waits on it.  Here the K steps of a chunk
are captured once as a CUDA graph, the hand-written kernels' launches
and the torch ops between them, and replayed for every chunk: the card
runs the same launches in the same order, so a replay's outputs and end
state equal the eager loop's bit for bit.  It is not ``torch.compile``.

    runner = graph.receiver_runner(params, state, cfg, **step_kwargs)
    outs = runner.run(blocks)      # blocks [K, C, bs] -> outputs [K, C, ...]
    state = runner.read()          # clones of the carried state

    state, outs = graph.run_blocks(params, state, blocks, cfg, chunk=8)
    state, outs = graph.run_wideband_blocks(params, chan, state,
                                            wb_blocks, cfg, chunk=8)
    runner = graph.sharded_runner(receiver, params, receiver.init(c))
    outs = runner.run(pieces)      # pieces [K, C_l, S*bs] -> [K, ...]

``ChunkRunner`` holds the **static buffers**: the carried state (and
whatever else the step carries, the CLI's de-emphasis state), each
chunk size's input buffers, and each graph's outputs.  A graph is
captured at a chunk's first run: a **warm-up** of the K steps on a clone
of the state, on a side stream, builds the kernels and fills the
constant and plan caches off the real state; then the K steps are
captured from the static state, and at the end of the captured region
the new state is copied in place into the static state, so a replay
advances the stream by K blocks and leaves no Python state behind.

Graphs are cached by the runner's key (the entry, the mode and every
static option of the step), K and the inputs' shapes (and, for inputs
the caller ``bind``-s as the graph's own, their addresses); the cache
is bounded (``MAX_GRAPHS``, least recently used out first), and a ragged
last chunk takes a graph of its own inside the bound.  The graphs of one
runner share one memory pool, so **a chunk's outputs are valid until the
runner's next run** (of any K): copy them out, or order the copy on the
stream, before that.

The kernel wrappers count their launches in Python, which a replay does
not run: the counts a capture made are taken back and added again at
every replay, so each wrapper's ``launches`` stays the number of
kernels the card ran (the warm-up's included; ``warm_blocks`` counts its
steps).  A capture or replay error raises; nothing falls back to the
eager step.  On a CPU state (the caller asked for the CPU) the runner
runs the same body eagerly on the same static buffers.

The runner's per-call steps are spans (``utils/profiling.py``, off by
default): ``graph.lookup`` (``run_blocks``' runner by its key),
``graph.load``, ``graph.input`` (the chunk's graph by its key, the chunk
into its static input), ``graph.replay``, ``graph.output`` (``run_stream``'s
copy-out) and ``graph.read``; inside a chunk's body, at capture or on the
CPU, ``graph.stack`` and ``graph.assign``.  A replay runs no Python, so
``span_map`` names its device work by the launches the capture recorded.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Optional

import torch

from dy4tpu_torch.config import ModeConfig
from dy4tpu_torch.pipeline import receiver as rx
from dy4tpu_torch.runtime import consts
from dy4tpu_torch.utils.profiling import device_spans, settle, span, spans

Tensor = torch.Tensor

MAX_GRAPHS = 4    # graphs a runner keeps: a chunk size, its ragged tail,
#                   fleet's two bound buffers
MAX_RUNNERS = 2   # runners ``run_blocks`` keeps


def _leaves(tree) -> list[Tensor]:
    """The tensors of a tree of tuples / NamedTuples, depth first, None
    subtrees skipped."""
    if tree is None:
        return []
    if isinstance(tree, Tensor):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, Tensor):
        return fn(tree)
    vals = [_map(fn, sub) for sub in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


def _signature(tree):
    """The tree's structure with each tensor's shape and dtype: two trees
    of one signature can be copied leaf for leaf."""
    if tree is None:
        return None
    if isinstance(tree, Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    return (type(tree).__name__, tuple(_signature(sub) for sub in tree))


def _assign(dst, src) -> None:
    """Copy every leaf of ``src`` into the leaf of ``dst`` in its place.
    A leaf that is its place's own tensor is left alone; one that shares
    memory with another leaf of ``dst`` is cloned before any copy."""
    if _signature(dst) != _signature(src):
        raise ValueError(f"state of another structure: {_signature(src)} "
                         f"against the runner's {_signature(dst)}")
    d_leaves = _leaves(dst)
    owned = {d.untyped_storage().data_ptr() for d in d_leaves}
    pairs = [(d, s if s is d or s.untyped_storage().data_ptr() not in owned
              else s.clone()) for d, s in zip(d_leaves, _leaves(src))]
    for d, s in pairs:
        if s is not d:
            d.copy_(s)


def _stack(outs: list):
    """Per-block outputs (a tree of tuples / NamedTuples of tensors and
    None) -> the same tree with each leaf stacked on a leading block
    axis."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, Tensor):
        return torch.stack(outs)
    fields = [_stack(list(f)) for f in zip(*outs)]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(
        fields)


def counters() -> list:
    """Every kernel wrapper's launch counter (the wrappers and their
    ``kernels.Variant`` epilogues)."""
    from dy4tpu_torch.ops import (backend_cuda, channelizer_cuda, fft_cuda,
                                  fir_cuda, frontend_cuda, pll_cuda,
                                  resample_cuda)
    return [frontend_cuda.fused_frontend_full,
            frontend_cuda.fused_frontend_full.corr,
            frontend_cuda.fused_frontend_if, frontend_cuda.fused_frontend_raw,
            frontend_cuda.fused_frontend, frontend_cuda.fused_frontend_raw_pm,
            pll_cuda.phase_scan, pll_cuda.phase_scan_target,
            pll_cuda.phase_scan_target.expand, pll_cuda.phase_scan_coded,
            backend_cuda.fused_audio_backend,
            resample_cuda.fused_audio_backend_rational,
            resample_cuda.fused_rds_backend,
            channelizer_cuda.channelize_branches, fft_cuda.fft,
            fir_cuda.block_fir_decim]


class _Graph:
    """One captured chunk: its graph (None on the CPU), static inputs,
    outputs, the carry's constant tensors it reads, and each counter's
    launches a replay makes."""

    def __init__(self, inputs, graph=None, outputs=None, held=(),
                 launches=None):
        self.inputs = inputs
        self.graph = graph
        self.outputs = outputs
        self.held = held
        self.launches = launches or {}


class ChunkRunner:
    """Runs ``step`` over chunks of blocks from one static carry: on the
    card as a captured CUDA graph a chunk size, on the CPU eagerly.

    ``step(carry, *block_inputs) -> (carry, outputs)``: one block, with
    ``outputs`` a tuple or NamedTuple of tensors (None fields allowed);
    ``finish(stacked) -> outputs``: applied to the chunk's stacked outputs
    inside the graph (default: none).  ``carry``: the initial carry, a
    tree of tuples / NamedTuples of tensors, copied into the runner's own
    static buffers.  ``key``: the step's static options (entry, mode,
    flags), the first part of every graph's key.
    """

    def __init__(self, step: Callable, carry, *, key: tuple = (),
                 finish: Optional[Callable] = None,
                 capture_error_mode: str = "global"):
        leaves = _leaves(carry)
        if not leaves:
            raise ValueError("the carry holds no tensor")
        self.step = step
        self.finish = finish
        self.key = tuple(key)
        self.capture_error_mode = capture_error_mode
        self.device = leaves[0].device
        self.on_card = self.device.type == "cuda"
        # distinct leaves of our own (an initial state may share one zero
        # tensor between fields)
        self.carry = _map(lambda t: t.clone(), carry)
        self._graphs: OrderedDict = OrderedDict()
        self.pool = torch.cuda.graph_pool_handle() if self.on_card else None
        self.capture_seconds = 0.0
        self.warm_blocks = 0

    # ---- the state ----
    def load(self, carry) -> None:
        """Copy ``carry`` into the static carry (resume), in stream order
        after any chunk already issued."""
        with span("graph.load"):
            _assign(self.carry, carry)

    def read(self):
        """Clones of the static carry (checkpoint), taken in stream order
        after the chunks issued so far."""
        with span("graph.read"):
            return _map(lambda t: t.clone(), self.carry)

    # ---- the graphs ----
    def graph_key(self, inputs, bind: bool = False) -> tuple:
        """The cache key of a chunk of ``inputs``: the runner's key, K,
        each input's shape and dtype, and with ``bind`` their addresses."""
        return (*self.key, int(inputs[0].shape[0]),
                tuple((tuple(t.shape), t.dtype) for t in inputs),
                tuple(t.data_ptr() for t in inputs) if bind else None)

    def _body(self, carry, inputs):
        outs = []
        for blocks in zip(*inputs):
            carry, out = self.step(carry, *blocks)
            outs.append(out)
        with span("graph.stack"):
            stacked = _stack(outs)
            return carry, (stacked if self.finish is None
                           else self.finish(stacked))

    def _entry(self, inputs, bind: bool) -> tuple[_Graph, bool]:
        """The graph of a chunk like ``inputs`` and whether it was made
        now (its static inputs then hold ``inputs`` already)."""
        if len({int(t.shape[0]) for t in inputs}) != 1:
            raise ValueError(f"inputs of unequal block counts: "
                             f"{[tuple(t.shape) for t in inputs]}")
        key = self.graph_key(inputs, bind)
        ent = self._graphs.get(key)
        if ent is not None:
            self._graphs.move_to_end(key)
            return ent, False
        static = tuple(inputs) if bind else tuple(
            t.clone(memory_format=torch.contiguous_format) for t in inputs)
        ent = self._capture(static) if self.on_card else _Graph(static)
        self._graphs[key] = ent
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return ent, True

    def _capture(self, static) -> _Graph:
        """Warm up on a clone of the carry on a side stream, then capture
        the K steps from the static carry."""
        t0 = time.perf_counter()
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._body(_map(lambda t: t.clone(), self.carry), static)
        cur.wait_stream(side)
        self.warm_blocks += int(static[0].shape[0])
        wrappers = counters()
        before = [w.launches for w in wrappers]
        graph = torch.cuda.CUDAGraph()
        try:
            with consts.hold() as held:
                with torch.cuda.graph(
                        graph, pool=self.pool,
                        capture_error_mode=self.capture_error_mode):
                    new, outputs = self._body(self.carry, static)
                    with span("graph.assign"):
                        _assign(self.carry, new)
        finally:
            # the capture ran no kernel: take its counts back
            made = {w: w.launches - n for w, n in zip(wrappers, before)}
            for w, n in zip(wrappers, before):
                w.launches = n
        self.capture_seconds += time.perf_counter() - t0
        return _Graph(static, graph, outputs, tuple(held),
                      {w: n for w, n in made.items() if n})

    def prepare(self, *inputs, bind: bool = False) -> None:
        """Capture the graph of a chunk like ``inputs`` now (off a clock),
        without running it."""
        self._entry(inputs, bind)

    def run(self, *inputs: Tensor, bind: bool = False):
        """Advance the carry by one chunk.  ``inputs``: the step's block
        inputs, each [K, ...].  With ``bind`` the tensors themselves are
        the graph's inputs (the caller refills them between runs; their
        addresses key the graph), else they are copied into the graph's
        own.  Returns the chunk's outputs, stacked on a leading K axis:
        on the card the graph's static outputs, valid until this runner's
        next run."""
        with span("graph.input"):
            ent, fresh = self._entry(inputs, bind)
            if not (bind or fresh):
                for s, t in zip(ent.inputs, inputs):
                    s.copy_(t)
        with span("graph.replay"):
            if ent.graph is None:
                new, outs = self._body(self.carry, ent.inputs)
                with span("graph.assign"):
                    _assign(self.carry, new)
                return outs
            ent.graph.replay()
            for w, n in ent.launches.items():
                w.launches += n
            return ent.outputs

    def span_map(self, *inputs: Tensor, bind: bool = False
                 ) -> list[tuple[str, Optional[str]]]:
        """One chunk's device work in launch order, each kernel, copy
        and memset as ``(name, innermost span)``: what a replay of the
        graph of a chunk like ``inputs`` runs (a graph replays its
        capture's launches in order), named by the spans the capture ran
        through (``utils/profiling.py``).  The chunk's body and the
        carry's assign run eagerly on clones of the carry and of the
        graph's static inputs (``inputs`` where no graph is captured
        yet): once as a capture's warm-up, then with the spans on under
        ``torch.profiler``.  The runner's state and graphs stay as they
        were; the wrappers count the kernels both runs launched.  On the
        CPU there is no device work: the list is empty."""
        from torch.profiler import ProfilerActivity, profile

        ent = self._graphs.get(self.graph_key(inputs, bind))
        carry = _map(lambda t: t.clone(), self.carry)
        static = tuple(t.clone() for t in (inputs if ent is None
                                            else ent.inputs))

        def body():
            new, _ = self._body(carry, static)
            with span("graph.assign"):
                _assign(carry, new)

        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        body()
        with spans(), profile(activities=acts) as prof:
            if self.on_card:
                settle(self.device)
            body()
            if self.on_card:
                settle(self.device)
        return [(e.name, name) for e, name, _ in device_spans(prof.events())]

    def run_stream(self, *inputs: Tensor, chunk: int):
        """``inputs`` [B, ...] in chunks of ``chunk`` blocks (the last one
        ragged) -> the outputs of all B blocks, copied out of the graphs
        into tensors of the caller's."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        n = int(inputs[0].shape[0])
        result = None
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            outs = self.run(*(t[lo:hi] for t in inputs))
            with span("graph.output"):
                if result is None:
                    result = _map(
                        lambda t: t.new_empty((n, *t.shape[1:])), outs)
                for r, o in zip(_leaves(result), _leaves(outs)):
                    r[lo:hi].copy_(o)
        return result


# ---- the receiver ----

def _options(entry: str, cfg: ModeConfig, kw: dict) -> tuple:
    return (entry, cfg.mode, *sorted((k, repr(v)) for k, v in kw.items()))


def receiver_runner(params: rx.ReceiverParams, state: rx.ReceiverState,
                    cfg: ModeConfig, *, entry: str = "rf",
                    **step_kwargs) -> ChunkRunner:
    """A runner of ``receiver.receiver_step`` (``entry="rf"``: inputs
    ``[K, ..., block_size]`` u8) or ``receiver_step_if`` (``"if"``: inputs
    I and Q ``[K, ..., if_per_block]`` float32) with ``step_kwargs``,
    from ``state``; its outputs are ``StepOutputs`` stacked on K."""
    if entry == "rf":
        def step(st, blk):
            return rx.receiver_step(params, st, blk, cfg, **step_kwargs)
    elif entry == "if":
        def step(st, i_if, q_if):
            return rx.receiver_step_if(params, st, i_if, q_if, cfg,
                                       **step_kwargs)
    else:
        raise ValueError(f"entry must be 'rf' or 'if', got {entry!r}")
    return ChunkRunner(step, state, key=_options(entry, cfg, step_kwargs))


_RUNNERS: OrderedDict = OrderedDict()


def _cached(key_of: Callable[[], tuple], held: tuple, state,
            make: Callable[[], ChunkRunner]) -> ChunkRunner:
    """The runner of the key ``key_of()`` with ``state`` loaded into it:
    made by ``make()`` at its first use, then kept among the last
    ``MAX_RUNNERS`` of ``run_blocks`` and ``run_wideband_blocks`` (their
    keys differ by the entry ``_options`` puts in them).  The entry holds
    ``held`` (the params the key names by ``id``), so that no ``id`` is
    reused while the runner lives.  The key and the lookup are the span
    ``graph.lookup``; the load is the runner's ``graph.load``."""
    with span("graph.lookup"):
        key = key_of()
        hit = _RUNNERS.get(key)
        made = hit is None
        if made:
            hit = (held, make())
            _RUNNERS[key] = hit
            while len(_RUNNERS) > MAX_RUNNERS:
                _RUNNERS.popitem(last=False)
        else:
            _RUNNERS.move_to_end(key)
    if not made:
        hit[1].load(state)
    return hit[1]


def cached_runner(params, state, cfg, entry: str = "rf",
                  step_kwargs: Optional[dict] = None) -> ChunkRunner:
    """``run_blocks``' runner for these params, state structure and
    options, with ``state`` loaded into it (``_cached``)."""
    step_kwargs = step_kwargs or {}
    return _cached(lambda: (id(params), _signature(state),
                            *_options(entry, cfg, step_kwargs)),
                   (params,), state,
                   lambda: receiver_runner(params, state, cfg, entry=entry,
                                           **step_kwargs))


def run_blocks(params: rx.ReceiverParams, state: rx.ReceiverState,
               iq_u8_blocks: Tensor, cfg: ModeConfig, *, chunk: int = 8,
               **step_kwargs) -> tuple[rx.ReceiverState, rx.StepOutputs]:
    """``receiver.run_blocks`` through the chunk graphs: the stream
    [num_blocks, ..., block_size] in chunks of ``chunk`` blocks, each a
    graph replay.  Returns the final state and the stacked outputs, as
    ``receiver.run_blocks`` does and bit for bit equal to it;
    ``step_kwargs`` go to ``receiver_step``."""
    runner = cached_runner(params, state, cfg, "rf", step_kwargs)
    outs = runner.run_stream(iq_u8_blocks, chunk=chunk)
    return runner.read(), outs


def run_blocks_if(params: rx.ReceiverParams, state: rx.ReceiverState,
                  i_blocks: Tensor, q_blocks: Tensor, cfg: ModeConfig, *,
                  chunk: int = 8, **step_kwargs
                  ) -> tuple[rx.ReceiverState, rx.StepOutputs]:
    """``run_blocks`` of the IF entry: ``receiver_step_if`` over I and Q
    [num_blocks, ..., if_per_block] float32."""
    runner = cached_runner(params, state, cfg, "if", step_kwargs)
    outs = runner.run_stream(i_blocks, q_blocks, chunk=chunk)
    return runner.read(), outs


def clear() -> None:
    """Drop ``run_blocks``' and ``run_wideband_blocks``' runners and
    their graphs."""
    _RUNNERS.clear()


# ---- the receiver CLI's chunk body ----

def cli_runner(params: rx.ReceiverParams, state: rx.ReceiverState,
               de_state: tuple, cfg: ModeConfig, *, stereo: bool,
               blend: bool = False, de_a: Optional[float] = None,
               keep_rds: bool = False, **step_kwargs) -> ChunkRunner:
    """The CLI's chunk (``app.py``, as dy4tpu's ``app.run_chunk``
    compiles it): per block ``receiver_step``, the stereo blend (with
    ``blend`` and ``stereo``) and the de-emphasis (pole ``de_a``, state
    ``de_state``, one tensor a stream); per chunk the interleave and the
    s16 quantize.  The carry is ``(state, de_state)``.  A run of
    ``[K, C, block_size]`` u8 returns ``(pcm [K, C, n])`` and, with
    ``keep_rds``, the RDS symbols, resync flags and CDR offsets
    ``[K, C, ...]`` after it."""
    from dy4tpu_torch.ops import deemph, mix

    def step(carry, blk):
        st, de = carry
        st, out = rx.receiver_step(params, st, blk, cfg, **step_kwargs)
        streams = (out.left, out.right) if stereo else (out.mono,)
        if blend and stereo:
            streams = mix.stereo_blend(out.left, out.right, out.pilot_snr_db)
        if de_a is not None:
            filt = [deemph.deemphasis_block(s, d, de_a)
                    for s, d in zip(streams, de)]
            de = tuple(f[1] for f in filt)
            streams = tuple(f[0] for f in filt)
        rds = ((out.rds_symbols, out.rds_resync, out.rds_offset)
               if keep_rds else ())
        return (st, de), (*streams, *rds)

    def finish(stacked):
        n = 2 if stereo else 1
        pcm = (mix.quantize_s16(mix.interleave(*stacked[:2])) if stereo
               else mix.quantize_s16(stacked[0]))
        return (pcm, *stacked[n:])

    key = (*_options("cli", cfg, step_kwargs), ("stereo", stereo),
           ("blend", blend), ("de_a", de_a), ("keep_rds", keep_rds))
    return ChunkRunner(step, (state, tuple(de_state)), key=key,
                       finish=finish)


# ---- the wideband receiver ----

def wideband_runner(params: rx.ReceiverParams, chan, state, cfg: ModeConfig,
                    **step_kwargs) -> ChunkRunner:
    """A runner of ``wideband.wideband_step`` with ``step_kwargs`` over
    the bank ``chan``, from the ``WidebandState`` ``state``: inputs
    ``[K, *bands, 2*C*if_per_block]`` u8, outputs ``WidebandOutputs``
    stacked on K.  Its graphs are keyed by the mode, the bank's C and T
    and the step's options; whether AFC and the tracker ride along is
    fixed by the carry's structure, which ``load`` holds every state
    to."""
    from dy4tpu_torch.pipeline import wideband as wb

    def step(st, blk):
        return wb.wideband_step(params, chan, st, blk, cfg, **step_kwargs)

    key = (*_options("wideband", cfg, step_kwargs),
           ("C", chan.channels), ("T", chan.taps_per_branch))
    return ChunkRunner(step, state, key=key)


def run_wideband_blocks(params: rx.ReceiverParams, chan, state,
                        wb_blocks: Tensor, cfg: ModeConfig, *,
                        chunk: int = 8, **step_kwargs):
    """``wideband.run_wideband_blocks`` through the chunk graphs: the
    stream [num_blocks, *bands, 2*C*if_per_block] in chunks of ``chunk``
    steps, each a graph replay.  Returns the final state and the stacked
    ``WidebandOutputs``, as ``wideband.run_wideband_blocks`` does and bit
    for bit equal to it.  Its runners are cached like ``run_blocks``',
    keyed by the params and the bank (each by ``id``, held by the cache)
    as well (``cached_wideband_runner``)."""
    runner = cached_wideband_runner(params, chan, state, cfg, step_kwargs)
    outs = runner.run_stream(wb_blocks, chunk=chunk)
    return runner.read(), outs


def cached_wideband_runner(params, chan, state, cfg: ModeConfig,
                           step_kwargs: Optional[dict] = None
                           ) -> ChunkRunner:
    """``run_wideband_blocks``' runner for these params, bank, state
    structure and options, with ``state`` loaded into it (``_cached``)."""
    step_kwargs = step_kwargs or {}
    return _cached(lambda: (id(params), id(chan), _signature(state),
                            *_options("wideband", cfg, step_kwargs)),
                   (params, chan), state,
                   lambda: wideband_runner(params, chan, state, cfg,
                                           **step_kwargs))


# ---- the sharded receiver ----

def sharded_runner(receiver, params: rx.ReceiverParams, carry
                   ) -> ChunkRunner:
    """A runner of ``ShardedReceiver.step`` (``receiver``: the exact or
    the legacy discipline) from ``carry`` (``receiver.init``'s), the
    counterpart of dy4tpu's ``step_c`` with its donated carry: the static
    carry is updated in place by every replay, ``read`` / ``load`` serve
    checkpoints.  Inputs ``[K, C_l, shard_blocks * block_size]`` u8 (this
    rank's pieces, ``input_sharding``'s, K steps), outputs
    ``ShardedOutputs`` stacked on K.  dy4tpu compiles one step (K = 1);
    K > 1 is the same step's loop in one graph.

    On a mesh with a time axis the step issues NCCL collectives
    (``batch_isend_irecv``, ``broadcast``, ``all_gather``,
    ``all_to_all_single``): every rank captures them in the same order
    and replays them together, so every rank must run its runner on the
    same chunks.  The capture then takes ``thread_local`` error mode, so
    that the process group's watchdog thread may query its events
    meanwhile.  On the CPU (gloo) every mesh runs the runner's eager
    body."""
    mesh = receiver.mesh

    def step(c, iq):
        return receiver.step(params, c, iq)

    key = ("sharded", receiver.cfg.mode, ("exact", receiver.exact),
           ("mesh", tuple(sorted(mesh.shape.items()))),
           ("shard_blocks", receiver.shard_blocks),
           ("halo_if", receiver.halo_if), ("stereo", receiver.stereo),
           ("channel_parallel_replay", receiver.channel_parallel_replay),
           ("precision", receiver.precision))
    collectives = receiver.t_shards > 1
    return ChunkRunner(step, carry, key=key,
                       capture_error_mode=("thread_local" if collectives
                                           else "global"))

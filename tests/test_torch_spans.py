"""The program's spans (``dy4tpu_torch.utils.profiling``, placed in
``pipeline/graph.py``, ``pipeline/receiver.py`` and ``ops/pll.py``) on
the CPU: off by default and then one shared no-op; on, each receiver
step's part and each ``run_blocks`` step recorded once, in order, every
op of the step under an ``rx.*`` span; outputs bitwise the same either
way; ``ChunkRunner.span_map``; ``device_spans`` on made-up events; and
on the card (``-m cuda``, run with ``--noconftest``) one replay's device
events against ``span_map``, name for name.

The eager steps run the span PLL (``pll_span=8``): under the profiler the
plain per-sample scan records some 0.6M ops a block, and the spans sit
where they sit on either scan.  Modes 0 and 1 run a sub-block (the
IF alignment doubled to 1500 IF samples or more; mode 2's is its block).
"""

import functools
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.pipeline import graph  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402
from dy4tpu_torch.utils import profiling  # noqa: E402

STEP = ("rx.front", "rx.pll_lanes", "rx.pll_scan", "rx.nco",
        "rx.pilot_snr", "rx.back", "rx.cdr")
CALL = ("graph.lookup", "graph.load", "graph.input", "graph.replay",
        "graph.output", "graph.read")
KW = dict(pll_span=8)
C = 2


@functools.lru_cache(maxsize=None)
def _blocks(mode: int, n_blocks: int, channels: int = C) -> torch.Tensor:
    """[n_blocks, channels, n] u8 of the bench broadcast, odd rows I/Q
    swapped; n a sub-block at modes 0 and 1, the block at mode 2."""
    cfg = get_mode(mode)
    n_if = cfg.if_alignment
    while n_if < 1500:
        n_if *= 2
    n = n_if * cfg.rf_decim * 2
    iq = fm.stereo_rds_broadcast(cfg, -(-n_blocks * n // cfg.block_size)
                                 ).ravel()[:n_blocks * n]
    swap = iq.reshape(-1, 2)[:, ::-1].reshape(-1)
    rows = [iq if r % 2 == 0 else swap for r in range(channels)]
    return torch.from_numpy(np.stack(rows, axis=1).reshape(
        n_blocks, channels, n).copy())


def _setup(mode: int, device="cpu", channels: int = C):
    cfg = get_mode(mode)
    return (cfg, rx.make_params(cfg, device=device),
            rx.init_state(cfg, (channels,), device=device))


def _profiled(fn, cuda: bool = False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profiling.spans(), profile(activities=acts) as prof:
        if cuda:
            profiling.settle(torch.device("cuda"))
        fn()
        if cuda:
            profiling.settle(torch.device("cuda"))
    return prof.events()


def _program_spans(events) -> list:
    return [e for e in sorted(events, key=lambda e: e.time_range.start)
            if e.device_type == DeviceType.CPU
            and profiling.is_span(e.name)]


def _enclosing(e, prefix: str):
    p = e.cpu_parent
    while p is not None and not p.name.startswith(prefix):
        p = p.cpu_parent
    return p


# ---- off ----

def test_span_off_is_one_shared_noop():
    assert not profiling._on
    off = profiling.span("rx.front")
    assert profiling.span("graph.replay") is off
    with off:
        pass
    with profiling.spans():
        on = profiling.span("rx.front")
        assert on is not off
        assert isinstance(on, torch.profiler.record_function)
    assert profiling.span("rx.front") is off


def test_a_profiler_without_spans_records_no_program_span():
    cfg, params, state = _setup(1)
    blocks = _blocks(1, 2)
    graph.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rx.receiver_step(params, state, blocks[0], cfg, **KW)
        graph.run_blocks(params, state, blocks, cfg, chunk=2, **KW)
    assert not [e.name for e in prof.events() if profiling.is_span(e.name)]
    assert any(e.name.startswith("aten::") for e in prof.events())


# ---- the receiver step ----

@pytest.mark.parametrize("mode", [0, 1, 2])
def test_step_spans_once_a_block_in_order_and_hold_every_op(mode):
    cfg, params, state = _setup(mode)
    blk = _blocks(mode, 1)[0]
    rx.receiver_step(params, state, blk, cfg, **KW)     # warm the caches
    events = _profiled(lambda: rx.receiver_step(params, state, blk, cfg,
                                                **KW))
    want = STEP if cfg.supports_rds else STEP[:-1]
    assert tuple(e.name for e in _program_spans(events)) == want
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    outside = [e.name for e in ops if _enclosing(e, "rx.") is None]
    assert not outside, outside[:5]
    # the lanes: two stacked at modes 0 and 2, the pilot's alone at 1
    stacks = [e for e in ops if e.name == "aten::stack"
              and _enclosing(e, "rx.").name == "rx.pll_lanes"]
    assert bool(stacks) == cfg.supports_rds


# ---- the compiled step ----

@pytest.mark.parametrize("mode", [1, 0])
def test_run_blocks_spans_once_a_chunk_in_order(mode):
    cfg, params, state = _setup(mode)
    blocks = _blocks(mode, 2)
    graph.clear()
    state, _ = graph.run_blocks(params, state, blocks, cfg, chunk=2, **KW)
    events = _profiled(lambda: graph.run_blocks(params, state, blocks, cfg,
                                                chunk=2, **KW))
    spans = _program_spans(events)
    top = [e.name for e in spans if _enclosing(e, "graph.") is None]
    assert tuple(top) == CALL
    # on the CPU the replay is the chunk's eager body: two steps, then
    # the stack and the carry's assign
    step = STEP if cfg.supports_rds else STEP[:-1]
    inner = [e.name for e in spans if e.name not in CALL]
    assert inner == [*step, *step, "graph.stack", "graph.assign"]
    assert all(_enclosing(e, "graph.replay") is not None
               for e in spans if e.name not in CALL)


@pytest.mark.parametrize("mode", [0, 2])
def test_spans_on_change_no_bit(mode):
    cfg, params, state = _setup(mode)
    blocks = _blocks(mode, 2)
    graph.clear()
    off = graph.run_blocks(params, state, blocks, cfg, chunk=2, **KW)
    graph.clear()
    with profiling.spans():
        on = graph.run_blocks(params, state, blocks, cfg, chunk=2, **KW)
    for a, b in zip(graph._leaves(off), graph._leaves(on)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_trace_holds_the_step_spans(tmp_path):
    cfg, params, state = _setup(1)
    blk = _blocks(1, 1)[0]
    with profiling.trace(str(tmp_path)):
        rx.receiver_step(params, state, blk, cfg, **KW)
    assert not profiling._on
    (path,) = tmp_path.glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert set(STEP[:-1]) <= names


def test_span_map_on_the_cpu_is_empty_and_leaves_the_runner():
    cfg, params, state = _setup(1)
    blocks = _blocks(1, 2)
    runner = graph.receiver_runner(params, state, cfg, **KW)
    runner.run(blocks)
    carry = runner.read()
    graphs = list(runner._graphs.items())
    assert runner.span_map(blocks) == []
    assert not profiling._on
    assert list(runner._graphs.items()) == graphs
    for a, b in zip(graph._leaves(carry), graph._leaves(runner.carry)):
        assert torch.equal(a, b)


# ---- device events and their spans, on made-up events ----

def _ev(name, t0, t1, ident=0, device=DeviceType.CPU):
    return SimpleNamespace(name=name, id=ident, device_type=device,
                           time_range=SimpleNamespace(start=t0, end=t1))


def _dev(name, t0, ident):
    return _ev(name, t0, t0 + 1, ident, DeviceType.CUDA)


def test_device_spans_take_the_innermost_span_of_their_launch():
    events = [
        _ev("outer.call", 0, 200),
        _ev("graph.replay", 0, 100), _ev("rx.front", 10, 20),
        _ev("rx.pll_lanes", 30, 60), _ev("rx.nco", 30, 40),
        _ev("cudaLaunchKernel", 12, 13, 1), _ev("cudaLaunchKernel", 30, 31, 2),
        _ev("cudaMemcpyAsync", 45, 46, 3), _ev("cudaLaunchKernel", 70, 71, 4),
        _ev("cudaLaunchKernel", 150, 151, 5),
        _ev("cudaLaunchKernel", 250, 251, 6),
        _dev("k_front", 200, 1), _dev("k_nco", 210, 2),
        _dev("Memcpy DtoD (Device -> Device)", 220, 3), _dev("k_tail", 230, 4),
        _dev("k_out", 240, 5), _dev("k_free", 250, 6), _dev("k_lost", 260, 99),
        _dev("rx.front", 200, 1), _dev("outer.call", 200, 1)]
    got = [(e.name, s, c) for e, s, c in profiling.device_spans(
        events, profiling.SPAN_PREFIXES + ("outer.",))]
    assert got == [
        ("k_front", "rx.front", "cudaLaunchKernel"),
        ("k_nco", "rx.nco", "cudaLaunchKernel"),
        ("Memcpy DtoD (Device -> Device)", "rx.pll_lanes", "cudaMemcpyAsync"),
        ("k_tail", "graph.replay", "cudaLaunchKernel"),
        ("k_out", "outer.call", "cudaLaunchKernel"),
        ("k_free", None, "cudaLaunchKernel"), ("k_lost", None, None)]
    # the caller's prefix left out: its range names nothing, and its
    # annotation counts as a device event
    got = [(e.name, s) for e, s, _ in profiling.device_spans(events)]
    assert ("k_out", None) in got and ("outer.call", "rx.front") in got


def test_spans_nest_and_switch_back_when_the_block_raises():
    with pytest.raises(ValueError):
        with profiling.spans():
            with profiling.spans():
                assert profiling._on
            assert profiling._on
            raise ValueError
    assert not profiling._on
    assert profiling.span("rx.nco") is profiling.span("graph.load")


# ---- on the card ----

def _copy(name: str) -> bool:
    return name.lower().startswith(("memcpy", "memset"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 2])
def test_span_map_names_a_replay_on_the_card(mode):
    """C=64, a chunk of 2 whole blocks: one replay's device events equal
    ``span_map``'s one for one, each under a program span.  A graph may
    run a copy node as CUDA's own copy kernel (``memcpy32_post``) where
    the eager run has ``Memcpy DtoD``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, params, state = _setup(mode, "cuda", 64)
    iq = fm.stereo_rds_broadcast(cfg, 2).reshape(2, 1, cfg.block_size)
    blocks = torch.from_numpy(np.repeat(iq, 64, axis=1).copy()).cuda()
    runner = graph.receiver_runner(params, state, cfg)
    for _ in range(2):
        runner.run(blocks)
    span_map = runner.span_map(blocks)
    assert span_map and all(profiling.is_span(s) for _, s in span_map)
    events = _profiled(lambda: runner.run(blocks), cuda=True)
    replayed = [e.name for e, _, call in profiling.device_spans(events)
                if call is not None and "GraphLaunch" in call]
    assert len(replayed) == len(span_map)
    for i, (got, (want, _)) in enumerate(zip(replayed, span_map)):
        assert got == want or (_copy(got) and _copy(want)
                               and got[:6].lower() == want[:6].lower()), (
            i, got, want)

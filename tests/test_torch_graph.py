"""The compiled step (dy4tpu_torch.pipeline.graph) on the CPU: the chunk
runner's buffer and state plumbing against the eager receiver, its graph
cache, the constant caches that keep the step free of host copies, and a
checkpoint taken from the runner.

On a CPU state the runner runs its chunk body eagerly on the same static
buffers a captured graph reads on the card, so ``graph.run_blocks`` at
chunks of 1, 2 and 3 blocks (the last two leave a ragged last chunk over
5 blocks) must give outputs and an end state bitwise equal to
``receiver.run_blocks``.  Modes 0-3 here; the IF entry, the IQ tracker,
the span PLL, the envelope CDR and the CLI's chunk body in
tests/test_torch_graph_options.py; the sync audit and dy4tpu in
tests/test_torch_graph_sync.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu_torch.ops import pll  # noqa: E402
from dy4tpu_torch.pipeline import graph  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.runtime import consts  # noqa: E402
from dy4tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from torch_graph_cases import (DEV, KS, N_BLOCKS, Case,  # noqa: E402
                               assert_tree_equal)

MODES = ("mode0", "mode1", "mode2", "mode3")


@pytest.fixture(scope="module", params=MODES)
def case(request):
    c = Case(request.param)
    c.reference = c.eager()
    return c


@pytest.mark.parametrize("k", KS)
def test_runner_equals_eager_run_blocks(case, k):
    state, outs = graph.run_blocks(case.params, case.state(),
                                   case.inputs[0], case.cfg, chunk=k,
                                   **case.kw)
    want_state, want_outs = case.reference
    assert_tree_equal(outs, want_outs, f"{case.name} chunk {k} outputs")
    assert_tree_equal(state, want_state, f"{case.name} chunk {k} state")


def test_checkpoint_from_the_runner_resumes_bit_for_bit(tmp_path):
    """A checkpoint read from the runner after 2 blocks, through disk,
    resumed by a second runner over the last 3 blocks, equals the
    uninterrupted eager run."""
    case = Case("mode0")
    blocks = case.inputs[0]
    runner = graph.receiver_runner(case.params, case.state(), case.cfg)
    first = runner.run(blocks[:2])
    ckpt.save(str(tmp_path / "rx.ckpt"), runner.read(),
              meta={"block": 2})
    live = runner.run(blocks[2:])
    resumed_state, _, meta = ckpt.load(str(tmp_path / "rx.ckpt"),
                                       case.state())
    assert meta["block"] == 2
    twin = graph.receiver_runner(case.params, resumed_state, case.cfg)
    again = twin.run(blocks[2:])
    want_state, want = case.eager()
    assert_tree_equal(again, live, "resumed twin against the live runner")
    assert_tree_equal(twin.read(), runner.read(), "end state")
    assert_tree_equal(twin.read(), want_state, "end state against eager")
    for f in rx.StepOutputs._fields:
        got = getattr(first, f)
        if got is not None:
            assert torch.equal(torch.cat([got, getattr(live, f)]),
                               getattr(want, f)), f


def test_load_and_read_copy_the_state():
    """``load`` copies into the static carry and ``read`` returns clones:
    neither aliases the caller's tensors."""
    case = Case("mode1")
    st = case.state()
    runner = graph.receiver_runner(case.params, st, case.cfg)
    got = runner.read()
    assert_tree_equal(got, st, "read after construction")
    leaves = graph._leaves(runner.carry)
    ptrs = {t.untyped_storage().data_ptr() for t in leaves}
    assert len(ptrs) == len(leaves), "static carry leaves share memory"
    for t in graph._leaves(got) + graph._leaves(st):
        assert t.untyped_storage().data_ptr() not in ptrs
    other = rx.init_state(case.cfg, (st.rf.prev_i.shape[0],), device=DEV)
    other.rf.prev_i.fill_(3.0)
    runner.load(other)
    assert torch.equal(runner.carry.rf.prev_i, other.rf.prev_i)
    with pytest.raises(ValueError):
        runner.load(rx.init_state(case.cfg, (2,), device=DEV))


# ---- the graph cache ----

def _toy_runner():
    def step(carry, x):
        (acc,) = carry
        return (acc + x.sum(dim=-1),), (x * 2.0, acc)
    return graph.ChunkRunner(step, (torch.zeros(2),), key=("toy",))


def test_graph_cache_reuses_a_key_and_evicts_past_the_bound():
    runner = _toy_runner()
    x = torch.arange(40, dtype=torch.float32).reshape(10, 2, 2)

    def cached(k):
        return runner.graph_key((x[:k],)) in runner._graphs

    runner.run(x[:2])
    entry = runner._graphs[runner.graph_key((x[:2],))]
    runner.run(x[2:4])                     # same key: the same buffers
    assert len(runner._graphs) == 1
    assert runner._graphs[runner.graph_key((x[:2],))] is entry
    more = range(3, 2 + graph.MAX_GRAPHS)  # fill the bound
    for k in more:
        runner.run(x[:k])
    assert len(runner._graphs) == graph.MAX_GRAPHS and cached(2)
    runner.run(x[:1])                      # one more key: past the bound
    assert len(runner._graphs) == graph.MAX_GRAPHS
    assert not cached(2)                   # the oldest went first
    assert cached(1) and cached(3)
    # the carry advanced by every block run
    want = (x[:4].sum((0, 2)) + sum(x[:k].sum((0, 2)) for k in more)
            + x[0].sum(-1))
    assert torch.equal(runner.carry[0], want)
    # bound inputs are keyed by their addresses too
    y = x[:3].clone()
    runner.run(y, bind=True)
    assert runner.graph_key((y,), bind=True) in runner._graphs
    assert runner._graphs[runner.graph_key((y,), bind=True)].inputs[0] is y


def test_graph_key_holds_entry_mode_options_k_and_shapes():
    case = Case("mode0")
    runner = graph.receiver_runner(case.params, case.state(), case.cfg,
                                   cdr_timing="envelope", pll_span=8)
    blocks = case.inputs[0]
    key = runner.graph_key((blocks[:2],))
    assert key[:2] == ("rf", 0)
    assert ("cdr_timing", "'envelope'") in key and ("pll_span", "8") in key
    assert 2 in key and ((tuple(blocks[:2].shape), torch.uint8),) in key
    assert runner.graph_key((blocks[:2],)) != runner.graph_key((blocks[:3],))
    assert runner.graph_key((blocks[:2],), bind=True)[-1] == (
        blocks[:2].data_ptr(),)
    with pytest.raises(ValueError):
        graph.receiver_runner(case.params, case.state(), case.cfg,
                              entry="wideband")


def test_run_blocks_keeps_a_bounded_set_of_runners():
    graph.clear()
    case = Case("mode0")
    blocks = case.inputs[0][:1]
    for _ in range(graph.MAX_RUNNERS + 2):
        params = rx.make_params(case.cfg, device=DEV)
        graph.run_blocks(params, case.state(), blocks, case.cfg,
                         pll_span=8)
    assert len(graph._RUNNERS) == graph.MAX_RUNNERS
    graph.clear()
    assert not graph._RUNNERS


def test_counters_cover_every_kernel_wrapper():
    """Every launch counter of the ops modules is one the runner carries
    over replays."""
    import importlib
    import pkgutil

    import dy4tpu_torch.ops as ops_pkg
    from dy4tpu_torch.runtime import kernels

    held = {id(w) for w in graph.counters()}
    found = []
    for info in pkgutil.iter_modules(ops_pkg.__path__):
        mod = importlib.import_module(f"dy4tpu_torch.ops.{info.name}")
        for obj in vars(mod).values():
            if callable(obj) and hasattr(obj, "launches"):
                found.append(obj)
                found += [v for v in vars(obj).values()
                          if isinstance(v, kernels.Variant)]
    assert len(found) >= 16
    assert all(id(w) in held for w in found), [
        w.__name__ for w in found if id(w) not in held]


# ---- the constant caches ----

def test_loop_constants_are_bitwise_the_host_values_once_a_device():
    freq = np.array([19e3, 114e3], np.float32)
    bw = np.array([0.01, 0.001], np.float32)
    host = pll._loop_consts(freq, 240e3, bw)
    scale = np.array([2.0, 0.5], np.float32)
    got = pll.device_consts("cpu", *host, scale)
    for g, h in zip(got, (*host, scale)):
        want = torch.as_tensor(h, device="cpu")
        assert g.dtype == want.dtype == torch.float32
        assert torch.equal(g, want)
    assert pll.device_consts("cpu", *host, scale) is got   # a hit
    k, *eff = pll._span_consts(*host, 8)
    span = pll.device_consts("cpu", *eff)
    for g, h in zip(span, eff):
        assert torch.equal(g, torch.as_tensor(h))
    # keyed by device: the meta device gets tensors of its own
    meta = pll.device_consts("meta", *host, scale)
    assert meta is not got and all(t.device.type == "meta" for t in meta)


def test_constant_caches_are_bounded():
    n0 = len(pll._CONSTS)
    for i in range(pll._CONSTS.maxsize + 8):
        pll.device_consts("cpu", np.float32(1.0 + i * 1e-3))
    assert len(pll._CONSTS) == pll._CONSTS.maxsize >= n0
    small = consts.ConstCache(3)
    made = []
    for i in range(5):
        small.get(i, lambda i=i: made.append(i) or (torch.zeros(i),))
    assert len(small) == 3 and 0 not in small and 1 not in small
    small.get(2, lambda: pytest.fail("a hit must not make"))
    small.get(5, lambda: (torch.ones(1),))
    assert 3 not in small and 2 in small       # 2 was used last
    with pytest.raises(ValueError):
        consts.ConstCache(0)


def test_hold_keeps_what_the_caches_hand_out():
    small = consts.ConstCache(1)
    with consts.hold() as held:
        a = small.get("a", lambda: (torch.zeros(2),))
        small.get("b", lambda: (torch.ones(2),))   # evicts "a"
    assert "a" not in small
    assert held[0] is a and len(held) == 2
    small.get("c", lambda: (torch.ones(2),))
    assert len(held) == 2                       # outside the block


def test_envelope_tables_are_bitwise_the_host_tables():
    n, sps = 1216, 27
    w = 2.0 * np.pi * np.arange(n) / sps
    cos, sin = rx._envelope_tables(n, sps, torch.float32,
                                   torch.device("cpu"))
    assert torch.equal(cos, torch.as_tensor(np.cos(w), dtype=torch.float32))
    assert torch.equal(sin, torch.as_tensor(np.sin(w), dtype=torch.float32))
    assert rx._envelope_tables(n, sps, torch.float32,
                               torch.device("cpu"))[0] is cos
    assert rx._ENVELOPE_TABLES.maxsize == 8


def test_n_blocks_leaves_ragged_tails():
    assert N_BLOCKS % 2 and N_BLOCKS % 3

"""The sharded step's chunk runner on the CPU (``graph.sharded_runner``,
the runner's eager body, the counterpart of dy4tpu's jitted ``step_c``
with its donated carry) on a 1x1 mesh: bit for bit the eager
``ShardedReceiver.step`` for the exact and the legacy disciplines, a
checkpoint resumed through ``read`` / ``load``, held to dy4tpu's
un-jitted receiver, the runner's key, and the sync audit of a warm step.
The ranks of a mesh with a time axis run the runner in
tests/test_torch_sharded_dist.py.

Streams: the bench broadcast with noise 0.05 (tests/test_torch_sharded.py's),
channel c from byte 74*c on; C=2 channels, shard_blocks=2, 3 steps; mode 0
with the auto sub-block halo (exact) and a one-block halo (legacy), mode
1 (no RDS, one PLL lane).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode as jget_mode  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.parallel import ShardedReceiver, make_mesh  # noqa: E402
from dy4tpu_torch.parallel.mesh import Mesh  # noqa: E402
from dy4tpu_torch.pipeline import convert, graph  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402
from torch_graph_cases import DEV, assert_tree_equal, audited  # noqa: E402

SHIFT = 74
C, S, STEPS = 2, 2, 3

# name -> (mode, exact, overlap_blocks: None the auto sub-block halo)
CASES = {
    "mode0_exact": (0, True, None),
    "mode0_legacy": (0, False, 1),
    "mode1_exact": (1, True, None),
}


@functools.lru_cache(maxsize=None)
def _streams(mode: int) -> np.ndarray:
    """[C, STEPS * S * block_size] u8."""
    cfg = get_mode(mode)
    flat = fm.stereo_rds_broadcast(cfg, STEPS * S + 1, noise=0.05,
                                   seed=mode).ravel()
    n = STEPS * S * cfg.block_size
    return np.stack([flat[SHIFT * c:SHIFT * c + n] for c in range(C)])


class SCase:
    """One case: its receiver, params, the steps' input pieces [STEPS, C,
    S*bs], and the eager step loop's outputs and end carry (once)."""

    _eager: dict = {}

    def __init__(self, name: str):
        mode, exact, overlap = CASES[name]
        self.name = name
        self.cfg = get_mode(mode)
        self.params = rx.make_params(self.cfg, device=DEV)
        self.r = ShardedReceiver(self.cfg, make_mesh(devices=[DEV]),
                                 shard_blocks=S, overlap_blocks=overlap,
                                 exact=exact)
        iq = torch.from_numpy(_streams(mode))
        n = self.r.chunk_len
        self.inputs = torch.stack([self.r.input_sharding(
            iq[:, k * n:(k + 1) * n]) for k in range(STEPS)])

    def eager(self):
        if self.name not in self._eager:
            carry, outs = self.r.init(C), []
            for piece in self.inputs:
                carry, out = self.r.step(self.params, carry, piece)
                outs.append(out)
            self._eager[self.name] = carry, graph._stack(outs)
        return self._eager[self.name]

    def runner(self):
        return graph.sharded_runner(self.r, self.params, self.r.init(C))


_GRAPHED: dict = {}


def _graphed(name: str):
    """The runner's outputs over every step at K=1 (dy4tpu's one compiled
    step) and its end carry."""
    if name not in _GRAPHED:
        runner = SCase(name).runner()
        outs = runner.run_stream(SCase(name).inputs, chunk=1)
        _GRAPHED[name] = runner.read(), outs
    return _GRAPHED[name]


@pytest.mark.parametrize("name", list(CASES))
def test_runner_equals_eager_step(name):
    case = SCase(name)
    ref_carry, ref = case.eager()
    carry, outs = _graphed(name)
    assert outs.mono.shape == (STEPS, C, S * case.cfg.audio_per_block)
    assert (outs.rds_symbols is None) == (not case.cfg.supports_rds)
    assert_tree_equal(outs, ref, f"{name} outputs")
    assert_tree_equal(carry, ref_carry, f"{name} carry")


def test_checkpoint_resumes_bit_for_bit():
    """Step 0 through one runner, its carry read out and loaded into a new
    runner, which runs steps 1-2 as one chunk of K=2 (one graph on the
    card): the outputs and end carry of the uninterrupted eager loop."""
    case = SCase("mode0_exact")
    ref_carry, ref = case.eager()
    first = case.runner()
    head = first.run(case.inputs[:1])
    assert_tree_equal(head, graph._map(lambda t: t[:1], ref), "head")
    second = case.runner()
    second.load(first.read())
    tail = second.run(case.inputs[1:])
    assert_tree_equal(tail, graph._map(lambda t: t[1:], ref), "tail")
    assert_tree_equal(second.read(), ref_carry, "resumed carry")


def test_runner_matches_dy4tpu_unjitted():
    """The runner's mode-0 exact run against dy4tpu's un-jitted
    ``receiver_step`` over the same 6 blocks (the sequential receiver the
    exact discipline equals): tests/test_torch_sharded.py's bars, floats
    to 1e-4, RDS decisions exact."""
    cfg = jget_mode(0)
    iq = _streams(0)
    jp = jrx.make_params(cfg)
    js = jrx.init_state(cfg, batch=(C,))
    outs = []
    for b in range(STEPS * S):
        blk = iq[:, b * cfg.block_size:(b + 1) * cfg.block_size]
        js, jo = jrx.receiver_step(jp, js, jnp.asarray(blk), cfg)
        outs.append(jax.tree.map(np.asarray, jo))
    _, got = _graphed("mode0_exact")

    def stream(x):      # [STEPS, C, S*n] -> [C, STEPS*S*n]
        return x.movedim(0, -2).reshape(C, -1).numpy()

    for f in ("mono", "left", "right"):
        want = np.stack([getattr(o, f) for o in outs])   # [B, C, n]
        np.testing.assert_allclose(
            stream(getattr(got, f)),
            np.moveaxis(want, 0, -2).reshape(C, -1), atol=1e-4, err_msg=f)
    want = np.stack([o.rds_symbols for o in outs])
    np.testing.assert_array_equal(stream(got.rds_symbols),
                                  np.moveaxis(want, 0, -2).reshape(C, -1))
    for f in ("rds_resync", "rds_offset"):
        want = np.stack([getattr(o, f) for o in outs], -1)   # [C, B]
        np.testing.assert_array_equal(
            getattr(got, f).movedim(0, -2).reshape(C, -1).numpy(), want,
            err_msg=f)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "legacy"])
def test_runner_key_names_the_step(exact):
    """A graph's key holds the discipline, the mesh, the geometry and the
    mode; a mesh with a time axis captures in ``thread_local`` error
    mode (its collectives' watchdog thread queries events meanwhile)."""
    cfg = get_mode(0)
    for time_axis, mode in ((1, "global"), (4, "thread_local")):
        mesh = Mesh(ch=1, time=time_axis, ch_index=0, time_index=0,
                    device=DEV)
        r = ShardedReceiver(cfg, mesh, shard_blocks=S, exact=exact,
                            overlap_blocks=None if exact else 1)
        runner = graph.sharded_runner(r, rx.make_params(cfg, device=DEV),
                                      r.init(C))
        assert runner.capture_error_mode == mode
        key = dict(k for k in runner.key if isinstance(k, tuple))
        assert runner.key[:2] == ("sharded", 0)
        assert key == {"exact": exact,
                       "mesh": (("ch", 1), ("time", time_axis)),
                       "shard_blocks": S, "halo_if": r.halo_if,
                       "stereo": True, "channel_parallel_replay": True,
                       "precision": "highest"}
        assert not runner.on_card


def test_exact_carry_from_dy4tpu_loads_into_the_runner():
    """dy4tpu's 1x1 init ``ExactCarry`` converted by field path loads into
    the runner's static carry, which then reads back the same leaves."""
    from dy4tpu.parallel import ShardedReceiver as JShardedReceiver
    from dy4tpu.parallel import make_mesh as jmake_mesh
    case = SCase("mode0_exact")
    theirs = JShardedReceiver(jget_mode(0), jmake_mesh(1, 1),
                              shard_blocks=S).init(C)
    runner = case.runner()
    runner.load(convert.exact_carry_from_numpy(theirs, device=DEV))
    ours, ref = (convert.leaves_by_path(runner.read()),
                 convert.leaves_by_path(theirs))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_warm_sharded_step_makes_no_host_copy_or_read(monkeypatch):
    case = SCase("mode0_exact")
    runner = case.runner()
    runner.run(case.inputs[:1])
    second = case.inputs[1:2]
    audited(monkeypatch, lambda: runner.run(second))

"""The third traced pass's labelling (``rxbench/spans.py``): a replay's
device events named place for place by ``ChunkRunner.span_map`` on
made-up events, and raising where the two part; the event kinds, the
wrappers each roofline file maps and the pass's arithmetic; and on the
card (``cuda``) one replay labelled, its glue all under a program span
and each roofline file's traced launches equal to its wrappers'
counts."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from torch.autograd import DeviceType  # noqa: E402

from rxbench import spans as bench_spans  # noqa: E402
from rxbench import spec  # noqa: E402


def _dev(name, t0, ident):
    return SimpleNamespace(name=name, id=ident, device_type=DeviceType.CUDA,
                           time_range=SimpleNamespace(start=t0, end=t0 + 1))


def _replay(names, ident, t0=300):
    return [(_dev(n, t0 + i, ident), "graph.replay", "cudaGraphLaunch")
            for i, n in enumerate(names)]


def test_a_replay_takes_its_capture_spans_place_for_place():
    span_map = [("k_a", "rx.front"), ("Memset (Device)", "graph.assign"),
                ("Memcpy DtoD (Device -> Device)", "graph.assign"),
                ("k_b", "rx.cdr")]
    land = (_dev("Memcpy DtoH (Device -> Pinned)", 1, 7), "rxbench.land",
            "cudaMemcpyAsync")
    names = [n for n, _ in span_map]
    # a graph may run its copy nodes as CUDA's own copy kernels
    graphed = ["k_a", "Memset (Device)", "memcpy32_post", "k_b"]
    got = bench_spans.label([land, *_replay(names, 1), *_replay(graphed, 2)],
                            span_map)
    assert [(e.name, s, r) for e, s, r in got] == [
        (land[0].name, "rxbench.land", False),
        *[(n, s, True) for n, s in span_map],
        *[(n, s, True) for n, (_, s) in zip(graphed, span_map)]]


@pytest.mark.parametrize("names,at", [(["k_a", "k_x", "k_b"], 1),
                                      (["k_a"], 1),
                                      (["k_a", "k_b", "memcpy128"], 2)])
def test_a_replay_unlike_its_capture_raises_where_they_part(names, at):
    span_map = [("k_a", "rx.front"), ("k_b", "rx.back"), ("k_c", "rx.cdr")]
    with pytest.raises(RuntimeError, match=f"first differ at {at}"):
        bench_spans.label(_replay(names, 1), span_map)


def test_kinds_and_the_pass_arithmetic():
    from dy4tpu_torch.pipeline import graph

    roofs = spec.rooflines()
    assert bench_spans.kind_of("void frontend_full_kernel<true>(x)",
                               roofs) == "b1_frontend"
    assert bench_spans.kind_of("Memset (Device)", roofs) == "copy"
    assert bench_spans.kind_of("at::native::vectorized_elementwise_kernel",
                               roofs) == "glue"
    assert set(bench_spans.WRAPPERS) == set(roofs)
    names = {w.__name__ for w in graph.counters()}
    assert {n for ws in bench_spans.WRAPPERS.values() for n in ws} <= names
    s = bench_spans.Spans(
        blocks=4, chunks=2,
        device={("glue", "rx.nco", True): 0.004,
                ("glue", "graph.stack", True): 0.002,
                ("copy", "graph.input", False): 0.008,
                ("copy", "graph.assign", True): 0.001},
        host={"graph.lookup": 0.002, "graph.load": 0.001})
    assert s.device_ms("glue", ("rx.nco",)) == pytest.approx(1.0)
    assert s.device_ms("glue") == pytest.approx(1.5)
    assert s.device_ms("copy", replayed=True) == pytest.approx(0.25)
    assert s.host_ms("graph.lookup", "graph.load") == pytest.approx(1.5)
    assert s.host_ms("graph.read") == 0.0


def test_an_untraced_run_has_no_pass_and_reads_nothing():
    from rxbench import measure

    run = measure.Run(bench=None, window=None, setup_s=0.0,
                      window_peak_bytes=0, device_name="cpu")
    assert bench_spans.of(run) is None and bench_spans.of(run) is None
    for m in spec.benchmark()["per_layer"]:
        path = spec.HERE / "metrics" / f"{m['name']}.py"
        if "spans.of(run)" in path.read_text():
            assert spec.metric_reader(m["name"]).read(run) is None, m["name"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 2])
def test_a_replay_labelled_on_the_card(card, mode):
    """C=64, a chunk of 2 whole blocks: every replayed kernel is a
    roofline file's or glue under a program span, and each file's traced
    launches equal its wrappers' counts."""
    from torch.profiler import ProfilerActivity, profile

    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.pipeline import graph
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.tx import fm
    from dy4tpu_torch.utils import profiling

    cfg = get_mode(mode)
    params = rx.make_params(cfg, device=card)
    state = rx.init_state(cfg, (64,), device=card)
    iq = fm.stereo_rds_broadcast(cfg, 2).reshape(2, 1, cfg.block_size)
    blocks = torch.from_numpy(np.repeat(iq, 64, axis=1).copy()).to(card)
    runner = graph.receiver_runner(params, state, cfg)
    for _ in range(2):
        runner.run(blocks)
    span_map = runner.span_map(blocks)
    wrappers = graph.counters()
    before = [w.launches for w in wrappers]
    with profiling.spans(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiling.settle(card)
        runner.run(blocks)
        profiling.settle(card)
    launched = {w.__name__: w.launches - n for w, n in zip(wrappers, before)}
    labelled = bench_spans.label(
        profiling.device_spans(prof.events(), bench_spans.PREFIXES), span_map)
    replayed = [(e, s) for e, s, r in labelled if r]
    assert len(replayed) == len(span_map)
    roofs = spec.rooflines()
    kinds = [bench_spans.kind_of(e.name, roofs) for e, _ in replayed]
    unnamed = [e.name for (e, s), k in zip(replayed, kinds)
               if k == "glue" and not profiling.is_span(s)]
    assert not unnamed
    for r, names in bench_spans.WRAPPERS.items():
        assert kinds.count(r) == sum(launched[n] for n in names), r
    assert kinds.count("b1_frontend") == 2

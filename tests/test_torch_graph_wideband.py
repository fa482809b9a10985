"""The wideband step's chunk runner on the CPU (``graph.wideband_runner``,
``graph.run_wideband_blocks``, the runner's eager body): bit for bit the
eager ``wideband.run_wideband_blocks``, a checkpoint resumed through
``read`` / ``load``, the runner cache's bound, and the sync audit of a
warm step.  dy4tpu's side is in tests/test_torch_graph_wideband_dy4tpu.py.

C=4 channels x 2 bands x T=12 taps a branch over 5 steps, so that chunks
of 2 and of 3 both leave a ragged last chunk: every channel carries a
station, band 1 is band 0's capture 37 complex samples later through a
tuner fault (gain 1.2, 8 degrees, DC 0.03 / -0.02), and channel 1 alone
carries RDS, as in tests/test_torch_wideband.py.  Configurations: mode 0
on the default route, with AFC and the wideband IQ tracker, with
``with_rds=False``, and mode 1.  On the card ``chip_smoke.py`` phase 11
runs the same through the captured graphs.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.ops import iqcorr  # noqa: E402
from dy4tpu_torch.pipeline import graph  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.pipeline import wideband as wb  # noqa: E402
from dy4tpu_torch.rds import coding  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402
from torch_graph_cases import DEV, assert_tree_equal, audited  # noqa: E402

C, BANDS, STEPS, T = 4, 2, 5, 12
SHIFT = 74                      # bytes between band 0 and band 1
FAULT = dict(gain=1.2, phase_deg=8.0, dc_i=0.03, dc_q=-0.02)
KS = (2, 3)

# name -> (mode, wideband_init keywords, step keywords)
CONFIGS = {
    "default": (0, {}, {}),
    "afc_tracker": (0, dict(afc=True, iqcorr=True), {}),
    "no_rds": (0, dict(with_rds=False), dict(with_rds=False)),
    "mode1": (1, {}, {}),
}


def _impair_u8(u8):
    """The tuner fault on an interleaved u8 capture, re-quantized."""
    x = (u8.astype(np.float64) - 128.0) / 128.0
    i, q = iqcorr.impair(x[0::2], x[1::2], **FAULT)
    out = np.empty_like(x)
    out[0::2], out[1::2] = i, q
    return np.clip(np.round(out * 128.0 + 128.0), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def wideband_blocks(mode: int, empty: bool = False) -> torch.Tensor:
    """[STEPS, BANDS, 2*C*if_per_block] u8: a station on every channel,
    channel 1's with RDS (PI 0x5401) where the mode carries it, band 1
    faulted.  With ``empty`` channel 1 alone carries its station and the
    others only the capture's noise, as most channels of a real band."""
    cfg = get_mode(mode)
    n = STEPS + 1
    n_audio = n * cfg.audio_per_block
    tone = lambda f: fm.tone(f, cfg.audio_fs, n_audio, amp=0.7)  # noqa: E731
    stations = {c: dict(left=tone(600.0 + 200.0 * c),
                        right=tone(2400.0 - 300.0 * c)) for c in range(C)}
    if cfg.supports_rds:
        stations[1]["rds_bits"] = coding.make_ps_bitstream(
            0x5401, 10, "WB CH-01", repeats=4)
    if empty:
        stations = {1: stations[1]}
    cap = fm.synthesize_wideband(cfg, C, n, stations=stations, noise=0.01,
                                 seed=3)
    step = 2 * C * cfg.if_per_block
    band1 = _impair_u8(cap)[SHIFT:SHIFT + STEPS * step]
    return torch.from_numpy(np.stack(
        [cap[:STEPS * step].reshape(STEPS, step),
         band1.reshape(STEPS, step)], axis=1).copy())


class WCase:
    """One configuration: params, bank, initial state, blocks, keywords,
    and its eager reference (computed once)."""

    _eager: dict = {}

    def __init__(self, name: str):
        mode, self.init_kw, self.kw = CONFIGS[name]
        self.name = name
        self.cfg = get_mode(mode)
        self.params, self.chan = _params(mode)
        self.blocks = wideband_blocks(mode)

    def state(self):
        return wb.wideband_init(self.cfg, self.chan, (BANDS,),
                                **self.init_kw)

    def eager(self):
        if self.name not in self._eager:
            self._eager[self.name] = wb.run_wideband_blocks(
                self.params, self.chan, self.state(), self.blocks, self.cfg,
                **self.kw)
        return self._eager[self.name]


@functools.lru_cache(maxsize=None)
def _params(mode: int):
    cfg = get_mode(mode)
    return (rx.make_params(cfg, device=DEV),
            wb.make_wideband(cfg, C, taps_per_branch=T, device=DEV))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_equals_eager_run_wideband_blocks(name, k):
    case = WCase(name)
    ref_state, ref = case.eager()
    state, outs = graph.run_wideband_blocks(case.params, case.chan,
                                            case.state(), case.blocks,
                                            case.cfg, chunk=k, **case.kw)
    assert outs.rx.mono.shape == (STEPS, BANDS, C,
                                  case.cfg.audio_per_block)
    assert (outs.rx.rds_symbols is None) == (
        not case.cfg.supports_rds or name == "no_rds")
    assert_tree_equal(outs, ref, f"{name} chunk {k} outputs")
    assert_tree_equal(state, ref_state, f"{name} chunk {k} state")


def test_checkpoint_resumes_bit_for_bit():
    """Steps 0-1 through one runner, its carry read out (the checkpoint)
    and loaded into a new runner, which runs steps 2-4 in a chunk of 3:
    outputs and end state equal the uninterrupted eager run's."""
    case = WCase("afc_tracker")
    ref_state, ref = case.eager()
    first = graph.wideband_runner(case.params, case.chan, case.state(),
                                  case.cfg, **case.kw)
    head = first.run_stream(case.blocks[:2], chunk=2)
    ckpt = first.read()
    second = graph.wideband_runner(case.params, case.chan, case.state(),
                                   case.cfg, **case.kw)
    second.load(ckpt)
    tail = second.run_stream(case.blocks[2:], chunk=3)
    assert_tree_equal(head, graph._map(lambda t: t[:2], ref), "head")
    assert_tree_equal(tail, graph._map(lambda t: t[2:], ref), "tail")
    assert_tree_equal(second.read(), ref_state, "resumed state")


def test_runner_cache_is_bounded_and_holds_its_bank():
    """``run_wideband_blocks`` keeps the last ``MAX_RUNNERS`` runners (in
    the cache it shares with ``run_blocks``), each holding the params and
    bank its key names by ``id``; a hit reuses the runner with the new
    state loaded."""
    case = WCase("default")
    graph.clear()
    banks = [wb.make_wideband(case.cfg, C, taps_per_branch=T, device=DEV)
             for _ in range(graph.MAX_RUNNERS + 1)]
    one = case.blocks[:1]
    for chan in banks:
        graph.run_wideband_blocks(case.params, chan, case.state(), one,
                                  case.cfg, chunk=1)
    assert len(graph._RUNNERS) == graph.MAX_RUNNERS
    held = [hit[0][1] for hit in graph._RUNNERS.values()]
    assert all(a is b for a, b in zip(held, banks[1:], strict=True))
    runner = next(reversed(graph._RUNNERS.values()))[1]
    st, out = graph.run_wideband_blocks(case.params, banks[-1], case.state(),
                                        one, case.cfg, chunk=1)
    assert next(reversed(graph._RUNNERS.values()))[1] is runner
    ref_state, ref = wb.run_wideband_blocks(case.params, banks[-1],
                                            case.state(), one, case.cfg)
    assert_tree_equal(out, ref, "cache hit outputs")
    assert_tree_equal(st, ref_state, "cache hit state")
    graph.clear()
    assert not graph._RUNNERS


def test_warm_wideband_step_makes_no_host_copy_or_read(monkeypatch):
    """One warm chunk of the plain channelizer route with the tracker on
    (the route that applies the correction after the bank through the
    channel mirror index) and AFC: no host copy, no host read."""
    case = WCase("afc_tracker")
    runner = graph.wideband_runner(case.params, case.chan, case.state(),
                                   case.cfg, channelizer="plain")
    runner.run(case.blocks[:1])
    second = case.blocks[1:2]
    audited(monkeypatch, lambda: runner.run(second))

"""Helper of the port's chunk-runner tests (tests/test_torch_graph*.py):
the receiver configurations the compiled step covers, their captures at
a small size, the eager reference, bitwise comparisons and the sync
audit (``audited``).

C=3 channels (the bench broadcast, the same with I/Q swapped, and the
broadcast from 74 bytes in) over N_BLOCKS=5 blocks, so that chunks of 2
and of 3 both leave a ragged last chunk.
"""

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dy4tpu_torch.config import get_mode
from dy4tpu_torch.ops import frontend_cuda
from dy4tpu_torch.pipeline import receiver as rx
from dy4tpu_torch.tx import fm

DEV = "cpu"   # the port's entry points default to the card
C = 3
N_BLOCKS = 5
SHIFT = 74
KS = (1, 2, 3)
# test_iqcorr.py's tuner fault
FAULT = dict(dc_i=0.12, dc_q=-0.08, iq_gain=0.7, iq_phase_deg=25.0)

# name -> (mode, entry, init_state keywords, capture fault, step keywords)
CONFIGS = {
    "mode0": (0, "rf", {}, {}, {}),
    "mode1": (1, "rf", {}, {}, {}),
    "mode2": (2, "rf", {}, {}, {}),
    "mode3": (3, "rf", {}, {}, {}),
    "if_mode0": (0, "if", {}, {}, {}),
    "tracker": (0, "rf", dict(with_iqcorr=True), FAULT, {}),
    "span8": (0, "rf", {}, {}, dict(pll_span=8)),
    "span8_kernel_emit": (0, "rf", {}, {}, dict(pll_span=8,
                                                pll_span_emit="kernel")),
    "envelope_mode2": (2, "rf", {}, {}, dict(cdr_timing="envelope")),
}


def _swap_iq(iq):
    return iq.reshape(*iq.shape[:-1], -1, 2)[..., ::-1].reshape(iq.shape)


@functools.lru_cache(maxsize=None)
def blocks_of(mode: int, fault: tuple = ()) -> torch.Tensor:
    """[N_BLOCKS, C, block_size] u8 of the bench broadcast (through
    ``fault``), three distinct rows."""
    cfg = get_mode(mode)
    iq = fm.stereo_rds_broadcast(cfg, N_BLOCKS + 1, **dict(fault)).ravel()
    n = N_BLOCKS * cfg.block_size
    rows = [iq[:n], _swap_iq(iq[:n]), iq[SHIFT:SHIFT + n]]
    return torch.from_numpy(np.stack(rows, axis=1).reshape(
        N_BLOCKS, C, cfg.block_size).copy())


def if_blocks(params, cfg, blocks):
    """The IF I/Q of ``blocks`` by the plain RF LPF, its tail carried:
    two [N, C, if_per_block] float32 tensors."""
    tail = torch.zeros(blocks.shape[1], 2, cfg.num_taps - 1)
    i_if, q_if = [], []
    for blk in blocks:
        i, q, tail = frontend_cuda.rf_lpf_plain(blk, params.rf_coeff, tail,
                                                cfg.rf_decim)
        i_if.append(i)
        q_if.append(q)
    return torch.stack(i_if), torch.stack(q_if)


class Case:
    """One configuration: its mode, params, initial state, inputs and
    step keywords."""

    def __init__(self, name: str):
        mode, self.entry, init_kw, fault, self.kw = CONFIGS[name]
        self.name = name
        self.cfg = get_mode(mode)
        self.params = rx.make_params(self.cfg, device=DEV)
        self.init_kw = init_kw
        blocks = blocks_of(mode, tuple(sorted(fault.items())))
        self.inputs = ((blocks,) if self.entry == "rf"
                       else if_blocks(self.params, self.cfg, blocks))

    def state(self):
        return rx.init_state(self.cfg, (C,), device=DEV, **self.init_kw)

    def eager(self, state=None, lo: int = 0, hi: int = N_BLOCKS):
        """The eager reference over blocks [lo, hi): ``receiver.run_blocks``
        (the RF entry) or a loop of ``receiver_step_if``."""
        state = self.state() if state is None else state
        ins = tuple(t[lo:hi] for t in self.inputs)
        if self.entry == "rf":
            return rx.run_blocks(self.params, state, ins[0], self.cfg,
                                 **self.kw)
        outs = []
        for i_if, q_if in zip(*ins):
            state, out = rx.receiver_step_if(self.params, state, i_if, q_if,
                                             self.cfg, **self.kw)
            outs.append(out)
        return state, rx.StepOutputs(*(None if f[0] is None
                                       else torch.stack(f)
                                       for f in zip(*outs)))


def assert_tree_equal(got, want, label: str) -> None:
    """Two trees of NamedTuples / tuples of tensors: the same structure,
    every tensor equal bit for bit (shape and dtype included)."""
    if want is None:
        assert got is None, f"{label}: expected None"
        return
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), label
        assert got.shape == want.shape and got.dtype == want.dtype, (
            label, got.shape, want.shape, got.dtype, want.dtype)
        assert torch.equal(got, want), (
            f"{label}: {int((got != want).sum())} elements differ")
        return
    assert type(got) is type(want), (label, type(got), type(want))
    names = getattr(want, "_fields", range(len(want)))
    for name, g, w in zip(names, got, want):
        assert_tree_equal(g, w, f"{label}.{name}")


# ---- the sync audit ----

_FORBIDDEN = ((torch, "tensor"), (torch, "as_tensor"), (torch, "from_numpy"),
              (torch.Tensor, "item"), (torch.Tensor, "cpu"),
              (torch.Tensor, "numpy"), (torch.Tensor, "tolist"))
_BAD_OPS = ("aten._local_scalar_dense", "aten.nonzero")


class _NoHostReads(TorchDispatchMode):
    """Records every aten op dispatched whose name is in ``_BAD_OPS``."""

    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in _BAD_OPS:
            self.bad.append(name)
        return func(*args, **(kwargs or {}))


def audited(monkeypatch, fn):
    """``fn()`` with the host-copy calls (``torch.tensor``,
    ``torch.as_tensor``, ``torch.from_numpy``, ``Tensor.item`` / ``.cpu``
    / ``.numpy`` / ``.tolist``) patched to raise and a dispatch mode
    recording ``aten._local_scalar_dense`` and ``aten.nonzero``; raises
    on either."""
    calls = []
    for owner, name in _FORBIDDEN:
        def boom(*a, _name=name, **k):
            calls.append(_name)
            raise AssertionError(f"the warm step called {_name}")
        monkeypatch.setattr(owner, name, boom)
    mode = _NoHostReads()
    try:
        with mode:
            fn()
    finally:
        monkeypatch.undo()
    assert not calls, calls
    assert not mode.bad, f"the warm step dispatched {sorted(set(mode.bad))}"

"""Carry receiver and wideband params and state, and the sharded
receiver's carries, between ``dy4tpu`` and the port.

The two packages' NamedTuples have the same fields, so a tree maps by
field path ("rf.iq_tail", "audio.pll.phase_est", "chan.tail_i",
"rx.rds.cdr.offset", ...), not by JAX's pickled treedef.  A dict of numpy
arrays keyed by field path is also what a checkpoint of the port stores.
"""

from __future__ import annotations

import numpy as np
import torch

from dy4tpu_torch.ops import afc, channelizer, iqcorr, pll
from dy4tpu_torch.parallel import sharded
from dy4tpu_torch.pipeline import receiver as rx
from dy4tpu_torch.pipeline import wideband as wb

# NamedTuple field -> the port's type of that subtree
_SUBTREES = {
    rx.ReceiverState: {"rf": rx.RFState, "audio": rx.AudioState,
                       "rds": rx.RDSState, "iqcorr": iqcorr.IQCorrState},
    rx.AudioState: {"pll": pll.PLLState},
    rx.RDSState: {"pll": pll.PLLState, "cdr": rx.CDRState},
    rx.FrontState: {"rf": rx.RFState},
    wb.WidebandState: {"chan": channelizer.ChannelizerState,
                       "rx": rx.ReceiverState, "afc": afc.AFCState,
                       "iqcorr": iqcorr.IQCorrState},
    sharded.ExactCarry: {"front": rx.FrontState, "back": rx.BackState,
                         "cdr": rx.CDRState},
    sharded.ShardedCarry: {"state": rx.ReceiverState},
}


def leaves_by_path(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """The non-None leaves of a NamedTuple tree of either package (numpy,
    JAX or torch leaves) as numpy arrays keyed by field path."""
    out = {}
    for name, v in zip(tree._fields, tree):
        key = prefix + name
        if v is None:
            continue
        if hasattr(v, "_fields"):
            out.update(leaves_by_path(v, key + "."))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def _build(cls, paths: dict, prefix: str, device):
    kids = _SUBTREES.get(cls, {})
    vals = {}
    for name in cls._fields:
        key = prefix + name
        if name in kids:
            if not any(k.startswith(key + ".") for k in paths):
                vals[name] = None
            else:
                vals[name] = _build(kids[name], paths, key + ".", device)
        elif key in paths:
            vals[name] = torch.from_numpy(
                np.array(paths[key], copy=True)).to(device)
        else:
            vals[name] = None
    return cls(**vals)


def _paths(tree) -> dict:
    return tree if isinstance(tree, dict) else leaves_by_path(tree)


def params_from_numpy(tree, device="cuda") -> rx.ReceiverParams:
    """``dy4tpu``'s ``ReceiverParams`` (or a dict by field path) -> the
    port's, on ``device``."""
    return _build(rx.ReceiverParams, _paths(tree), "", device)


def state_from_numpy(tree, device="cuda") -> rx.ReceiverState:
    """``dy4tpu``'s ``ReceiverState`` (or a dict by field path) -> the
    port's, on ``device``; dtypes are kept (int32 CDR offset, bool
    lock flag, int32 iqcorr block count)."""
    return _build(rx.ReceiverState, _paths(tree), "", device)


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """The port's receiver or wideband state as numpy arrays keyed by
    field path."""
    return leaves_by_path(state)


def chan_params_from_numpy(tree, device="cuda"
                           ) -> channelizer.ChannelizerParams:
    """``dy4tpu``'s ``ChannelizerParams`` (or a dict by field path) -> the
    port's, on ``device``."""
    return _build(channelizer.ChannelizerParams, _paths(tree), "", device)


def wideband_state_from_numpy(tree, device="cuda") -> wb.WidebandState:
    """``dy4tpu``'s ``WidebandState`` (or a dict by field path) -> the
    port's, on ``device``: the channelizer tails, the receiver state over
    [*bands, C], and the AFC and iqcorr states where present (the iqcorr
    block count stays int32)."""
    return _build(wb.WidebandState, _paths(tree), "", device)


def exact_carry_from_numpy(tree, device="cuda") -> sharded.ExactCarry:
    """``dy4tpu``'s ``ExactCarry`` (or a dict by field path) -> the
    port's, on ``device``, so that a stream can move between the packages
    between two ``step`` calls.  The shapes are kept: dy4tpu's global
    carry is what the port's rank holds on a 1x1 mesh (the u8 tail, the
    int8 codes, the int32 CDR offset and the bool flags keep their
    dtypes)."""
    return _build(sharded.ExactCarry, _paths(tree), "", device)


def sharded_carry_from_numpy(tree, device="cuda") -> sharded.ShardedCarry:
    """``dy4tpu``'s legacy ``ShardedCarry`` (or a dict by field path) ->
    the port's, on ``device``, as ``exact_carry_from_numpy``."""
    return _build(sharded.ShardedCarry, _paths(tree), "", device)

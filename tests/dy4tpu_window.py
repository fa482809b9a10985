"""Helper of the port's CPU twins: dy4tpu's un-jitted receiver over a window
of blocks, started from a state of the port's run.

An un-jitted dy4tpu step costs about as much as the port's plain one
(about 1.5 s a block on the CPU), so a twin runs the port over its whole
capture and dy4tpu over a window around each event (a dropout, a
re-lock), from the port's state at the window's first block, carried
over by field path (``convert.state_to_numpy``).  The windows of one
file ride one batch: each window is a channel, whatever block it starts
at.  dy4tpu is un-jitted because ``jax.jit`` moves block 0's PLL lock
transient (ROADMAP Queue C, "Jitted dy4tpu").

Decisions (RDS hard symbols, resync flags, CDR offsets) must be equal;
the audio and RDS baseband streams within atol 1e-4 and the pilot SNR
within 1e-3 dB, as tests/test_torch_iqcorr.py holds the receiver.
"""

import jax.numpy as jnp
import numpy as np

from dy4tpu.pipeline import receiver as jrx
from dy4tpu_torch.pipeline import convert

DECISIONS = ("rds_symbols", "rds_resync", "rds_offset")
STREAMS = ("mono", "left", "right", "rds_bb_i", "rds_bb_q")
STREAM_ATOL, SNR_ATOL = 1e-4, 1e-3


def rows(state, sel) -> dict:
    """The port state's leaves (by field path) at batch rows ``sel``."""
    return {k: v[sel] for k, v in convert.state_to_numpy(state).items()}


def stack(*parts) -> dict:
    """Concatenate path dicts (from ``rows``) along the batch axis."""
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _fill(tree, paths, prefix=""):
    vals = []
    for name, v in zip(tree._fields, tree):
        key = prefix + name
        if v is None:
            vals.append(None)
        elif hasattr(v, "_fields"):
            vals.append(_fill(v, paths, key + "."))
        else:
            a = paths[key]
            assert a.dtype == v.dtype, (key, a.dtype, v.dtype)
            vals.append(jnp.asarray(a))
    return type(tree)(*vals)


def jax_state(cfg, paths):
    """dy4tpu's ``ReceiverState`` holding ``paths``, leaf for leaf."""
    batch = paths["rf.prev_i"].shape
    template = jrx.init_state(cfg, batch=batch,
                              with_iqcorr="iqcorr.m" in paths)
    return _fill(template, paths)


def run(cfg, paths, blocks, **step_kwargs) -> dict:
    """dy4tpu's un-jitted ``receiver_step`` from ``paths`` over ``blocks``
    [L, C, block] u8: {field: numpy [L, C, ...]} of every output."""
    params, state = jrx.make_params(cfg), jax_state(cfg, paths)
    got = {}
    for blk in blocks:
        state, out = jrx.receiver_step(params, state, jnp.asarray(blk), cfg,
                                       **step_kwargs)
        for f, v in zip(out._fields, out):
            if v is not None:
                got.setdefault(f, []).append(np.asarray(v))
    return {f: np.stack(v) for f, v in got.items()}


def assert_twins(ours: dict, ref: dict, where: str) -> None:
    """The port's outputs (numpy, same layout) against dy4tpu's: decisions
    equal, streams within the file's tolerances."""
    for f, r in ref.items():
        if f not in ours:
            continue
        o = ours[f]
        assert o.shape == r.shape and o.dtype == r.dtype, (where, f)
        if f in DECISIONS:
            np.testing.assert_array_equal(o, r, err_msg=f"{where} {f}")
        else:
            atol = SNR_ATOL if f == "pilot_snr_db" else STREAM_ATOL
            np.testing.assert_allclose(o, r, atol=atol,
                                       err_msg=f"{where} {f}")


def numpy_outputs(outs, blocks=slice(None), sel=slice(None)) -> dict:
    """The port's ``StepOutputs`` as {field: numpy}, at ``blocks`` and
    batch rows ``sel``."""
    return {f: v[blocks][:, sel].numpy() for f, v in zip(outs._fields, outs)
            if v is not None}

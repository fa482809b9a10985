"""The wideband step's chunk runner against dy4tpu, on the CPU: the port's
graphed run (``graph.run_wideband_blocks``, the runner's eager body) held
to dy4tpu's un-jitted ``wideband_step`` loop, and a dy4tpu
``WidebandState`` handed in mid-stream through ``pipeline/convert.py``.

The captures and configuration are tests/test_torch_graph_wideband.py's
(mode 0, C=4 x 2 bands x T=12, 5 steps, AFC and the IQ tracker on, band
1 through a tuner fault, RDS on channel 1 only); the port runs on
dy4tpu's params and bank.  Bars, as in tests/test_torch_wideband.py:
every float output and state leaf to atol 1e-4, the pilot SNR and the
RSSI to 1e-3 dB, every RDS decision exact.

The capture with empty channels (channel 1's station alone, the others
noise) holds the station's channel and every channel's RSSI to those
bars.  The empty channels' demodulated streams are not held: FM
demodulation of noise, and the PLLs locked onto it, turn float32
rounding into gaps far over 1e-4, and dy4tpu differs from itself there
as much (its jitted step against its un-jitted one; measured by
``tests/dy4tpu_wideband_gap.py``, ROADMAP.md Queue C).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode as jget_mode  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.pipeline import wideband as jwb  # noqa: E402
from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.pipeline import convert, graph  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.pipeline import wideband as wb  # noqa: E402
from test_torch_graph_wideband import (BANDS, C, STEPS, T,  # noqa: E402
                                       wideband_blocks)
from torch_graph_cases import DEV  # noqa: E402

cfg = get_mode(0)
HANDOFF = 2          # dy4tpu's state after this many steps crosses over


def dy4tpu_run(blocks):
    """dy4tpu's un-jitted step loop over ``blocks``: its params and bank
    (and the port's copies of them), its state after every step and its
    stacked outputs."""
    jcfg = jget_mode(0)
    jp = jrx.make_params(jcfg)
    jc = jwb.make_wideband(jcfg, C, taps_per_branch=T)
    js = jwb.wideband_init(jcfg, jc, batch=(BANDS,), afc=True, iqcorr=True)
    states, outs = [], []
    for blk in blocks.numpy():
        js, jo = jwb.wideband_step(jp, jc, js, jnp.asarray(blk), jcfg)
        states.append(js)
        outs.append(jo)
    stacked = wb.WidebandOutputs(
        rx=rx.StepOutputs(*(None if f[0] is None else np.stack(
            [np.asarray(v) for v in f]) for f in zip(*(o.rx for o in outs)))),
        rssi=np.stack([np.asarray(o.rssi) for o in outs]))
    return dict(params=convert.params_from_numpy(jp, device=DEV),
                chan=convert.chan_params_from_numpy(jc, device=DEV),
                blocks=blocks, states=states, outs=stacked)


@pytest.fixture(scope="module")
def ref():
    return dy4tpu_run(wideband_blocks(0))


@pytest.fixture(scope="module")
def ref_empty():
    return dy4tpu_run(wideband_blocks(0, empty=True))


def _assert_leaf(ours, theirs, name, atol=1e-4):
    if theirs is None:
        assert ours is None, name
        return
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, (name, ours.shape, theirs.shape)
    assert ours.dtype == theirs.dtype, (name, ours.dtype, theirs.dtype)
    if theirs.dtype.kind == "f":
        np.testing.assert_allclose(ours, theirs, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(ours, theirs, err_msg=name)


def _assert_run(outs, state, ref, steps, label):
    """The port's outputs over ``steps`` and end state against dy4tpu's."""
    for f in rx.StepOutputs._fields:
        theirs = getattr(ref["outs"].rx, f)
        _assert_leaf(getattr(outs.rx, f),
                     None if theirs is None else theirs[steps],
                     f"{label} {f}", 1e-3 if f == "pilot_snr_db" else 1e-4)
    _assert_leaf(outs.rssi, ref["outs"].rssi[steps], f"{label} rssi", 1e-3)
    ours = convert.state_to_numpy(state)
    theirs = convert.leaves_by_path(ref["states"][-1])
    assert ours.keys() == theirs.keys(), set(ours) ^ set(theirs)
    for k in theirs:
        _assert_leaf(ours[k], theirs[k], f"{label} state {k}")


def test_graph_matches_dy4tpu_unjitted(ref):
    state = wb.wideband_init(cfg, ref["chan"], (BANDS,), afc=True,
                             iqcorr=True)
    state, outs = graph.run_wideband_blocks(ref["params"], ref["chan"],
                                            state, ref["blocks"], cfg,
                                            chunk=2)
    _assert_run(outs, state, ref, slice(None), "graph chunk 2")


def test_dy4tpu_state_handed_in_midstream(ref):
    """dy4tpu runs steps 0-1; its ``WidebandState`` crosses over by field
    path into a runner, which runs steps 2-4 as one chunk of 3 and
    matches dy4tpu's steps 2-4 and end state."""
    st = convert.wideband_state_from_numpy(ref["states"][HANDOFF - 1],
                                           device=DEV)
    assert st.iqcorr.count.dtype == torch.int32
    runner = graph.wideband_runner(ref["params"], ref["chan"], st, cfg)
    outs = runner.run(ref["blocks"][HANDOFF:])
    assert outs.rx.mono.shape[0] == STEPS - HANDOFF
    _assert_run(outs, runner.read(), ref, slice(HANDOFF, None), "handoff")


def test_graph_matches_dy4tpu_beside_empty_channels(ref_empty):
    """Channel 1's station among three channels of noise: its every output
    and per-channel state leaf, the band's filter-bank tails and tracker,
    and every channel's RSSI, held to dy4tpu's at the bars."""
    ref = ref_empty
    state = wb.wideband_init(cfg, ref["chan"], (BANDS,), afc=True,
                             iqcorr=True)
    state, outs = graph.run_wideband_blocks(ref["params"], ref["chan"],
                                            state, ref["blocks"], cfg,
                                            chunk=3)
    for f in rx.StepOutputs._fields:
        theirs = getattr(ref["outs"].rx, f)
        ours = getattr(outs.rx, f)
        _assert_leaf(None if ours is None else ours[:, :, 1],
                     None if theirs is None else theirs[:, :, 1],
                     f"station {f}", 1e-3 if f == "pilot_snr_db" else 1e-4)
    _assert_leaf(outs.rssi, ref["outs"].rssi, "rssi", 1e-3)
    ours = convert.state_to_numpy(state)
    theirs = convert.leaves_by_path(ref["states"][-1])
    assert ours.keys() == theirs.keys(), set(ours) ^ set(theirs)
    for k in theirs:
        per_channel = k.startswith(("rx.", "afc."))
        _assert_leaf(ours[k][:, 1] if per_channel else ours[k],
                     theirs[k][:, 1] if per_channel else theirs[k],
                     f"state {k}")

"""The port's fleet serving (dy4tpu_torch.tools.fleet) on the CPU, against
dy4tpu's receiver and RDS host layers.

``serve(record=True)`` over two distinct mode-0 stations, 16 blocks: the
RDS hard symbols, resync flags and CDR offsets of every block equal
dy4tpu's un-jitted ``receiver_step`` loop on the same blocks (under
``jax.jit`` XLA's fusion moves block 0's PLL lock transient, a difference
inside dy4tpu itself, so the port is held to the un-jitted step), and the
groups dy4tpu's ``FleetDecoder`` + ``ApplicationLayer`` make of dy4tpu's
outputs equal the ones the port's copies make of the port's.  The tool's
command line and ingest variants are in tests/test_torch_fleet_cli.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.rds.app import ApplicationLayer as JApp  # noqa: E402
from dy4tpu.rds.fleet import FleetDecoder as JFleet  # noqa: E402
from dy4tpu_torch.rds import coding  # noqa: E402
from dy4tpu_torch.rds.app import ApplicationLayer  # noqa: E402
from dy4tpu_torch.rds.fleet import FleetDecoder  # noqa: E402
from dy4tpu_torch.runtime import native  # noqa: E402
from dy4tpu_torch.tools import fleet  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime not built")

cfg = get_mode(0)
N_BLOCKS = 16
STATIONS = ((0x54A7, "DY4TPU  "), (0x0A0B, "FLEET  2"))
FIELDS = ("rds_symbols", "rds_resync", "rds_offset")


def _capture(path, mode, n_blocks, pi, ps, **kw):
    c = get_mode(mode)
    n_audio = n_blocks * c.audio_per_block
    bits = coding.make_ps_bitstream(pi, 10, ps, repeats=8)
    iq = fm.synthesize(c, n_blocks, rds_bits=bits,
                       left=fm.tone(800.0, c.audio_fs, n_audio, amp=0.6),
                       right=fm.tone(2400.0, c.audio_fs, n_audio, amp=0.6),
                       **kw)
    iq.tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    return [_capture(d / f"st{i}.raw", 0, N_BLOCKS, pi, ps)
            for i, (pi, ps) in enumerate(STATIONS)]


@pytest.fixture(scope="module")
def served(caps):
    return fleet.serve(caps, cfg, record=True, device=DEV)


@pytest.fixture(scope="module")
def reference(caps):
    """dy4tpu's un-jitted step over the same [N_BLOCKS, 2, bs] blocks:
    the three RDS fields of every block."""
    host = fleet.host_blocks(caps, cfg, N_BLOCKS)
    params = jrx.make_params(cfg)
    state = jrx.init_state(cfg, batch=(len(caps),))
    got = {f: [] for f in FIELDS}
    for blk in host:
        state, out = jrx.receiver_step(params, state, jnp.asarray(blk), cfg,
                                       cdr_timing="peak")
        for f in FIELDS:
            got[f].append(np.asarray(getattr(out, f)))
    return host, {f: np.stack(v) for f, v in got.items()}


def _groups(decoder_cls, app_cls, arrays):
    c = arrays["rds_symbols"].shape[1]
    apps = [app_cls() for _ in range(c)]
    dec = decoder_cls(c, on_group=lambda ch, g: apps[ch].process(g))
    for b in range(arrays["rds_symbols"].shape[0]):
        dec.push_block(*(arrays[f][b] for f in FIELDS))
    return ([[(g.blocks, g.bit_position) for g in row] for row in dec.groups],
            apps)


def test_host_layout_is_station_by_station(caps, reference):
    host, _ = reference
    assert host.shape == (N_BLOCKS, 2, cfg.block_size)
    for ch, p in enumerate(caps):
        raw = np.fromfile(p, np.uint8)
        np.testing.assert_array_equal(host[:, ch].ravel(), raw)
    # a repeated path repeats the reference
    rep = fleet.host_blocks([caps[0], caps[1], caps[0]], cfg, 2)
    np.testing.assert_array_equal(rep[:, 2], rep[:, 0])


@pytest.mark.parametrize("field", FIELDS)
def test_rds_outputs_equal_dy4tpu_unjitted(served, reference, field):
    _, ref = reference
    got = getattr(served, field)
    assert got.shape == ref[field].shape and got.dtype == ref[field].dtype
    np.testing.assert_array_equal(got, ref[field], err_msg=field)


def test_decoded_groups_equal_dy4tpu(served, reference):
    _, ref = reference
    ours = {f: getattr(served, f) for f in FIELDS}
    g_port, apps_port = _groups(FleetDecoder, ApplicationLayer, ours)
    g_ref, apps_ref = _groups(JFleet, JApp, ref)
    assert g_port == g_ref
    assert sum(map(len, g_port)) >= 4
    for info, a_port, a_ref in zip(served.infos, apps_port, apps_ref):
        assert (info.pi_hex, info.ps_name, info.pty_name,
                info.groups_seen) == (
            a_port.info.pi_hex, a_port.info.ps_name, a_port.info.pty_name,
            a_port.info.groups_seen) == (
            a_ref.info.pi_hex, a_ref.info.ps_name, a_ref.info.pty_name,
            a_ref.info.groups_seen)
    for info, (pi, _) in zip(served.infos, STATIONS):
        assert info.pi == pi

"""The plain functions of the port that mirror dy4tpu's last plain ones
(``fir.convolve_full`` / ``downsample`` / ``upsample``,
``demod.fm_demod_arctan`` and ``front_step(demod_kind="arctan")``,
``pll.pll_reference``, ``trig.sin`` / ``trig.cos``), against dy4tpu on
the CPU, twins of tests/test_fir.py and tests/test_demod_pll.py; and the
exact time-sharded carry through ``utils/checkpoint.py``.

Bars: the zero-stuffing and striding exactly; ``convolve_full`` to fp32
tolerance (1e-5, test_fir.py's); the arctan demod to 1e-3 against the
numpy unwrap (test_demod_pll.py's) and to 1e-6 against dy4tpu and across a
block boundary; the port's ``pll`` against its ``pll_reference`` to 5e-3
(test_demod_pll.py's) and ``pll_reference`` against dy4tpu's to 1e-4;
``sin`` / ``cos`` bitwise dy4tpu's (op for op, test_torch_ops.py's bar for
``sincos``); the arctan receiver's outputs and state to 1e-4 and its
decisions exactly (test_torch_receiver.py's bars, dy4tpu un-jitted); a
checkpointed ``ExactCarry`` continues bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import demod as jdemod  # noqa: E402
from dy4tpu.ops import fir as jfir  # noqa: E402
from dy4tpu.ops import pll as jpll  # noqa: E402
from dy4tpu.ops import trig as jtrig  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu_torch.ops import demod, fir, pll, trig  # noqa: E402
from dy4tpu_torch.parallel import ShardedReceiver, make_mesh  # noqa: E402
from dy4tpu_torch.pipeline import convert  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.rds import coding  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402
from dy4tpu_torch.utils import checkpoint as ckpt  # noqa: E402

RNG = np.random.default_rng(7)
cfg = get_mode(0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- fir (tests/test_fir.py:135-150) ----

def test_up_down_sample():
    x = np.arange(12.0, dtype=np.float32)
    up = fir.upsample(_t(x), 3)
    assert up.shape == (36,)
    np.testing.assert_array_equal(up[::3].numpy(), x)
    assert float(up.abs().sum()) == float(np.abs(x).sum())
    np.testing.assert_array_equal(up.numpy(),
                                  np.asarray(jfir.upsample(jnp.asarray(x), 3)))
    dn = fir.downsample(up, 3)
    np.testing.assert_array_equal(dn.numpy(), x)
    xb = RNG.normal(size=(2, 3, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        fir.upsample(_t(xb), 4).numpy(),
        np.asarray(jfir.upsample(jnp.asarray(xb), 4)))
    np.testing.assert_array_equal(
        fir.downsample(_t(xb), 3).numpy(),
        np.asarray(jfir.downsample(jnp.asarray(xb), 3)))


def test_convolve_full():
    h = RNG.normal(size=7).astype(np.float32)
    x = RNG.normal(size=20).astype(np.float32)
    y = fir.convolve_full(_t(x), _t(h)).numpy()
    np.testing.assert_allclose(y, np.convolve(x, h), atol=1e-5)
    np.testing.assert_allclose(
        y, np.asarray(jfir.convolve_full(jnp.asarray(x), jnp.asarray(h))),
        atol=1e-5)
    xb = RNG.normal(size=(3, 2, 50)).astype(np.float32)
    yb = fir.convolve_full(_t(xb), _t(h)).numpy()
    assert yb.shape == (3, 2, 56)
    np.testing.assert_allclose(
        yb, np.asarray(jfir.convolve_full(jnp.asarray(xb), jnp.asarray(h))),
        atol=1e-5)


# ---- demod (tests/test_demod_pll.py:44, :128) ----

def _fm_iq(n, f_dev, f_mod, beta):
    t = np.arange(n) / 240e3
    phase = 2 * np.pi * f_dev * t + beta * np.sin(2 * np.pi * f_mod * t)
    return np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)


def test_fm_demod_arctan_variant():
    i, q = _fm_iq(4800, 10e3, 300, 0.3)
    out, last = demod.fm_demod_arctan(_t(i), _t(q), torch.zeros(()))
    ref = np.diff(np.unwrap(np.arctan2(q, i)), prepend=0.0)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3)
    j_out, j_last = jdemod.fm_demod_arctan(jnp.asarray(i), jnp.asarray(q),
                                           jnp.zeros(()))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-6)
    np.testing.assert_allclose(float(last), float(j_last), atol=1e-6)


def test_fm_demod_arctan_streaming_continuity():
    """prev_phase carry: two blocks == one double-length block."""
    i, q = _fm_iq(4000, 12e3, 170, 0.5)
    full, _ = demod.fm_demod_arctan(_t(i), _t(q), torch.zeros(()))
    h1, carry = demod.fm_demod_arctan(_t(i[:2000]), _t(q[:2000]),
                                      torch.zeros(()))
    h2, _ = demod.fm_demod_arctan(_t(i[2000:]), _t(q[2000:]), carry)
    np.testing.assert_allclose(torch.cat([h1, h2]).numpy(), full.numpy(),
                               atol=1e-6)


# ---- pll (tests/test_demod_pll.py:120) ----

def test_pll_matches_reference_across_blocks():
    fs = 240e3
    t = np.arange(8192) / fs
    x = (np.cos(2 * np.pi * 19e3 * t + 0.4)
         + 0.1 * RNG.normal(size=len(t))).astype(np.float32)
    x[100] = 0.0  # exercise the zero-input guard
    st_a = pll.init_state(device=DEV)
    st_b = pll.init_state(device=DEV)
    st_j = jpll.init_state()
    for sl in (slice(0, 4096), slice(4096, 8192)):
        a_i, a_q, st_a = pll.pll(_t(x[sl]), st_a, freq=19e3, fs=fs,
                                 nco_scale=2.0)
        b_i, b_q, st_b = pll.pll_reference(_t(x[sl]), st_b, freq=19e3,
                                           fs=fs, nco_scale=2.0)
        j_i, j_q, st_j = jpll.pll_reference(jnp.asarray(x[sl]), st_j,
                                            freq=19e3, fs=fs, nco_scale=2.0)
        np.testing.assert_allclose(a_i.numpy(), b_i.numpy(), atol=5e-3)
        np.testing.assert_allclose(a_q.numpy(), b_q.numpy(), atol=5e-3)
        np.testing.assert_allclose(b_i.numpy(), np.asarray(j_i), atol=1e-4)
        np.testing.assert_allclose(b_q.numpy(), np.asarray(j_q), atol=1e-4)
    for ours, ref in zip(st_b, st_j):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


# ---- trig (dy4tpu/ops/trig.py:83-87) ----

def test_sin_cos_equal_dy4tpu():
    x = np.concatenate([RNG.uniform(-64, 64, 4096),
                        np.linspace(-2048, 2048, 1001),
                        np.arange(-8, 9) * np.pi / 4]).astype(np.float32)
    np.testing.assert_array_equal(trig.sin(_t(x)).numpy(),
                                  np.asarray(jtrig.sin(jnp.asarray(x))))
    np.testing.assert_array_equal(trig.cos(_t(x)).numpy(),
                                  np.asarray(jtrig.cos(jnp.asarray(x))))
    np.testing.assert_allclose(trig.sin(_t(x)).numpy(), np.sin(x), atol=1e-5)
    np.testing.assert_allclose(trig.cos(_t(x)).numpy(), np.cos(x), atol=1e-5)


# ---- receiver_step(demod_kind="arctan") against dy4tpu's ----

@pytest.fixture(scope="module")
def arctan_runs():
    """Mode 0, C=2 (channel 1 the broadcast with I/Q swapped), 3 blocks,
    the port's plain path and dy4tpu's un-jitted stock path."""
    n_blocks, n_audio = 3, 3 * cfg.audio_per_block
    bits = coding.make_ps_bitstream(fm.PI_CODE, 10, fm.PS_NAME, repeats=4)
    iq = fm.synthesize(cfg, n_blocks,
                       left=fm.tone(800.0, cfg.audio_fs, n_audio, amp=0.7),
                       right=fm.tone(2400.0, cfg.audio_fs, n_audio, amp=0.7),
                       rds_bits=bits, noise=0.02, seed=5
                       ).reshape(n_blocks, 1, cfg.block_size)
    swapped = iq.reshape(n_blocks, 1, -1, 2)[..., ::-1].reshape(iq.shape)
    iq = np.concatenate([iq, swapped], axis=1)
    jp = jrx.make_params(cfg)
    js = jrx.init_state(cfg, batch=(2,))
    tp = convert.params_from_numpy(jp, device=DEV)
    ts = rx.init_state(cfg, batch=(2,), device=DEV)
    runs = []
    for blk in iq:
        js, jo = jrx.receiver_step(jp, js, jnp.asarray(blk), cfg,
                                   demod_kind="arctan", cdr_timing="peak")
        ts, to = rx.receiver_step(tp, ts, _t(blk), cfg, demod_kind="arctan")
        runs.append((to, ts, jo, js))
    return tp, iq, runs


def _close(ours, ref, name, atol=1e-4):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, name
    if ref.dtype.kind == "f":
        np.testing.assert_allclose(ours, ref, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(ours, ref, err_msg=name)


def test_arctan_receiver_matches_dy4tpu(arctan_runs):
    _, _, runs = arctan_runs
    for b, (to, ts, jo, js) in enumerate(runs):
        for f in rx.StepOutputs._fields:
            _close(getattr(to, f), getattr(jo, f), f"{f}[{b}]",
                   1e-3 if f == "pilot_snr_db" else 1e-4)
        ours = convert.state_to_numpy(ts)
        ref = convert.leaves_by_path(js)
        assert ours.keys() == ref.keys()
        for k in ref:
            _close(torch.from_numpy(np.asarray(ours[k])), ref[k], f"{k}[{b}]")
    # the prev_i slot carries the phase, prev_q the last Q sample
    assert float(runs[-1][1].rf.prev_i.abs().max()) <= np.pi


def test_arctan_refuses_a_kernel_front_end(arctan_runs):
    tp, iq, _ = arctan_runs
    st = rx.init_state(cfg, batch=(2,), device=DEV)
    for frontend in ("fused-rf", "fused-phase"):
        with pytest.raises(ValueError, match="arctan"):
            rx.receiver_step(tp, st, _t(iq[0]), cfg, frontend=frontend,
                             demod_kind="arctan")
    with pytest.raises(ValueError, match="demod_kind"):
        rx.receiver_step(tp, st, _t(iq[0]), cfg, demod_kind="atan")


def test_arctan_plain_equals_auto_and_differs_from_diff(arctan_runs):
    """``frontend="plain"`` and ``"auto"`` run the same arctan front end;
    the default "diff" demod gives other audio on the same block."""
    tp, iq, runs = arctan_runs
    st = rx.init_state(cfg, batch=(2,), device=DEV)
    _, plain = rx.front_step(tp, rx.front_state_of(st), _t(iq[0]), cfg,
                             frontend="plain", demod_kind="arctan")
    _, auto = rx.front_step(tp, rx.front_state_of(st), _t(iq[0]), cfg,
                            demod_kind="arctan")
    _, diff = rx.front_step(tp, rx.front_state_of(st), _t(iq[0]), cfg)
    for a, b in zip(plain, auto):
        assert torch.equal(a, b)
    assert not torch.allclose(plain.fm_delayed, diff.fm_delayed, atol=1e-3)


# ---- the exact time-sharded carry through a checkpoint file ----

def test_exact_carry_checkpoint_round_trip(tmp_path):
    """A 1x1 ``ShardedReceiver`` (mode 0, C=2, 2 blocks a step): the carry
    after step 1 saved and loaded into ``init``'s template; step 2 from the
    loaded carry equals step 2 from the carry in memory, field for field
    (``==``)."""
    n = 2
    iq = fm.stereo_rds_broadcast(cfg, 2 * n + 1, noise=0.05, seed=3).ravel()
    iq = np.stack([iq[74 * c:74 * c + 2 * n * cfg.block_size]
                   for c in range(2)])
    r = ShardedReceiver(cfg, make_mesh(devices=[DEV]), shard_blocks=n)
    params = rx.make_params(cfg, device=DEV)
    carry, _ = r.step(params, r.init(2), _t(iq[:, :r.chunk_len]))
    path = str(tmp_path / "exact.ckpt")
    ckpt.save(path, carry, meta={"blocks": n})
    loaded, host, meta = ckpt.load(path, r.init(2))
    assert meta == {"blocks": n} and host == {}
    assert type(loaded) is type(carry)
    nxt = _t(iq[:, r.chunk_len:])
    c_mem, o_mem = r.step(params, carry, nxt)
    c_file, o_file = r.step(params, loaded, nxt)
    for f in o_mem._fields:
        a, b = getattr(o_mem, f), getattr(o_file, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    for (k, a), (_, b) in zip(ckpt._leaves(c_mem), ckpt._leaves(c_file)):
        assert torch.equal(a, b), k

"""The plain version of the port's front-end kernel (B1,
``frontend_cuda.fused_frontend_full_plain``, which is also what the
kernel wrapper runs on CPU tensors) against dy4tpu's fused Pallas front
end in interpret mode and against dy4tpu's stock ``front_step``.

C=3 (not a multiple of the TPU kernel's 8-row tile) over 2 blocks, so the
carried tails are exercised.  Bars: fm-derived streams to atol 2e-3 on
random u8, as in tests/test_frontend_pallas.py, plus rtol 2e-3 (the /power
demod amplifies float32 noise in proportion to its output where the
random input has near-zero power); atol 1e-4 on a synthesized broadcast
(constant envelope); iq_tail exact; prev_i / prev_q to 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import frontend_pallas  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.tx import fm as jfm  # noqa: E402
from dy4tpu_torch.ops import frontend_cuda  # noqa: E402
from dy4tpu_torch.pipeline import convert  # noqa: E402

cfg = get_mode(0)
C = 3
NAMES = ("fm_delayed", "pilot", "stereo", "carrier", "rds_delayed",
         "iq_tail", "prev_i", "prev_q", "bank_tail", "mono_delay",
         "carrier_tail", "rds_delay")


def _tails(rng):
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    t = cfg.num_taps
    return [f(C, 2, t - 1), f(C), f(C), f(C, t - 1), f(C, t // 2),
            f(C, t - 1), f(C, t // 2)]


def _check(ours, ref, atol, rtol):
    for name, o, r in zip(NAMES, ours, ref):
        o, r = o.numpy(), np.asarray(r)
        assert o.shape == r.shape, name
        if name == "iq_tail":
            np.testing.assert_array_equal(o, r, err_msg=name)
        elif name in ("prev_i", "prev_q"):
            np.testing.assert_allclose(o, r, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(o, r, atol=atol, rtol=rtol,
                                       err_msg=name)


def _run_two_blocks(blocks, tails, atol, rtol=0.0):
    jp = jrx.make_params(cfg)
    h = [np.array(a) for a in (jp.rf_coeff, jp.bank_coeff,
                                 jp.rds_carrier_coeff)]
    ours_st = [torch.from_numpy(a) for a in tails]
    pallas_st = [jnp.asarray(a) for a in tails]
    stock_fs = jrx.FrontState(
        rf=jrx.RFState(*(jnp.asarray(a) for a in tails[:3])),
        mono_delay=jnp.asarray(tails[4]), bank_tail=jnp.asarray(tails[3]),
        carrier_tail=jnp.asarray(tails[5]), rds_delay=jnp.asarray(tails[6]))
    for blk in blocks:
        ours = frontend_cuda.fused_frontend_full_plain(
            torch.from_numpy(blk.copy()), *(torch.from_numpy(a) for a in h),
            *ours_st, cfg.rf_decim)
        pallas = frontend_pallas.fused_frontend_full(
            jnp.asarray(blk), *(jnp.asarray(a) for a in h), *pallas_st,
            cfg.rf_decim, rds=True, mm_dtype=jnp.float32, interpret=True)
        _check(ours, pallas[:12], atol, rtol)
        stock_fs, fo = jrx.front_step(jp, stock_fs, jnp.asarray(blk), cfg,
                                      precision=lax.Precision.HIGHEST,
                                      frontend="stock")
        st = stock_fs
        _check(ours, (*fo, st.rf.iq_tail, st.rf.prev_i, st.rf.prev_q,
                      st.bank_tail, st.mono_delay, st.carrier_tail,
                      st.rds_delay), atol, rtol)
        # carry each implementation's own state into the next block
        ours_st = list(ours[5:])
        pallas_st = list(pallas[5:12])


def test_plain_frontend_matches_pallas_and_stock_random_u8():
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (2, C, cfg.block_size), dtype=np.uint8)
    _run_two_blocks(blocks, _tails(rng), atol=2e-3, rtol=2e-3)


def test_plain_frontend_matches_pallas_and_stock_broadcast():
    rng = np.random.default_rng(1)
    n_audio = 2 * cfg.audio_per_block
    iq = jfm.synthesize(cfg, 2,
                        left=jfm.tone(1e3, cfg.audio_fs, n_audio, amp=0.5),
                        right=jfm.tone(3e3, cfg.audio_fs, n_audio, amp=0.5),
                        noise=0.05, seed=3).reshape(2, 1, cfg.block_size)
    blocks = np.repeat(iq, C, axis=1)
    _run_two_blocks(blocks, _tails(rng), atol=1e-4)


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(2)
    blk = torch.from_numpy(rng.integers(0, 256, (C, cfg.block_size),
                                        dtype=np.uint8))
    jp = convert.params_from_numpy(jrx.make_params(cfg))
    args = (blk, jp.rf_coeff, jp.bank_coeff, jp.rds_carrier_coeff,
            *(torch.from_numpy(a) for a in _tails(rng)), cfg.rf_decim)
    before = frontend_cuda.fused_frontend_full.launches
    ours = frontend_cuda.fused_frontend_full(*args)
    plain = frontend_cuda.fused_frontend_full_plain(*args)
    assert frontend_cuda.fused_frontend_full.launches == before
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)

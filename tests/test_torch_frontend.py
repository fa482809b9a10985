"""The plain versions of the port's front-end kernels (B1,
``frontend_cuda.fused_frontend_full_plain``, and B6, the IF entry's
``fused_frontend_if_plain``, which are also what the kernel wrappers run
on CPU tensors) against dy4tpu's fused Pallas front ends in interpret mode
and against dy4tpu's stock ``front_step`` / ``front_step_if``: B1 at mode
0 with RDS and mode 1 without, B6 at the same two.

C=3 (not a multiple of the TPU kernel's 8-row tile) over 2 blocks, so the
carried tails are exercised.  Bars: fm-derived streams to atol 2e-3 on
random u8, as in tests/test_frontend_pallas.py, plus rtol 2e-3 (the /power
demod amplifies float32 noise in proportion to its output where the
random input has near-zero power); atol 1e-4 on a synthesized broadcast
(constant envelope); iq_tail exact; prev_i / prev_q to 1e-5 (B6: exact,
they are the input's last sample).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import frontend_pallas  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.rds import coding  # noqa: E402
from dy4tpu.tx import fm as jfm  # noqa: E402
from dy4tpu_torch.ops import frontend_cuda  # noqa: E402
from dy4tpu_torch.pipeline import convert  # noqa: E402

cfg = get_mode(0)
C = 3
NAMES = ("fm_delayed", "pilot", "stereo", "carrier", "rds_delayed",
         "iq_tail", "prev_i", "prev_q", "bank_tail", "mono_delay",
         "carrier_tail", "rds_delay")


def _tails(rng, rds=True):
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    t = cfg.num_taps
    return [f(C, 2, t - 1), f(C), f(C), f(C, t - 1), f(C, t // 2),
            f(C, t - 1) if rds else None, f(C, t // 2) if rds else None]


def _check(ours, ref, atol, rtol, names=NAMES):
    for name, o, r in zip(names, ours, ref):
        if r is None:
            assert o is None, name
            continue
        o, r = o.numpy(), np.asarray(r)
        assert o.shape == r.shape, name
        if name == "iq_tail":
            np.testing.assert_array_equal(o, r, err_msg=name)
        elif name in ("prev_i", "prev_q"):
            np.testing.assert_allclose(o, r, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(o, r, atol=atol, rtol=rtol,
                                       err_msg=name)


def _opt(f, a):
    return None if a is None else f(a)


def _run_two_blocks(blocks, tails, atol, rtol=0.0, c=cfg):
    rds = c.supports_rds
    jp = jrx.make_params(c)
    h = [_opt(np.array, a) for a in (jp.rf_coeff, jp.bank_coeff,
                                      jp.rds_carrier_coeff)]
    ours_st = [_opt(torch.from_numpy, a) for a in tails]
    pallas_st = [_opt(jnp.asarray, a) for a in tails]
    stock_fs = jrx.FrontState(
        rf=jrx.RFState(*(jnp.asarray(a) for a in tails[:3])),
        mono_delay=jnp.asarray(tails[4]), bank_tail=jnp.asarray(tails[3]),
        carrier_tail=_opt(jnp.asarray, tails[5]),
        rds_delay=_opt(jnp.asarray, tails[6]))
    for blk in blocks:
        ours = frontend_cuda.fused_frontend_full_plain(
            torch.from_numpy(blk.copy()),
            *(_opt(torch.from_numpy, a) for a in h), *ours_st, c.rf_decim,
            rds=rds)
        pallas = frontend_pallas.fused_frontend_full(
            jnp.asarray(blk), *(_opt(jnp.asarray, a) for a in h),
            *pallas_st, c.rf_decim, rds=rds, mm_dtype=jnp.float32,
            interpret=True)
        _check(ours, pallas[:12], atol, rtol)
        stock_fs, fo = jrx.front_step(jp, stock_fs, jnp.asarray(blk), c,
                                      precision=lax.Precision.HIGHEST,
                                      rds_enabled=rds, frontend="stock")
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


def test_plain_frontend_without_rds_matches_pallas_and_stock_mode1():
    """B1 with ``rds=False`` at mode 1 (decimation by 5, no RDS stages)."""
    c1 = get_mode(1)
    rng = np.random.default_rng(4)
    n_audio = 2 * c1.audio_per_block
    iq = jfm.synthesize(c1, 2,
                        left=jfm.tone(1e3, c1.audio_fs, n_audio, amp=0.5),
                        right=jfm.tone(3e3, c1.audio_fs, n_audio, amp=0.5),
                        noise=0.05, seed=4).reshape(2, 1, c1.block_size)
    blocks = np.repeat(iq, C, axis=1)
    _run_two_blocks(blocks, _tails(rng, rds=False), atol=1e-4, c=c1)


IF_NAMES = ("fm_delayed", "pilot", "stereo", "carrier", "rds_delayed",
            "prev_i", "prev_q", "bank_tail", "mono_delay", "carrier_tail",
            "rds_delay")


def _if_stream(c, n_blocks, rds):
    """A complex IF-rate FM stream (what a channelizer channel carries),
    [n_blocks, C, if_per_block] I and Q; odd channels have I and Q
    swapped."""
    n_audio = n_blocks * c.audio_per_block
    bits = (coding.make_ps_bitstream(0x1234, 5, "IF TEST!", repeats=4)
            if rds else None)
    m = jfm.multiplex(c, n_blocks,
                      left=jfm.tone(800.0, c.audio_fs, n_audio, amp=0.7),
                      right=jfm.tone(2400.0, c.audio_fs, n_audio, amp=0.7),
                      rds_bits=bits)
    x = np.exp(1j * 2 * np.pi * 75e3 / c.if_fs * np.cumsum(m))
    i = x.real.reshape(n_blocks, 1, c.if_per_block).astype(np.float32)
    q = x.imag.reshape(n_blocks, 1, c.if_per_block).astype(np.float32)
    odd = (np.arange(C) % 2 == 1)[None, :, None]
    return np.where(odd, q, i), np.where(odd, i, q)


@pytest.mark.parametrize("mode,rds", [(0, True), (1, False)])
def test_plain_frontend_if_matches_pallas_and_stock(mode, rds):
    """B6 against ``fused_frontend_if`` (interpret) and the stock
    ``front_step_if`` over a 2-block stream, each carrying its own state,
    as tests/test_frontend_pallas.py does for the Pallas kernel."""
    c = get_mode(mode)
    rng = np.random.default_rng(5 + mode)
    jp = jrx.make_params(c, with_rds=rds)
    tails = _tails(rng, rds)
    ours_st = [_opt(torch.from_numpy, a) for a in tails[1:]]
    pallas_st = [_opt(jnp.asarray, a) for a in tails[1:]]
    stock_fs = jrx.FrontState(
        rf=jrx.RFState(*(jnp.asarray(a) for a in tails[:3])),
        mono_delay=jnp.asarray(tails[4]), bank_tail=jnp.asarray(tails[3]),
        carrier_tail=_opt(jnp.asarray, tails[5]),
        rds_delay=_opt(jnp.asarray, tails[6]))
    bank = np.array(jp.bank_coeff)
    carrier = _opt(np.array, jp.rds_carrier_coeff)
    bi, bq = _if_stream(c, 2, rds)
    for blk in range(2):
        ours = frontend_cuda.fused_frontend_if_plain(
            torch.from_numpy(bi[blk]), torch.from_numpy(bq[blk]),
            *ours_st[:2], torch.from_numpy(bank),
            _opt(torch.from_numpy, carrier), *ours_st[2:], rds=rds)
        pallas = frontend_pallas.fused_frontend_if(
            jnp.asarray(bi[blk]), jnp.asarray(bq[blk]), *pallas_st[:2],
            jnp.asarray(bank), _opt(jnp.asarray, carrier), *pallas_st[2:],
            rds=rds, mm_dtype=jnp.float32, interpret=True)
        stock_fs, fo = jrx.front_step_if(
            jp, stock_fs, jnp.asarray(bi[blk]), jnp.asarray(bq[blk]), c,
            precision=lax.Precision.HIGHEST, rds_enabled=rds,
            frontend="stock")
        st = stock_fs
        stock = (*fo, st.rf.prev_i, st.rf.prev_q, st.bank_tail,
                 st.mono_delay, st.carrier_tail, st.rds_delay)
        for ref in (pallas, stock):
            _check(ours, ref, 1e-4, 0.0, names=IF_NAMES)
            for k in (5, 6):   # the input's last sample, exactly
                np.testing.assert_array_equal(ours[k].numpy(),
                                              np.asarray(ref[k]))
        np.testing.assert_array_equal(np.asarray(st.rf.iq_tail), tails[0])
        # carry each implementation's own state into the next block
        ours_st = [ours[5], ours[6], *ours[7:]]
        pallas_st = [pallas[5], pallas[6], *pallas[7:]]


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(2)
    blk = torch.from_numpy(rng.integers(0, 256, (C, cfg.block_size),
                                        dtype=np.uint8))
    jp = convert.params_from_numpy(jrx.make_params(cfg), device=DEV)
    args = (blk, jp.rf_coeff, jp.bank_coeff, jp.rds_carrier_coeff,
            *(torch.from_numpy(a) for a in _tails(rng)), cfg.rf_decim)
    before = frontend_cuda.fused_frontend_full.launches
    ours = frontend_cuda.fused_frontend_full(*args)
    plain = frontend_cuda.fused_frontend_full_plain(*args)
    assert frontend_cuda.fused_frontend_full.launches == before
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)

"""dy4tpu's A/B front ends in the port: the plain versions of B11
(``frontend_cuda.fused_frontend_raw``), B12 (``fused_frontend``) and B13
(``fused_frontend_raw_pm``), which are also what the wrappers and the
``front_step(frontend="fused-rf" | "fused-phase")`` routes run on CPU
tensors, against dy4tpu's Pallas kernels in interpret mode (float32
``mm_dtype``, as tests/test_frontend_pallas.py runs them) and dy4tpu's
``front_step`` / un-jitted ``receiver_step`` on the same routes.

C=3 over two blocks, each implementation carrying its own state.  Bars,
as tests/test_frontend_pallas.py's: fm within 1e-3 where the decimated
power is above 1e-3 (the demod's 1/power amplifies float32 rounding on the
random input's near-zero samples), ``iq_tail`` exact, ``prev_i``/
``prev_q`` within 1e-5; ``front_step``'s pilot within 2e-4; the receiver
within tests/test_torch_receiver.py's bars, after the PLLs' lock-in
(``fused_rf_runs``).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import fir as jfir  # noqa: E402
from dy4tpu.ops import frontend_pallas  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.tx import fm as jfm  # noqa: E402
from dy4tpu_torch.ops import frontend_cuda, iqcorr  # noqa: E402
from dy4tpu_torch.pipeline import convert  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402

C = 3
# port function, dy4tpu kernel
KERNELS = {
    "raw": (frontend_cuda.fused_frontend_raw_plain,
            frontend_pallas.fused_frontend_raw),
    "phase": (frontend_cuda.fused_frontend_plain,
              frontend_pallas.fused_frontend),
    "raw_pm": (frontend_cuda.fused_frontend_raw_pm_plain,
               frontend_pallas.fused_frontend_raw_pm),
}


def _state(rng, c, k):
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    return f(c, 2, k - 1), f(c), f(c)


def _power(blk, h, tail, decim):
    """Decimated I/Q power of the stock route (dy4tpu's ``fir``)."""
    x = (jnp.asarray(blk).astype(jnp.float32) - 128.0) / 128.0
    iq = jnp.moveaxis(x.reshape(blk.shape[0], -1, 2), -1, -2)
    iq_ds, _ = jfir.block_fir_decim(iq, jnp.asarray(h), jnp.asarray(tail),
                                    decim, precision=lax.Precision.HIGHEST)
    return np.asarray(iq_ds[..., 0, :] ** 2 + iq_ds[..., 1, :] ** 2)


def _check(ours, ref, power):
    fm, tail, pi, pq = (o.numpy() for o in ours)
    r_fm, r_tail, r_pi, r_pq = (np.asarray(r) for r in ref)
    assert fm.shape == r_fm.shape and tail.shape == r_tail.shape
    assert np.abs(fm - r_fm)[power > 1e-3].max() < 1e-3
    np.testing.assert_array_equal(tail, r_tail)
    np.testing.assert_allclose(pi, r_pi, atol=1e-5)
    np.testing.assert_allclose(pq, r_pq, atol=1e-5)


def _two_blocks(which, mode, seed, n_blocks=2):
    """Two random u8 blocks through the port's plain version and dy4tpu's
    kernel, each carrying its own state."""
    cfg = get_mode(mode)
    ours_fn, theirs_fn = KERNELS[which]
    rng = np.random.default_rng(seed)
    h = np.asarray(jrx.make_params(cfg).rf_coeff)
    st = _state(rng, C, cfg.num_taps)
    ours_st = [torch.from_numpy(a) for a in st]
    theirs_st = [jnp.asarray(a) for a in st]
    for _ in range(n_blocks):
        blk = rng.integers(0, 256, (C, cfg.block_size), dtype=np.uint8)
        ours = ours_fn(torch.from_numpy(blk), torch.from_numpy(h), *ours_st,
                       cfg.rf_decim)
        theirs = theirs_fn(jnp.asarray(blk), jnp.asarray(h), *theirs_st,
                           cfg.rf_decim, mm_dtype=jnp.float32, interpret=True)
        _check(ours, theirs, _power(blk, h, theirs_st[0], cfg.rf_decim))
        ours_st, theirs_st = list(ours[1:]), list(theirs[1:])


@pytest.mark.parametrize("mode", [0, 1])
def test_raw_matches_dy4tpu_two_blocks(mode):
    """B11's plain version against ``fused_frontend_raw``
    (tests/test_frontend_pallas.py's raw_matches_stock_two_blocks)."""
    _two_blocks("raw", mode, 2)


@pytest.mark.parametrize("mode", [0, 1])
def test_phase_matches_dy4tpu_two_blocks(mode):
    """B12's plain version (phase planes, one correlation over the D
    phases) against ``fused_frontend``."""
    _two_blocks("phase", mode, 3)


@pytest.mark.parametrize("mode", [0, 1])
def test_raw_pm_matches_dy4tpu_and_raw(mode):
    """B13's plain version (the rows as int32 words, bytes taken apart)
    against ``fused_frontend_raw_pm`` on one block (its interpret run is
    the slowest of the three; test_frontend_pallas.py's raw_pm_matches_raw
    takes one too) and, bit for bit, against B11's."""
    _two_blocks("raw_pm", mode, 6, n_blocks=1)
    cfg = get_mode(mode)
    rng = np.random.default_rng(7)
    blk = torch.from_numpy(rng.integers(0, 256, (C, cfg.block_size),
                                        dtype=np.uint8))
    h = torch.from_numpy(np.asarray(jrx.make_params(cfg).rf_coeff))
    st = [torch.from_numpy(a) for a in _state(rng, C, cfg.num_taps)]
    a = frontend_cuda.fused_frontend_raw_plain(blk, h, *st, cfg.rf_decim)
    b = frontend_cuda.fused_frontend_raw_pm_plain(blk, h, *st, cfg.rf_decim)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("k,decim", [(51, 4), (129, 8), (75, 3)])
def test_raw_geometry_fuzz(k, decim):
    """B11 and B13 at geometries of no mode: taps that do not phase-align
    to the decimation, odd K (test_frontend_pallas.py's raw fuzz); B12
    where the taps align (129, 8) and its refusal where they do not."""
    rng = np.random.default_rng(k * decim)
    c, n_out = 2, 256
    bs = 2 * n_out * decim
    h = (rng.standard_normal(k) * 0.05).astype(np.float32)
    st = _state(rng, c, k)
    blk = rng.integers(0, 256, (c, bs), dtype=np.uint8)
    ref = frontend_pallas.fused_frontend_raw(
        jnp.asarray(blk), jnp.asarray(h), *(jnp.asarray(a) for a in st),
        decim, mm_dtype=jnp.float32, interpret=True)
    power = _power(blk, h, st[0], decim)
    args = (torch.from_numpy(blk), torch.from_numpy(h),
            *(torch.from_numpy(a) for a in st), decim)
    _check(frontend_cuda.fused_frontend_raw_plain(*args), ref, power)
    _check(frontend_cuda.fused_frontend_raw_pm_plain(*args), ref, power)
    if (k - 1) % decim == 0:
        _check(frontend_cuda.fused_frontend_plain(*args), ref, power)
    else:
        with pytest.raises(ValueError, match="phase-aligned"):
            frontend_cuda.fused_frontend_plain(*args)


def _broadcast_block(cfg, c):
    """One block of a constant-envelope stereo broadcast on c channels:
    on random u8 the demod's 1/power amplifies float32 differences."""
    base = jfm.synthesize(
        cfg, 1, left=jfm.tone(800.0, cfg.audio_fs, cfg.audio_per_block,
                              amp=0.7),
        right=jfm.tone(2400.0, cfg.audio_fs, cfg.audio_per_block, amp=0.7))
    return np.repeat(base.reshape(1, cfg.block_size), c, axis=0)


def _interpret(monkeypatch):
    """dy4tpu's A/B kernels in interpret mode (on the CPU a Pallas call
    needs it), as test_frontend_pallas.py's fused_flag test does."""
    for name in ("fused_frontend", "fused_frontend_raw"):
        monkeypatch.setattr(frontend_pallas, name, functools.partial(
            getattr(frontend_pallas, name), interpret=True))


@pytest.mark.parametrize("variant", ["fused-rf", "fused-phase"])
def test_front_step_ab_matches_dy4tpu(monkeypatch, variant):
    """``front_step(frontend=variant)`` against dy4tpu's on the same
    route (test_frontend_pallas.py's fused_flag_cpu_interpret), from a
    mid-stream state, every stream and tail."""
    _interpret(monkeypatch)
    cfg = get_mode(0)
    rng = np.random.default_rng(9)
    jp = jrx.make_params(cfg)
    js = jrx.init_state(cfg, batch=(C,))
    blk = _broadcast_block(cfg, C)
    jfs, _ = jrx.front_step(jp, jrx.front_state_of(js), jnp.asarray(blk),
                            cfg, frontend="stock")
    jfs = jfs._replace(rf=jfs.rf._replace(
        prev_i=jnp.asarray(rng.standard_normal(C).astype(np.float32))))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    ours_fs = rx.FrontState(rf=rx.RFState(*(t(a) for a in jfs.rf)),
                            mono_delay=t(jfs.mono_delay),
                            bank_tail=t(jfs.bank_tail),
                            carrier_tail=t(jfs.carrier_tail),
                            rds_delay=t(jfs.rds_delay))
    tp = convert.params_from_numpy(jp, device=DEV)
    jst, jfo = jrx.front_step(jp, jfs, jnp.asarray(blk), cfg,
                              frontend=variant,
                              precision=lax.Precision.HIGHEST)
    st, fo = rx.front_step(tp, ours_fs, torch.from_numpy(blk), cfg,
                           frontend=variant)
    np.testing.assert_allclose(fo.pilot.numpy(), np.asarray(jfo.pilot),
                               atol=2e-4)
    np.testing.assert_allclose(st.rf.iq_tail.numpy(),
                               np.asarray(jst.rf.iq_tail), atol=1e-6)
    for name in ("fm_delayed", "stereo_band", "carrier", "rds_delayed"):
        np.testing.assert_allclose(getattr(fo, name).numpy(),
                                   np.asarray(getattr(jfo, name)), atol=2e-4,
                                   err_msg=name)
    for name in ("bank_tail", "mono_delay", "carrier_tail", "rds_delay"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)), atol=2e-4,
                                   err_msg=name)
    np.testing.assert_allclose(st.rf.prev_i.numpy(), np.asarray(jst.rf.prev_i),
                               atol=1e-5)
    np.testing.assert_allclose(st.rf.prev_q.numpy(), np.asarray(jst.rf.prev_q),
                               atol=1e-5)


@pytest.fixture(scope="module")
def fused_rf_runs():
    """Blocks 1 and 2 of the noisy mode-0 broadcast (C=2, channel 1 I/Q-
    swapped) through the port's ``receiver_step(frontend="fused-rf")``
    and dy4tpu's un-jitted one on the same route, from dy4tpu's state
    after block 0.  Block 0 is the PLLs' lock-in from a cold state, which
    turns dy4tpu's own float32 differences into up to 1.4e-2 on L and R:
    its "fused-rf" kernel (whose -128*sum(h) epilogue cancels in float32)
    departs that far from its stock route on block 0, and from block 1 on
    both agree within about 1e-6, as the port does."""
    cfg = get_mode(0)
    c, n = 2, 3
    n_audio = n * cfg.audio_per_block
    iq = jfm.synthesize(cfg, n,
                        left=jfm.tone(800.0, cfg.audio_fs, n_audio, amp=0.7),
                        right=jfm.tone(2400.0, cfg.audio_fs, n_audio,
                                       amp=0.7),
                        noise=0.02, seed=5).reshape(n, 1, cfg.block_size)
    swapped = iq.reshape(n, 1, -1, 2)[..., ::-1].reshape(iq.shape)
    iq = np.concatenate([iq, swapped], axis=1)
    jp = jrx.make_params(cfg)
    tp = convert.params_from_numpy(jp, device=DEV)
    mp = pytest.MonkeyPatch()
    _interpret(mp)
    out = []
    try:
        js, _ = jrx.receiver_step(jp, jrx.init_state(cfg, batch=(c,)),
                                  jnp.asarray(iq[0]), cfg,
                                  frontend="fused-rf")
        ts = convert.state_from_numpy(js, device=DEV)
        for b in range(1, n):
            js, jo = jrx.receiver_step(jp, js, jnp.asarray(iq[b]), cfg,
                                       frontend="fused-rf")
            ts, to = rx.receiver_step(tp, ts, torch.from_numpy(iq[b]), cfg,
                                      frontend="fused-rf")
            out.append((js, jo, ts, to))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("field", rx.StepOutputs._fields)
def test_receiver_step_fused_rf_matches_dy4tpu(fused_rf_runs, field):
    atol = 1e-3 if field == "pilot_snr_db" else 1e-4
    for b, (_, jo, _, to) in enumerate(fused_rf_runs):
        ours, ref = getattr(to, field).numpy(), np.asarray(getattr(jo, field))
        assert ours.dtype == ref.dtype, field
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(ours, ref, atol=atol,
                                       err_msg=f"{field}[{b}]")
        else:
            np.testing.assert_array_equal(ours, ref, err_msg=f"{field}[{b}]")


def test_receiver_state_fused_rf_matches_dy4tpu(fused_rf_runs):
    for b, (js, _, ts, _) in enumerate(fused_rf_runs):
        ours = convert.state_to_numpy(ts)
        ref = convert.leaves_by_path(js)
        assert ours.keys() == ref.keys()
        for k, r in ref.items():
            if r.dtype.kind == "f":
                np.testing.assert_allclose(ours[k], r, atol=1e-4,
                                           err_msg=f"{k}[{b}]")
            else:
                np.testing.assert_array_equal(ours[k], r, err_msg=k)
        np.testing.assert_array_equal(ours["rf.iq_tail"], ref["rf.iq_tail"])


@pytest.mark.parametrize("k,decim", [(51, 4), (75, 3)])
def test_ab_routes_refuse(k, decim):
    """As dy4tpu's ``front_step``: an IQ correction on an A/B route,
    "fused-phase" where the taps do not phase-align; and the IF entry,
    which has no RF stage, takes no A/B route."""
    cfg0 = get_mode(0)
    cfg = dataclasses.replace(cfg0, num_taps=k, rf_decim=decim)
    assert not rx.fused_phase_frontend_ok(cfg)
    assert rx.fused_phase_frontend_ok(cfg0)
    assert all(rx.fused_phase_frontend_ok(get_mode(m)) for m in range(4))
    params = rx.make_params(cfg, device=DEV)
    fs = rx.front_state_of(rx.init_state(cfg, (1,), device=DEV))
    blk = torch.full((1, 2 * decim * 256), 128, dtype=torch.uint8)
    with pytest.raises(ValueError, match="phase-aligned"):
        rx.front_step(params, fs, blk, cfg, frontend="fused-phase")
    # the raw route takes this geometry
    _, fo = rx.front_step(params, fs, blk, cfg, frontend="fused-rf")
    assert fo.pilot.shape == (1, 256)
    corr = iqcorr.coeffs(iqcorr.init_iqcorr_state((1,), device="cpu"))
    for variant in ("fused-rf", "fused-phase"):
        with pytest.raises(ValueError, match="IQ correction unsupported"):
            rx.front_step(params, fs, blk, cfg, frontend=variant, corr=corr)
        i_if = torch.zeros(1, cfg0.if_per_block)
        with pytest.raises(ValueError, match="frontend must be one of"):
            rx.front_step_if(rx.make_params(cfg0, device=DEV),
                             rx.front_state_of(rx.init_state(
                                 cfg0, (1,), device=DEV)),
                             i_if, i_if, cfg0, frontend=variant)


def test_wrappers_on_cpu_run_the_plain_versions():
    """On CPU tensors B11, B12 and B13 take their plain versions and
    count no launch."""
    cfg = get_mode(1)
    rng = np.random.default_rng(12)
    blk = torch.from_numpy(rng.integers(0, 256, (C, cfg.block_size),
                                        dtype=np.uint8))
    h = torch.from_numpy(np.asarray(jrx.make_params(cfg).rf_coeff))
    args = (blk, h, *(torch.from_numpy(a) for a in
                      _state(rng, C, cfg.num_taps)), cfg.rf_decim)
    for wrap, plain in ((frontend_cuda.fused_frontend_raw,
                         frontend_cuda.fused_frontend_raw_plain),
                        (frontend_cuda.fused_frontend,
                         frontend_cuda.fused_frontend_plain),
                        (frontend_cuda.fused_frontend_raw_pm,
                         frontend_cuda.fused_frontend_raw_pm_plain)):
        before = wrap.launches
        for a, b in zip(wrap(*args), plain(*args)):
            assert torch.equal(a, b)
        assert wrap.launches == before

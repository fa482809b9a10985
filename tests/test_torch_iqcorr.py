"""The port's narrowband IQ tracker (dy4tpu_torch.ops.iqcorr ``estimate``,
``coeffs``, ``apply``; B1's corr route; the receiver's ``iqcorr`` state)
against dy4tpu's, on the CPU, with the tuner fault of dy4tpu's own
tests/test_iqcorr.py.

Bars: moments to a relative 1e-5 (float32 means of the same products,
summed in another order); the coefficients to 1e-4 (a float32 5x5
Cholesky in the same op order on moments that differ by rounding);
corrected I/Q, front-end streams, receiver outputs and state leaves to
atol 1e-4 (float32 sums in another order; measured about 1e-6), and every
decision exact (RDS symbols, resync, CDR offsets, the tracker's block
count).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import iqcorr as jiq  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.rds import coding  # noqa: E402
from dy4tpu.tx import fm as jfm  # noqa: E402
from dy4tpu_torch.ops import frontend_cuda, iqcorr  # noqa: E402
from dy4tpu_torch.pipeline import convert  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402

# tests/test_iqcorr.py's fault: 3.1 dB gain skew, 25 deg quadrature
# error, LO leakage about 15/10 u8 LSB
GAIN, PHASE, DCI, DCQ = 0.7, 25.0, 0.12, -0.08
cfg = get_mode(0)


def _impaired_fm_iq(n, seed=0, **fault):
    """A unit-modulus FM-like complex stream and its impaired
    observation (float32), as test_iqcorr.py's helper."""
    rng = np.random.default_rng(seed)
    phase = np.cumsum(1.5 * rng.standard_normal(n))
    fault = fault or dict(dc_i=DCI, dc_q=DCQ, gain=GAIN, phase_deg=PHASE)
    io, qo = iqcorr.impair(np.cos(phase), np.sin(phase), **fault)
    return io.astype(np.float32), qo.astype(np.float32)


def _coeffs_close(ours, ref, atol=1e-4):
    for name, a, b in zip(ours._fields, ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   err_msg=name)


def test_estimator_inverts_model():
    """The port's estimate + coeffs recover the model parameters with
    test_iqcorr.py's bars, and equal dy4tpu's on the same blocks."""
    io, qo = _impaired_fm_iq(1 << 16)
    st = iqcorr.init_iqcorr_state()
    jst = jiq.init_iqcorr_state()
    for blk in np.split(np.arange(1 << 16), 16):
        st = iqcorr.estimate(torch.from_numpy(io[blk]),
                             torch.from_numpy(qo[blk]), st)
        jst = jiq.estimate(jnp.asarray(io[blk]), jnp.asarray(qo[blk]), jst)
    np.testing.assert_allclose(st.m.numpy(), np.asarray(jst.m), rtol=1e-5)
    assert int(st.count) == 16 and st.count.dtype == torch.int32
    c = iqcorr.coeffs(st)
    assert abs(float(c.dc_i) - DCI) < 5e-3
    assert abs(float(c.dc_q) - DCQ) < 5e-3
    phi = np.deg2rad(PHASE)
    assert abs(float(c.rho) - GAIN * np.sin(phi)) < 2e-2
    assert abs(float(c.s) - 1.0 / (GAIN * np.cos(phi))) < 2e-2
    _coeffs_close(c, jiq.coeffs(jst))


def test_coeffs_and_apply_match_dy4tpu():
    """A batch of three faults (one healthy tuner inside the deadbands):
    the same moments through both packages' ``coeffs``, then ``apply``
    with a DC scale."""
    faults = [dict(dc_i=DCI, dc_q=DCQ, gain=GAIN, phase_deg=PHASE),
              dict(dc_i=-0.05, dc_q=0.03, gain=1.15, phase_deg=-8.0),
              dict(dc_i=0.001, dc_q=0.0, gain=1.0, phase_deg=0.2)]
    io, qo = (np.stack(a) for a in zip(*(
        _impaired_fm_iq(4096, seed=k, **f) for k, f in enumerate(faults))))
    mom = iqcorr.moments(torch.from_numpy(io), torch.from_numpy(qo))
    jmom = jiq.moments(jnp.asarray(io), jnp.asarray(qo))
    np.testing.assert_allclose(mom.numpy(), np.asarray(jmom), rtol=1e-5,
                               atol=1e-7)
    # one state for both: the coefficients' gap is the solve's alone
    m = np.asarray(jmom)
    st = iqcorr.IQCorrState(m=torch.from_numpy(m.copy()),
                            count=torch.ones(3, dtype=torch.int32))
    c = iqcorr.coeffs(st)
    jc = jiq.coeffs(jiq.IQCorrState(m=jnp.asarray(m),
                                    count=jnp.ones(3, jnp.int32)))
    _coeffs_close(c, jc)
    # the healthy tuner snaps to the exact identity in both
    assert (float(c.dc_i[2]), float(c.dc_q[2]), float(c.rho[2]),
            float(c.s[2])) == (0.0, 0.0, 0.0, 1.0)
    ic, qc = iqcorr.apply(torch.from_numpy(io), torch.from_numpy(qo), c,
                          dc_scale=0.5)
    jic, jqc = jiq.apply(jnp.asarray(io), jnp.asarray(qo), jc, dc_scale=0.5)
    np.testing.assert_allclose(ic.numpy(), np.asarray(jic), atol=1e-4)
    np.testing.assert_allclose(qc.numpy(), np.asarray(jqc), atol=1e-4)


def test_coeffs_identity_guards():
    """Fresh state and too-weak streams yield the identity, so ``apply``
    is always safe (test_iqcorr.py's guard test on the port)."""
    for st in (iqcorr.init_iqcorr_state((3,)),
               iqcorr.estimate(torch.zeros(3, 64) + 1e-5,
                               torch.zeros(3, 64),
                               iqcorr.init_iqcorr_state((3,)))):
        c = iqcorr.coeffs(st)
        np.testing.assert_array_equal(c.dc_i.numpy(), 0.0)
        np.testing.assert_array_equal(c.rho.numpy(), 0.0)
        np.testing.assert_array_equal(c.s.numpy(), 1.0)
        i = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (3, 64)).astype(np.float32))
        ic, qc = iqcorr.apply(i, i + 1.0, c)
        assert torch.equal(ic, i) and torch.equal(qc, i + 1.0)


def _impaired_blocks(n_blocks, c=2):
    """[n_blocks, c, block] u8: the fault on a tone broadcast; channel 1
    has its I/Q legs swapped (every row differs)."""
    n_audio = n_blocks * cfg.audio_per_block
    bits = coding.make_ps_bitstream(fm.PI_CODE, 10, fm.PS_NAME, repeats=4)
    iq = fm.synthesize(cfg, n_blocks, dc_i=DCI, dc_q=DCQ, iq_gain=GAIN,
                       iq_phase_deg=PHASE,
                       left=fm.tone(800.0, cfg.audio_fs, n_audio, amp=0.7),
                       right=fm.tone(2400.0, cfg.audio_fs, n_audio, amp=0.7),
                       rds_bits=bits).reshape(n_blocks, 1, cfg.block_size)
    swapped = iq.reshape(n_blocks, 1, -1, 2)[..., ::-1].reshape(iq.shape)
    return np.concatenate([iq, swapped], axis=1)[:, :c]


def test_fused_full_corr_matches_stock():
    """B1's corr route (its plain version on the CPU) and
    ``front_step(frontend="plain", corr=..., corr_moments=True)`` against
    dy4tpu's stock ``front_step`` with the same coefficients, over two
    blocks (block 1 with non-trivial histories)."""
    c = 2
    blocks = _impaired_blocks(2, c)
    jp = jrx.make_params(cfg)
    tp = convert.params_from_numpy(jp, device=DEV)
    jfs = jrx.front_state_of(jrx.init_state(cfg, batch=(c,)))
    fs = rx.front_state_of(rx.init_state(cfg, (c,), device=DEV))
    phi = np.deg2rad(PHASE)
    coef = np.array([[DCI * 100 / 128, DCQ * 100 / 128,
                      GAIN * np.sin(phi), 1.0 / (GAIN * np.cos(phi))],
                     [0.03, -0.02, -0.1, 0.95]], np.float32)
    jcorr = jiq.IQCorrCoeffs(*(jnp.asarray(coef[:, k]) for k in range(4)))
    corr = iqcorr.IQCorrCoeffs(*torch.from_numpy(coef).unbind(-1))
    for b in range(2):
        blk = torch.from_numpy(blocks[b])
        jfs2, jfo, jmom = jrx.front_step(
            jp, jfs, jnp.asarray(blocks[b]), cfg, frontend="stock",
            corr=jcorr, corr_moments=True)
        fs2, fo, mom = rx.front_step(tp, fs, blk, cfg, frontend="plain",
                                     corr=corr, corr_moments=True)
        k = frontend_cuda.fused_frontend_full(
            blk, tp.rf_coeff, tp.bank_coeff, tp.rds_carrier_coeff,
            fs.rf.iq_tail, fs.rf.prev_i, fs.rf.prev_q, fs.bank_tail,
            fs.mono_delay, fs.carrier_tail, fs.rds_delay, cfg.rf_decim,
            corr=torch.from_numpy(coef))
        for name, ours, auto, ref in zip(
                rx.FrontOut._fields, fo, k[:5], jfo):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       atol=1e-4, err_msg=name)
            assert torch.equal(ours, auto), name
        np.testing.assert_allclose(mom.numpy(), np.asarray(jmom), rtol=1e-5,
                                   atol=1e-7)
        assert torch.equal(mom, k[12])
        ours = convert.leaves_by_path(fs2)
        for key, ref in convert.leaves_by_path(jfs2).items():
            np.testing.assert_allclose(ours[key], ref, atol=1e-4,
                                       err_msg=key)
        jfs, fs = jfs2, fs2


@pytest.fixture(scope="module")
def tracker_runs():
    """Two blocks of the impaired broadcast through both packages'
    tracker-on ``receiver_step`` (dy4tpu un-jitted), C=2."""
    c, n = 2, 2
    blocks = _impaired_blocks(n, c)
    jp = jrx.make_params(cfg)
    tp = convert.params_from_numpy(jp, device=DEV)
    js = jrx.init_state(cfg, batch=(c,), with_iqcorr=True)
    ts = rx.init_state(cfg, (c,), with_iqcorr=True, device=DEV)
    out = []
    for b in range(n):
        js, jo = jrx.receiver_step(jp, js, jnp.asarray(blocks[b]), cfg,
                                   frontend="stock")
        ts, to = rx.receiver_step(tp, ts, torch.from_numpy(blocks[b]), cfg)
        out.append((js, jo, ts, to))
    return out


@pytest.mark.parametrize("field", rx.StepOutputs._fields)
def test_receiver_step_iqcorr_matches_dy4tpu(tracker_runs, field):
    atol = 1e-3 if field == "pilot_snr_db" else 1e-4
    for b, (_, jo, _, to) in enumerate(tracker_runs):
        ours, ref = getattr(to, field), np.asarray(getattr(jo, field))
        assert ours.numpy().dtype == ref.dtype, field
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(ours.numpy(), ref, atol=atol,
                                       err_msg=f"{field}[{b}]")
        else:
            np.testing.assert_array_equal(ours.numpy(), ref,
                                          err_msg=f"{field}[{b}]")


def test_receiver_iqcorr_state_matches_dy4tpu(tracker_runs):
    """Every state leaf after every block, the tracker's moments to a
    relative 1e-5 and its block count exact (int32)."""
    for b, (js, _, ts, _) in enumerate(tracker_runs):
        ours = convert.state_to_numpy(ts)
        ref = convert.leaves_by_path(js)
        assert ours.keys() == ref.keys()
        for k, r in ref.items():
            assert ours[k].dtype == r.dtype, k
            if k == "iqcorr.m":
                np.testing.assert_allclose(ours[k], r, rtol=1e-5, atol=1e-7)
            elif r.dtype.kind == "f":
                np.testing.assert_allclose(ours[k], r, atol=1e-4,
                                           err_msg=f"{k}[{b}]")
            else:
                np.testing.assert_array_equal(ours[k], r, err_msg=k)
        assert ours["iqcorr.count"].tolist() == [b + 1] * 2
    # mid-stream hand-off: dy4tpu's tracker state crosses over intact
    st = convert.state_from_numpy(tracker_runs[-1][0], device=DEV)
    assert st.iqcorr.count.dtype == torch.int32


def test_receiver_step_if_iqcorr_runs():
    """The IF entry with the tracker (estimate and apply in torch, then
    B6's plain version): the state advances, outputs stay finite, and it
    matches dy4tpu's un-jitted step on the first block."""
    n = cfg.if_per_block
    rng = np.random.default_rng(3)
    phase = np.cumsum(0.3 * rng.standard_normal(2 * n))
    i, q = iqcorr.impair(np.cos(phase), np.sin(phase), dc_i=0.05,
                         gain=1.1, phase_deg=5.0)
    i = i.astype(np.float32).reshape(2, 1, n)
    q = q.astype(np.float32).reshape(2, 1, n)
    params = rx.make_params(cfg, device=DEV)
    st = rx.init_state(cfg, (1,), with_iqcorr=True, device=DEV)
    outs = []
    for b in range(2):
        st, o = rx.receiver_step_if(params, st, torch.from_numpy(i[b]),
                                    torch.from_numpy(q[b]), cfg)
        outs.append(o)
    assert int(st.iqcorr.count[0]) == 2
    assert all(bool(torch.isfinite(o.mono).all()) for o in outs)
    assert float(st.iqcorr.m[0, iqcorr._IDX[(2, 0)]]) > 0.0   # E[i^2]
    js, jo = jrx.receiver_step_if(
        jrx.make_params(cfg), jrx.init_state(cfg, batch=(1,),
                                             with_iqcorr=True),
        jnp.asarray(i[0]), jnp.asarray(q[0]), cfg, frontend="stock")
    np.testing.assert_allclose(outs[0].mono.numpy(), np.asarray(jo.mono),
                               atol=1e-4)


def test_clean_capture_bit_identical():
    """Deadband property: on a healthy tuner the tracker snaps to the
    exact identity, so the tracker-on decode equals tracker-off bit for
    bit (test_iqcorr.py's property on the port)."""
    n_blocks = 3
    n_audio = n_blocks * cfg.audio_per_block
    iq = fm.synthesize(cfg, n_blocks,
                       left=fm.tone(800.0, cfg.audio_fs, n_audio, amp=0.8),
                       right=fm.tone(2400.0, cfg.audio_fs, n_audio, amp=0.8))
    params = rx.make_params(cfg, device=DEV)
    blocks = torch.from_numpy(iq.reshape(n_blocks, 1, cfg.block_size))

    def run(with_iqcorr):
        st = rx.init_state(cfg, (1,), with_iqcorr=with_iqcorr, device=DEV)
        return rx.run_blocks(params, st, blocks, cfg)

    (_, a), (st, b) = run(False), run(True)
    assert int(st.iqcorr.count[0]) == n_blocks
    for x, y in [(a.mono, b.mono), (a.left, b.left), (a.right, b.right),
                 (a.rds_symbols, b.rds_symbols)]:
        assert torch.equal(x, y)

"""The IQ tracker's recovery contracts on the port (plain paths on the CPU):
the twins of tests/test_iqcorr.py's image-rejection (:66), end-to-end
stereo recovery (:122), A/B refusal (:225), multipath recovery (:263) and
ellipse-fit fuzz (:294) cases, at their bars.

Held to dy4tpu on the same inputs:

- the tracker's coefficients to 1e-4 (tests/test_torch_iqcorr.py's bar:
  a float32 5x5 Cholesky in the same op order on moments that differ by
  rounding), trial by trial in the fuzz, and the corrected I/Q to atol
  1e-4;
- the receiver runs (mode 0; tracker off: the clean, faulted and
  multipath captures as one batch, tracker on: the faulted and multipath
  ones) against dy4tpu's un-jitted ``receiver_step`` (``dy4tpu_window``)
  over their first 3 blocks (block 0 uncorrected, then the tracker's
  first two corrections): RDS hard symbols, resync flags and CDR offsets
  equal, audio and RDS baseband within atol 1e-4, the pilot SNR within
  1e-3 dB.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.ops import iqcorr as jiq  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.ops import iqcorr  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402

import dy4tpu_window as dw  # noqa: E402
from torch_batch import run_batch  # noqa: E402

# tests/test_iqcorr.py's tuner fault
GAIN, PHASE, DCI, DCQ = 0.7, 25.0, 0.12, -0.08
COEFF_TOL, STREAM_TOL = 1e-4, 1e-4
WINDOW_LEN = 3
cfg = get_mode(0)


def _close_coeffs(ours, ref, where):
    for name, a, b in zip(ours._fields, ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=COEFF_TOL,
                                   err_msg=f"{where} {name}")


def _track(io, qo, n_split, **coeff_kw):
    """Both packages' tracker over ``n_split`` blocks of float32 I/Q:
    the port's and dy4tpu's coefficients."""
    io, qo = io.astype(np.float32), qo.astype(np.float32)
    st = iqcorr.init_iqcorr_state(device="cpu")
    jst = jiq.init_iqcorr_state()
    for blk in np.split(np.arange(len(io)), n_split):
        st = iqcorr.estimate(torch.from_numpy(io[blk]),
                             torch.from_numpy(qo[blk]), st)
        jst = jiq.estimate(jnp.asarray(io[blk]), jnp.asarray(qo[blk]), jst)
    return iqcorr.coeffs(st, **coeff_kw), jiq.coeffs(jst, **coeff_kw)


def _apply_both(io, qo, c, jc):
    io, qo = io.astype(np.float32), qo.astype(np.float32)
    ic, qc = iqcorr.apply(torch.from_numpy(io), torch.from_numpy(qo), c)
    jic, jqc = jiq.apply(jnp.asarray(io), jnp.asarray(qo), jc)
    np.testing.assert_allclose(ic.numpy(), np.asarray(jic), atol=STREAM_TOL)
    np.testing.assert_allclose(qc.numpy(), np.asarray(jqc), atol=STREAM_TOL)
    return ic.numpy(), qc.numpy()


def test_image_rejection_improves():
    """A complex tone at +f: the fault images it onto -f at the model's
    IRR; the correction buys >= 25 dB more rejection."""
    n, fbin = 4096, 300
    x = np.exp(2j * np.pi * fbin * np.arange(n) / n)
    io, qo = iqcorr.impair(x.real, x.imag, dc_i=DCI, dc_q=DCQ, gain=GAIN,
                           phase_deg=PHASE)
    c, jc = _track(io, qo, 8)
    _close_coeffs(c, jc, "image rejection")
    ic, qc = _apply_both(io, qo, c, jc)

    def image_db(i_, q_):
        spec = np.fft.fft(np.asarray(i_) + 1j * np.asarray(q_))
        return 20 * np.log10(np.abs(spec[-fbin]) / np.abs(spec[fbin]))

    before = image_db(io, qo)
    after = image_db(ic, qc)
    assert abs(-before - iqcorr.image_rejection_db(GAIN, PHASE)) < 1.0
    assert before - after > 25.0, (before, after)


def test_ellipse_fit_fuzz():
    """For random in-range faults the fit inverts the model; each trial's
    coefficients equal dy4tpu's within 1e-4."""
    rng = np.random.default_rng(42)
    n = 1 << 14
    phase = np.cumsum(1.2 * rng.standard_normal(n))
    i, q = np.cos(phase), np.sin(phase)
    for trial in range(12):
        g = float(rng.uniform(0.5, 1.4))
        ph = float(rng.uniform(-35.0, 35.0))
        di = float(rng.uniform(-0.2, 0.2))
        dq = float(rng.uniform(-0.2, 0.2))
        io, qo = iqcorr.impair(i, q, dc_i=di, dc_q=dq, gain=g,
                               phase_deg=ph)
        c, jc = _track(io, qo, 1, deadband=0.0, deadband_dc=0.0)
        _close_coeffs(c, jc, f"trial {trial}")
        phi = np.deg2rad(ph)
        assert abs(float(c.dc_i) - di) < 5e-3, (trial, g, ph, di, dq)
        assert abs(float(c.dc_q) - dq) < 5e-3
        assert abs(float(c.rho) - g * np.sin(phi)) < 1.5e-2
        assert abs(float(c.s) - 1.0 / (g * np.cos(phi))) < 1.5e-2
        ic, qc = _apply_both(io, qo, c, jc)
        err = np.hypot(ic - i, qc - q)
        assert np.sqrt(np.mean(err ** 2)) < 0.02, (trial, g, ph)


def test_iqcorr_rejected_on_ab_frontends():
    """The A/B front ends take no correction, in both packages."""
    st = rx.init_state(cfg, with_iqcorr=True, device="cpu")
    blk = torch.zeros(cfg.block_size, dtype=torch.uint8)
    with pytest.raises(ValueError, match="IQ correction"):
        rx.front_step(rx.make_params(cfg, device="cpu"),
                      rx.front_state_of(st), blk, cfg, frontend="fused-rf",
                      corr=iqcorr.coeffs(st.iqcorr))
    jst = jrx.init_state(cfg, with_iqcorr=True)
    with pytest.raises(ValueError, match="IQ correction"):
        jrx.front_step(jrx.make_params(cfg), jrx.front_state_of(jst),
                       jnp.zeros((cfg.block_size,), jnp.uint8), cfg,
                       frontend="fused-rf", corr=jiq.coeffs(jst.iqcorr))


def _tones(n_blocks, amp=0.8, **kw):
    n_audio = n_blocks * cfg.audio_per_block
    return fm.synthesize(cfg, n_blocks,
                         left=fm.tone(800.0, cfg.audio_fs, n_audio, amp=amp),
                         right=fm.tone(2400.0, cfg.audio_fs, n_audio,
                                       amp=amp),
                         **kw)


# test_iqcorr.py's captures: :122's clean and faulted 10 blocks, :263's
# 12 blocks through two echoes and a milder fault
CAPTURES = {
    "clean": lambda: _tones(10),
    "dirty": lambda: _tones(10, dc_i=DCI, dc_q=DCQ, iq_gain=GAIN,
                            iq_phase_deg=PHASE),
    "multipath": lambda: _tones(
        12, multipath=[(24, 0.35 * np.exp(1j * 2.0)),
                       (60, 0.2 * np.exp(-1j * 0.7))],
        dc_i=0.1, dc_q=-0.06, iq_gain=0.72, iq_phase_deg=18.0),
}
RUNS = {False: ("clean", "dirty", "multipath"), True: ("dirty", "multipath")}


@pytest.fixture(scope="module")
def runs():
    """{tracker on/off: (captures, the port's outputs, dy4tpu's first
    WINDOW_LEN blocks)}: each set one batch in both packages."""
    caps = {name: make() for name, make in CAPTURES.items()}
    got = {}
    for on, names in RUNS.items():
        batch = [caps[n] for n in names]
        outs = run_batch(cfg, batch, init_kwargs=dict(with_iqcorr=on))
        zero = rx.init_state(cfg, (len(batch),), with_iqcorr=on,
                             device="cpu")
        blocks = np.stack([c.reshape(-1, cfg.block_size)[:WINDOW_LEN]
                           for c in batch], axis=1)
        ref = dw.run(cfg, dw.rows(zero, slice(None)), blocks,
                     frontend="stock")
        got[on] = (dict(zip(names, batch)), outs, ref)
    return got


def _sep_db(runs, on, name):
    """test_iqcorr.py's separation (the worse side) over the capture's
    blocks from 4."""
    caps, outs, _ = runs[on]
    ch = RUNS[on].index(name)
    n = len(caps[name]) // cfg.block_size
    return min(fm.stereo_separation_db(cfg, outs.left[:n, ch].numpy(),
                                       outs.right[:n, ch].numpy(),
                                       skip_blocks=4))


def _twin(runs, on, name):
    _, outs, ref = runs[on]
    ch = RUNS[on].index(name)
    ours = dw.numpy_outputs(outs, slice(0, WINDOW_LEN), [ch])
    dw.assert_twins({f: ours[f][:, 0] for f in ref},
                    {f: v[:, ch] for f, v in ref.items()},
                    f"{name}, tracker {'on' if on else 'off'}")


def test_e2e_stereo_recovery(runs):
    """The fault costs >= 10 dB of separation; the tracker wins >= 8 dB
    of it back (block 0 runs uncorrected)."""
    sep_clean = _sep_db(runs, False, "clean")
    sep_dirty = _sep_db(runs, False, "dirty")
    sep_fixed = _sep_db(runs, True, "dirty")
    assert sep_clean - sep_dirty > 10.0, (sep_clean, sep_dirty)
    assert sep_fixed - sep_dirty > 8.0, (sep_fixed, sep_dirty)
    assert sep_fixed > sep_clean - 4.0, (sep_fixed, sep_clean)
    for on, name in ((False, "clean"), (False, "dirty"), (True, "dirty")):
        _twin(runs, on, name)


def test_recovery_under_multipath(runs):
    """Two echoes thicken the circle into an annulus; the fit still
    corrects an imbalanced, offset tuner by >= 8 dB, to above 28 dB."""
    off = _sep_db(runs, False, "multipath")
    on = _sep_db(runs, True, "multipath")
    assert on - off > 8.0, (off, on)
    assert on > 28.0, on
    _twin(runs, False, "multipath")
    _twin(runs, True, "multipath")

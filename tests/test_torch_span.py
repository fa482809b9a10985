"""The port's span PLL (``pll.pll(span=K)``: ``_span_targets``, the span
scan of B9's plain version, ``_span_expand``) against dy4tpu's
``pll(span=K, impl="scan")``, and the receiver with ``pll_span=8``
against dy4tpu's un-jitted ``receiver_step`` under ``DY4TPU_PLL_SPAN=8``.

Bars: the span constants bit-equal (float32 numpy in dy4tpu's op order);
the NCO and the carry within 2e-4 of dy4tpu (the span targets pass
through cos, sin and atan2, whose float32 results differ by an ulp
between torch and XLA; measured about 1e-5); receiver outputs and state
within 1e-4, decisions exact.  Inside the port the span PLL is exactly
reproducible: two chained blocks equal one block of twice the length, bit
for bit (chip_smoke.py holds B9 bitwise to this plain scan on the card).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import pll as jpll  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.rds import coding  # noqa: E402
from dy4tpu.tx import fm as jfm  # noqa: E402
from dy4tpu_torch.ops import pll, pll_cuda  # noqa: E402
from dy4tpu_torch.pipeline import convert  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402

SPAN = 8
cfg = get_mode(0)
N = cfg.if_per_block
LANES = dict(freq=np.array([cfg.pll_freq, cfg.rds_pll_freq], np.float32),
             fs=cfg.if_fs,
             nco_scale=np.array([cfg.pll_nco_scale, cfg.rds_pll_nco_scale],
                                np.float32),
             norm_bandwidth=np.array([cfg.pll_bandwidth,
                                      cfg.rds_pll_bandwidth], np.float32))
PILOT = dict(freq=cfg.pll_freq, fs=cfg.if_fs, nco_scale=cfg.pll_nco_scale,
             norm_bandwidth=cfg.pll_bandwidth)


def _tones(rng, c, n):
    """[c, 2, n]: a noisy 19 kHz pilot and 114 kHz carrier per channel,
    with a dead (all-zero) span at the start and a zero sample inside a
    later span."""
    t = np.arange(n) / cfg.if_fs
    ph = rng.uniform(0, 2 * np.pi, (c, 2, 1))
    f = np.array([19e3, 114e3])[None, :, None]
    x = np.cos(2 * np.pi * f * t + ph) + 0.3 * rng.standard_normal((c, 2, n))
    x[:, :, :SPAN] = 0.0
    x[:, :, 100] = 0.0
    return x.astype(np.float32)


def _state(rng, batch):
    z = lambda lo, hi: rng.uniform(lo, hi, batch).astype(np.float32)  # noqa: E731
    return dict(feedback_i=z(-1, 1), feedback_q=z(-1, 1),
                integrator=z(-1e-3, 1e-3), phase_est=z(0, 4 * np.pi),
                angle=z(0, 4 * np.pi), nco=z(-1, 1), nco_q=z(-1, 1))


@pytest.mark.parametrize("kw", [LANES, PILOT], ids=["lanes", "pilot"])
def test_span_consts_bit_equal(kw):
    """kp_eff, ki_eff, dth_eff as dy4tpu's ``_make_span_step`` computes
    them (pll.py:154-160), in float32."""
    kp, ki, dth = jpll._loop_consts(kw["freq"], kw["fs"],
                                    kw["norm_bandwidth"],
                                    np.dtype(np.float32))
    f = np.float32
    k = f(SPAN)
    wrap = f(jpll._WRAP)
    ref = (k * kp + ki * f(SPAN * (SPAN + 1) / 2.0), k * ki,
           (k * jnp.asarray(dth)) - wrap * jnp.floor(
               (k * jnp.asarray(dth)) / wrap))
    ours = pll._span_consts(*pll._loop_consts(
        kw["freq"], kw["fs"], kw["norm_bandwidth"]), SPAN)
    assert ours[0] == k
    for o, r in zip(ours[1:], ref):
        assert np.asarray(o).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(o), np.asarray(r))


def test_span_targets_match_dy4tpu():
    rng = np.random.default_rng(4)
    x = _tones(rng, 2, N)
    dth = pll._loop_consts(LANES["freq"], cfg.if_fs,
                           LANES["norm_bandwidth"])[2]
    ours = pll._span_targets(torch.from_numpy(x), torch.from_numpy(dth),
                             SPAN).numpy()
    ref = np.asarray(jpll._span_targets(jnp.asarray(x), jnp.asarray(dth),
                                        SPAN, np.dtype(np.float32)))
    assert ours.shape == (2, 2, N // SPAN)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert np.isnan(ours[..., 0]).all()          # the dead first span
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("kw", [LANES, PILOT], ids=["lanes", "pilot"])
def test_span_pll_matches_dy4tpu(kw):
    rng = np.random.default_rng(0)
    x = _tones(rng, 3, N)
    if kw is PILOT:
        x = x[:, 0]
    st = _state(rng, x.shape[:-1])
    ni, nq, ns = pll.pll(torch.from_numpy(x),
                         pll.PLLState(**{k: torch.from_numpy(v)
                                         for k, v in st.items()}),
                         impl="plain", span=SPAN, **kw)
    jni, jnq, jns = jpll.pll(jnp.asarray(x),
                             jpll.PLLState(**{k: jnp.asarray(v)
                                              for k, v in st.items()}),
                             impl="scan", span=SPAN, **kw)
    np.testing.assert_allclose(ni.numpy(), np.asarray(jni), atol=2e-4)
    np.testing.assert_allclose(nq.numpy(), np.asarray(jnq), atol=2e-4)
    for f in jpll.PLLState._fields:
        np.testing.assert_allclose(getattr(ns, f).numpy(),
                                   np.asarray(getattr(jns, f)), atol=2e-4,
                                   err_msg=f)


def test_span_streaming_continuity():
    """Two chained blocks equal one block of twice the length, bit for
    bit, through the targets, the span scan and the expansion."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_tones(rng, 2, 2 * N))
    st = pll.PLLState(**{k: torch.from_numpy(v)
                         for k, v in _state(rng, (2, 2)).items()})
    i_long, q_long, s_long = pll.pll(x, st, impl="plain", span=SPAN, **LANES)
    i1, q1, s1 = pll.pll(x[..., :N], st, impl="plain", span=SPAN, **LANES)
    i2, q2, s2 = pll.pll(x[..., N:], s1, impl="plain", span=SPAN, **LANES)
    assert torch.equal(torch.cat([i1, i2], -1), i_long)
    assert torch.equal(torch.cat([q1, q2], -1), q_long)
    for a, b in zip(s2, s_long):
        assert torch.equal(a, b)


def test_span_locks_pilot():
    """test_pll_span.py's lock test on the port: a 19 kHz pilot with a
    phase offset, the NCO at 38 kHz."""
    fs = 240e3
    n = 16384
    t = np.arange(n) / fs
    rng = np.random.default_rng(11)
    x = (np.cos(2 * np.pi * 19e3 * t + 1.1)
         + 0.05 * rng.normal(size=n)).astype(np.float32)
    nco, _, _ = pll.pll(torch.from_numpy(x), pll.init_state(device="cpu"),
                        freq=19e3, fs=fs, nco_scale=2.0, span=SPAN)
    want = np.cos(2 * np.pi * 38e3 * t + 2.2)[-4096:]
    assert np.mean(np.abs(nco.numpy()[-4096:] - want)) < 0.08


def test_span_invalid_length_and_cpu_dispatch():
    """A block that does not divide into spans raises; on the CPU the
    span scan takes B9's plain version and counts no launch; the kernel
    is refused for a CPU tensor."""
    st = pll.init_state(device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        pll.pll(torch.zeros(100), st, freq=19e3, fs=240e3, span=SPAN)
    with pytest.raises(ValueError, match="span must be"):
        pll.pll(torch.zeros(96), st, freq=19e3, fs=240e3, span=0)
    before = pll_cuda.phase_scan_target.launches
    x = torch.from_numpy(_tones(np.random.default_rng(2), 2, 512))
    a = pll.pll(x, pll.init_state((2, 2), device="cpu"), span=SPAN, **LANES)
    p = pll.pll(x, pll.init_state((2, 2), device="cpu"), span=SPAN,
                impl="plain", **LANES)
    assert torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])
    assert pll_cuda.phase_scan_target.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        pll.pll(x, pll.init_state((2, 2), device="cpu"), span=SPAN,
                impl="kernel", **LANES)


@pytest.fixture(scope="module")
def span_runs():
    """Two blocks of the noisy broadcast (C=2, channel 1 I/Q-swapped)
    through both receivers with the span PLL at 8."""
    c, n = 2, 2
    n_audio = n * cfg.audio_per_block
    bits = coding.make_ps_bitstream(0x54A7, 10, "DY4TPU  ", repeats=4)
    iq = jfm.synthesize(cfg, n,
                        left=jfm.tone(800.0, cfg.audio_fs, n_audio, amp=0.7),
                        right=jfm.tone(2400.0, cfg.audio_fs, n_audio,
                                       amp=0.7),
                        rds_bits=bits, noise=0.02, seed=5).reshape(
                            n, 1, cfg.block_size)
    swapped = iq.reshape(n, 1, -1, 2)[..., ::-1].reshape(iq.shape)
    iq = np.concatenate([iq, swapped], axis=1)
    jp = jrx.make_params(cfg)
    tp = convert.params_from_numpy(jp, device=DEV)
    js = jrx.init_state(cfg, batch=(c,))
    ts = rx.init_state(cfg, (c,), device=DEV)
    mp = pytest.MonkeyPatch()
    mp.setenv("DY4TPU_PLL_SPAN", str(SPAN))
    out = []
    try:
        for b in range(n):
            js, jo = jrx.receiver_step(jp, js, jnp.asarray(iq[b]), cfg)
            ts, to = rx.receiver_step(tp, ts, torch.from_numpy(iq[b]), cfg,
                                      pll_span=SPAN)
            out.append((js, jo, ts, to))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("field", rx.StepOutputs._fields)
def test_span_receiver_step_matches_dy4tpu(span_runs, field):
    atol = 1e-3 if field == "pilot_snr_db" else 1e-4
    for b, (_, jo, _, to) in enumerate(span_runs):
        ours, ref = getattr(to, field).numpy(), np.asarray(getattr(jo, field))
        assert ours.dtype == ref.dtype, field
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(ours, ref, atol=atol,
                                       err_msg=f"{field}[{b}]")
        else:
            np.testing.assert_array_equal(ours, ref, err_msg=f"{field}[{b}]")


def test_span_receiver_state_matches_dy4tpu(span_runs):
    for b, (js, _, ts, _) in enumerate(span_runs):
        ours = convert.state_to_numpy(ts)
        ref = convert.leaves_by_path(js)
        assert ours.keys() == ref.keys()
        for k, r in ref.items():
            if r.dtype.kind == "f":
                np.testing.assert_allclose(ours[k], r, atol=1e-4,
                                           err_msg=f"{k}[{b}]")
            else:
                np.testing.assert_array_equal(ours[k], r, err_msg=k)

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

B9-expand (``span_emit="kernel"``, dy4tpu's ``DY4TPU_SPAN_EMIT=kernel``):
its plain version equals the default expansion bit for bit, and the
expansion equals dy4tpu's ``_span_expand`` bit for bit on the same scan
output; against dy4tpu's Pallas kernel with ``expand`` (interpret) the
phases are held within a few float32 ulps (the scans differ by XLA's
contractions, ``test_span_expand_plain_matches_pallas``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import pll as jpll  # noqa: E402
from dy4tpu.ops import pll_pallas  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.rds import coding  # noqa: E402
from dy4tpu.tx import fm as jfm  # noqa: E402
from dy4tpu_torch import app  # noqa: E402
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


def _span_case(kw, seed):
    """Noisy tones (a dead span and a zero sample included), a random
    carry, and both packages' constants for ``kw``."""
    rng = np.random.default_rng(seed)
    x = _tones(rng, 3, N)
    if kw is PILOT:
        x = x[:, 0]
    st = _state(rng, x.shape[:-1])
    return x, st


@pytest.mark.parametrize("kw", [LANES, PILOT], ids=["lanes", "pilot"])
def test_span_expand_plain_matches_pallas(kw):
    """B9-expand's plain version (``phase_scan_target_plain(expand=...)``)
    against dy4tpu's ``pll_pallas.phase_scan(mode="target", expand=8)``
    in interpret mode, on dy4tpu's span targets of the same input.

    The expansion itself is dy4tpu's op for op: on dy4tpu's own scan
    output (phi0, i0) the port's ``_span_expand`` equals dy4tpu's bit for
    bit.  The two scans differ by float32 ulps (XLA may contract the
    step's multiply-adds, as test_torch_pll.py says of the exact loop),
    and dy4tpu's kernel-emitted phases differ from its own expansion by
    an ulp (test_pll_span.py); so the phases, up to about 40 rad, are held
    within 2e-5 (5 ulps there; measured 7.6e-6) and the carries within
    1e-6 (measured 4.8e-7)."""
    x, st = _span_case(kw, 21)
    dt = np.dtype(np.float32)
    kp, ki, dth = jpll._loop_consts(kw["freq"], kw["fs"],
                                    kw["norm_bandwidth"], dt)
    targets = jnp.asarray(jpll._span_targets(jnp.asarray(x), dth, SPAN, dt))
    carry = tuple(jnp.asarray(st[k])
                  for k in ("integrator", "phase_est", "angle"))
    mk = lambda a, b, c: jpll._make_span_step(a, b, c, SPAN, dt)  # noqa: E731
    ref_phis, ref_carry = pll_pallas.phase_scan(
        targets, kp, ki, dth, carry, mk, mode="target", expand=SPAN,
        interpret=True)
    phi0, i0, _ = pll_pallas.phase_scan(
        targets, kp, ki, dth, carry, mk, mode="target", emit_integ=True,
        interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    consts = pll._loop_consts(kw["freq"], kw["fs"], kw["norm_bandwidth"])
    np.testing.assert_array_equal(
        pll._span_expand(t(phi0), t(i0), t(targets),
                         *(t(v) for v in consts), SPAN).numpy(),
        np.asarray(jpll._span_expand(phi0, i0, targets, kp, ki, dth, SPAN,
                                     dt)))
    _, *eff = pll._span_consts(*consts, SPAN)
    phis, ours_carry = pll_cuda.phase_scan_target_plain(
        t(targets), *(t(v) for v in eff), tuple(t(a) for a in carry),
        span=SPAN, expand=tuple(t(v) for v in consts))
    assert phis.shape == x.shape
    np.testing.assert_allclose(phis.numpy(), np.asarray(ref_phis), atol=2e-5)
    for a, b in zip(ours_carry, ref_carry):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_span_emit_kernel_matches_dy4tpu(monkeypatch):
    """``pll(span=8, span_emit="kernel")`` against dy4tpu's ``pll(span=8,
    impl="pallas")`` under ``DY4TPU_SPAN_EMIT=kernel`` on
    test_pll_span.py's case (three 19 kHz pilots at 240 kHz): the NCO and
    the carries within 2e-4, ``test_span_pll_matches_dy4tpu``'s bar (the
    two packages' span targets differ by float32 ulps of cos, sin and
    atan2, and their scans by XLA's contractions)."""
    monkeypatch.setenv("DY4TPU_SPAN_EMIT", "kernel")
    fs, n = 240e3, 4096
    t = np.arange(n) / fs
    x = np.stack([np.cos(2 * np.pi * 19e3 * t + p) for p in
                  (0.0, 0.5, 1.0)]).astype(np.float32)
    x += 0.05 * np.random.default_rng(3).normal(size=x.shape).astype(
        np.float32)
    kw = dict(freq=19e3, fs=fs, nco_scale=2.0)
    ji, jq, js = jpll.pll(jnp.asarray(x), jpll.init_state(batch=(3,)),
                          span=SPAN, impl="pallas", **kw)
    ni, nq, ns = pll.pll(torch.from_numpy(x), pll.init_state((3,),
                                                             device="cpu"),
                         span=SPAN, span_emit="kernel", **kw)
    np.testing.assert_allclose(ni.numpy(), np.asarray(ji), atol=2e-4)
    np.testing.assert_allclose(nq.numpy(), np.asarray(jq), atol=2e-4)
    for f in jpll.PLLState._fields:
        np.testing.assert_allclose(getattr(ns, f).numpy(),
                                   np.asarray(getattr(js, f)), atol=2e-4,
                                   err_msg=f)


@pytest.mark.parametrize("kw", [LANES, PILOT], ids=["lanes", "pilot"])
def test_span_emit_kernel_equals_torch_emit(kw):
    """On the CPU ``span_emit="kernel"`` runs B9-expand's plain version,
    bit for bit the default expansion, and counts no launch."""
    x, st = _span_case(kw, 22)
    state = pll.PLLState(**{k: torch.from_numpy(v) for k, v in st.items()})
    before = pll_cuda.phase_scan_target.expand.launches
    a = pll.pll(torch.from_numpy(x), state, span=SPAN, **kw)
    b = pll.pll(torch.from_numpy(x), state, span=SPAN, span_emit="kernel",
                **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for u, v in zip(a[2], b[2]):
        assert torch.equal(u, v)
    assert pll_cuda.phase_scan_target.expand.launches == before


def test_span_emit_refusals_and_cli(monkeypatch):
    """An unknown ``span_emit`` raises; ``span_emit="kernel"`` with
    ``impl="kernel"`` refuses a CPU tensor; the CLI resolves
    ``DY4TPU_SPAN_EMIT`` (dy4tpu's "xla" is the default, "torch")."""
    x = torch.zeros(2, 96)
    st = pll.init_state((2,), device="cpu")
    with pytest.raises(ValueError, match="span_emit"):
        pll.pll(x, st, freq=19e3, fs=240e3, span=SPAN, span_emit="xla")
    with pytest.raises(ValueError, match="CUDA"):
        pll.pll(x, st, freq=19e3, fs=240e3, span=SPAN, span_emit="kernel",
                impl="kernel")
    monkeypatch.setenv("DY4TPU_PLL_SPAN", "8")
    for raw, want in (("kernel", "kernel"), ("xla", "torch"),
                      ("torch", "torch")):
        monkeypatch.setenv("DY4TPU_SPAN_EMIT", raw)
        assert app._env_settings(None) == (8, want, "peak")
    monkeypatch.setenv("DY4TPU_SPAN_EMIT", "bogus")
    with pytest.raises(SystemExit, match="DY4TPU_SPAN_EMIT"):
        app._env_settings(None)


def test_span_emit_kernel_receiver_equals_torch_emit():
    """``receiver_step(pll_span=8, pll_span_emit="kernel")`` on the CPU
    equals the default expansion bit for bit (both PLL calls, with and
    without RDS)."""
    iq = torch.from_numpy(jfm.synthesize(
        cfg, 1, left=jfm.tone(800.0, cfg.audio_fs, cfg.audio_per_block),
        right=jfm.tone(2400.0, cfg.audio_fs, cfg.audio_per_block),
        noise=0.02, seed=8).reshape(1, cfg.block_size))
    for with_rds in (True, False):
        params = rx.make_params(cfg, with_rds=with_rds, device=DEV)
        runs = [rx.receiver_step(params, rx.init_state(
                    cfg, (1,), with_rds=with_rds, device=DEV), iq, cfg,
                    with_rds=with_rds, pll_span=SPAN, pll_span_emit=emit)
                for emit in ("torch", "kernel")]
        (st_a, out_a), (st_b, out_b) = runs
        for a, b in zip(convert.leaves_by_path(st_a).values(),
                        convert.leaves_by_path(st_b).values()):
            np.testing.assert_array_equal(a, b)
        for f in rx.StepOutputs._fields:
            a, b = getattr(out_a, f), getattr(out_b, f)
            assert (a is None and b is None) or torch.equal(a, b), f

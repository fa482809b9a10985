"""The port's wideband path (dy4tpu_torch.pipeline.wideband, ops/afc.py,
the wideband half of ops/iqcorr.py, tx/fm.py's wideband synthesiser and
tools/wideband.py) against dy4tpu's on the same inputs, on CPU.

``wideband_step`` is held to dy4tpu's un-jitted ``wideband_step`` at mode
0 with RDS: C=4 channels x 2 bands x 3 steps, AFC and the wideband IQ
tracker each on and off.  Every channel carries an on-grid station (an
FM demod of an empty channel is static, and so is the RDS PLL on it);
band 1 is band 0's capture 37 complex samples later through a tuner
fault (gain 1.2, 8 degrees, DC 0.03/-0.02), so the tracker's correction
is far from the identity.  Bars, as in tests/test_torch_modes.py: every
float output and state leaf to atol 1e-4 (measured about 1e-6), the pilot
SNR and the RSSI to 1e-3 dB, every RDS decision exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import afc as jafc  # noqa: E402
from dy4tpu.ops import iqcorr as jiq  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.pipeline import wideband as jwb  # noqa: E402
from dy4tpu.rds import coding  # noqa: E402
from dy4tpu.tx import fm as jfm  # noqa: E402
from dy4tpu_torch.ops import afc, iqcorr  # noqa: E402
from dy4tpu_torch.pipeline import convert  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.pipeline import wideband as wb  # noqa: E402
from dy4tpu_torch.tools import wideband as tool  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
cfg = get_mode(0)
C, BANDS, STEPS = 4, 2, 3
STEP_U8 = 2 * C * cfg.if_per_block
SHIFT = 74                      # bytes between band 0 and band 1
FAULT = dict(gain=1.2, phase_deg=8.0, dc_i=0.03, dc_q=-0.02)


def _stations(n_steps):
    n_audio = n_steps * cfg.audio_per_block
    tone = lambda f: fm.tone(f, cfg.audio_fs, n_audio, amp=0.7)  # noqa: E731
    bits = coding.make_ps_bitstream(fm.PI_CODE, 10, fm.PS_NAME, repeats=4)
    return {0: dict(left=tone(600.0)),
            1: dict(left=tone(800.0), right=tone(2400.0), rds_bits=bits),
            2: dict(left=tone(1000.0), right=tone(300.0)),
            3: dict(left=tone(1500.0), right=tone(500.0))}


def _impair_u8(u8):
    """The tuner fault on an interleaved u8 capture, re-quantized."""
    x = (u8.astype(np.float64) - 128.0) / 128.0
    i, q = iqcorr.impair(x[0::2], x[1::2], **FAULT)
    out = np.empty_like(x)
    out[0::2], out[1::2] = i, q
    return np.clip(np.round(out * 128.0 + 128.0), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def blocks():
    """[STEPS, BANDS, STEP_U8] u8, every band row different."""
    cap = fm.synthesize_wideband(cfg, C, STEPS + 1, stations=_stations(
        STEPS + 1), noise=0.01, seed=3)
    band1 = _impair_u8(cap)[SHIFT:SHIFT + STEPS * STEP_U8]
    return np.stack([cap[:STEPS * STEP_U8].reshape(STEPS, STEP_U8),
                     band1.reshape(STEPS, STEP_U8)], axis=1)


@pytest.fixture(scope="module")
def runs(blocks):
    """(afc, iqcorr) -> dy4tpu's and the port's per-step states and
    outputs, computed once per module."""
    cache = {}
    jp = jrx.make_params(cfg)
    jc = jwb.make_wideband(cfg, C)
    tp = convert.params_from_numpy(jp)
    tc = convert.chan_params_from_numpy(jc)

    def get(use_afc, use_iq):
        key = (use_afc, use_iq)
        if key not in cache:
            js = jwb.wideband_init(cfg, jc, batch=(BANDS,), afc=use_afc,
                                   iqcorr=use_iq)
            ts = wb.wideband_init(cfg, tc, batch=(BANDS,), afc=use_afc,
                                  iqcorr=use_iq)
            got = dict(j_state=[], j_out=[], t_state=[], t_out=[])
            for s in range(STEPS):
                js, jo = jwb.wideband_step(jp, jc, js, jnp.asarray(blocks[s]),
                                           cfg)
                ts, to = wb.wideband_step(tp, tc, ts,
                                          torch.from_numpy(blocks[s]), cfg)
                for k, v in (("j_state", js), ("j_out", jo),
                             ("t_state", ts), ("t_out", to)):
                    got[k].append(v)
            cache[key] = got
        return cache[key]

    return dict(get=get, jp=jp, jc=jc, tp=tp, tc=tc)


def _assert_leaf(ours, ref, name, atol=1e-4):
    if ref is None:
        assert ours is None, name
        return
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    assert ours.dtype == ref.dtype, (name, ours.dtype, ref.dtype)
    if ref.dtype.kind == "f":
        np.testing.assert_allclose(ours, ref, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(ours, ref, err_msg=name)


def _assert_step(t_out, j_out, t_state, j_state, label):
    for f in rx.StepOutputs._fields:
        _assert_leaf(getattr(t_out.rx, f), getattr(j_out.rx, f),
                     f"{label} {f}", 1e-3 if f == "pilot_snr_db" else 1e-4)
    _assert_leaf(t_out.rssi, j_out.rssi, f"{label} rssi", 1e-3)
    ours = convert.state_to_numpy(t_state)
    ref = convert.leaves_by_path(j_state)
    assert ours.keys() == ref.keys(), set(ours) ^ set(ref)
    for k in ref:
        _assert_leaf(ours[k], ref[k], f"{label} state {k}")
    np.testing.assert_array_equal(ours["chan.tail_i"], ref["chan.tail_i"])


@pytest.mark.parametrize("use_afc,use_iq", [(False, False), (True, False),
                                            (False, True), (True, True)],
                         ids=["plain", "afc", "iqcorr", "afc+iqcorr"])
def test_wideband_step_matches_dy4tpu(runs, use_afc, use_iq):
    got = runs["get"](use_afc, use_iq)
    for s in range(STEPS):
        out = got["t_out"][s]
        assert out.rx.mono.shape == (BANDS, C, cfg.audio_per_block)
        assert out.rssi.shape == (BANDS, C)
        _assert_step(out, got["j_out"][s], got["t_state"][s],
                     got["j_state"][s], f"step {s}")
    st = got["t_state"][-1]
    assert (st.afc is not None) == use_afc
    assert (st.iqcorr is not None) == use_iq
    if use_iq:
        # the fault on band 1 drives its coefficients off the identity
        co = iqcorr.coeffs_gaussian(st.iqcorr)
        assert abs(float(co.s[1]) - 1.0) > 0.05 and float(co.s[0]) == 1.0
    # every live channel stands well above the -120 dB floor
    assert float(got["t_out"][-1].rssi.min()) > -30.0


def test_run_wideband_blocks_equals_the_step_loop(runs, blocks):
    got = runs["get"](True, True)
    state = wb.wideband_init(cfg, runs["tc"], batch=(BANDS,), afc=True,
                             iqcorr=True)
    state, outs = wb.run_wideband_blocks(runs["tp"], runs["tc"], state,
                                         torch.from_numpy(blocks), cfg)
    for f in rx.StepOutputs._fields:
        want = torch.stack([getattr(o.rx, f) for o in got["t_out"]])
        assert torch.equal(getattr(outs.rx, f), want), f
    assert torch.equal(outs.rssi, torch.stack([o.rssi
                                               for o in got["t_out"]]))
    for a, b in zip(convert.state_to_numpy(state).values(),
                    convert.state_to_numpy(
                        got["t_state"][-1]).values()):
        np.testing.assert_array_equal(a, b)


def test_midstream_handoff_from_dy4tpu(runs, blocks):
    """dy4tpu runs steps 0-1 with AFC and the IQ tracker; its whole
    ``WidebandState`` crosses over by field path; the port runs step 2 and
    matches dy4tpu's step 2."""
    got = runs["get"](True, True)
    st = convert.wideband_state_from_numpy(got["j_state"][1])
    assert st.iqcorr.count.dtype == torch.int32
    assert st.rx.rds.cdr.offset.dtype == torch.int32
    st, out = wb.wideband_step(runs["tp"], runs["tc"], st,
                               torch.from_numpy(blocks[2]), cfg)
    _assert_step(out, got["j_out"][2], st, got["j_state"][2], "handoff")


def test_synthesize_wideband_equals_dy4tpu():
    """Byte for byte, with RDS, a station off the grid, a per-station
    amplitude, and noise from a seed."""
    n_steps = 2
    n_audio = n_steps * cfg.audio_per_block
    bits = coding.make_ps_bitstream(0x5401, 3, "WB CH-01", repeats=3)

    def stations(tone):
        return {1: dict(left=tone(500.0, cfg.audio_fs, n_audio, amp=0.8),
                        rds_bits=bits, carrier_offset_hz=7.5e3),
                3: dict(right=tone(900.0, cfg.audio_fs, n_audio),
                        station_amp=0.2)}

    for kw in (dict(), dict(kf=50e3, noise=0.05, seed=9, amp=0.3)):
        ours = fm.synthesize_wideband(cfg, C, n_steps,
                                      stations=stations(fm.tone), **kw)
        ref = jfm.synthesize_wideband(cfg, C, n_steps,
                                      stations=stations(jfm.tone), **kw)
        assert ours.dtype == np.uint8 and len(ours) == n_steps * STEP_U8
        np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError, match="outside"):
        fm.synthesize_wideband(cfg, C, 1, stations={C: {}})


def _afc_state(rng, shape, scale):
    f = (rng.uniform(-scale, scale, shape)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    return (jafc.AFCState(jnp.asarray(f), jnp.asarray(ph)),
            afc.AFCState(torch.from_numpy(f), torch.from_numpy(ph)))


def test_afc_rotate_matches_dy4tpu():
    """Small and large carried frequencies (|freq*k| up to ~10^3 rad,
    where the float32 wrap quantizes theta to ~1e-4 rad in both)."""
    rng = np.random.default_rng(0)
    i = rng.standard_normal((3, 4, 512)).astype(np.float32)
    q = rng.standard_normal((3, 4, 512)).astype(np.float32)
    for scale in (1e-3, 0.5, 2.0):
        js, ts = _afc_state(rng, (3, 4), scale)
        ref = jafc.rotate(jnp.asarray(i), jnp.asarray(q), js)
        ours = afc.rotate(torch.from_numpy(i), torch.from_numpy(q), ts)
        for name, o, r in zip(("y_i", "y_q", "phase_next"), ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-6,
                                       err_msg=f"{name} scale {scale}")
        assert float(ours[2].abs().max()) <= np.pi + 1e-6
    # a zero state is the identity
    z = afc.init_afc_state((3, 4))
    y_i, y_q, ph = afc.rotate(torch.from_numpy(i), torch.from_numpy(q), z)
    assert torch.equal(y_i, torch.from_numpy(i)) and not ph.any()


def test_afc_update_and_freq_hz_match_dy4tpu():
    rng = np.random.default_rng(1)
    js, ts = _afc_state(rng, (2, 4), 0.5)
    dc = rng.uniform(-2.0, 2.0, (2, 4)).astype(np.float32)
    ph = rng.uniform(-3, 3, (2, 4)).astype(np.float32)
    for kw in (dict(), dict(alpha=0.3, max_freq=cfg.if_fs / 4.0,
                            fs=cfg.if_fs)):
        ref = jafc.update(js, jnp.asarray(ph), jnp.asarray(dc), **kw)
        ours = afc.update(ts, torch.from_numpy(ph), torch.from_numpy(dc),
                          **kw)
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        np.testing.assert_allclose(afc.freq_hz(ours, cfg.if_fs).numpy(),
                                   np.asarray(jafc.freq_hz(ref, cfg.if_fs)),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="fs"):
        afc.update(ts, ts.phase, ts.freq, max_freq=1e3)


def test_afc_loop_converges_on_a_complex_exponential():
    """The loop drives its estimate to a pure offset of 0.3 rad/sample
    (as tests/test_afc.py)."""
    n, w = 1024, 0.3
    st = afc.init_afc_state()
    for b in range(12):
        x = np.exp(1j * w * np.arange(b * n, (b + 1) * n))
        y_i, y_q, phase_next = afc.rotate(
            torch.as_tensor(x.real, dtype=torch.float32),
            torch.as_tensor(x.imag, dtype=torch.float32), st)
        y = y_i.double().numpy() + 1j * y_q.double().numpy()
        dc = float(np.mean(np.angle(y[1:] * np.conj(y[:-1]))))
        st = afc.update(st, phase_next, torch.tensor(dc))
    assert abs(float(st.freq) - w) < 1e-3 and abs(dc) < 1e-3


def _moment_inputs(rng):
    i = (rng.standard_normal((3, 2048)) * 0.4 + 0.02).astype(np.float32)
    q = (rng.standard_normal((3, 2048)) * 0.35 - 0.01).astype(np.float32)
    q = q + 0.2 * i
    return i, q


def test_iqcorr_moments_and_fold_match_dy4tpu():
    rng = np.random.default_rng(2)
    i, q = _moment_inputs(rng)
    ref = jiq.moments(jnp.asarray(i), jnp.asarray(q))
    ours = iqcorr.moments(torch.from_numpy(i), torch.from_numpy(q))
    assert ours.shape == (3, 14)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)
    js, ts = jiq.init_iqcorr_state((3,)), iqcorr.init_iqcorr_state((3,))
    for _ in range(3):
        js = jiq.fold(js, ref)
        ts = iqcorr.fold(ts, torch.from_numpy(np.array(ref)))
    np.testing.assert_array_equal(ts.m.numpy(), np.asarray(js.m))
    assert ts.count.dtype == torch.int32 and ts.count.tolist() == [3] * 3


def test_iqcorr_coeffs_gaussian_matches_dy4tpu():
    """Cold start, a faulted stream, a clean one (deadband -> exact
    identity) and a squelched one (under min_power)."""
    rng = np.random.default_rng(3)
    cases = []
    i, q = rng.standard_normal((2, 4, 4096)).astype(np.float32) * 0.3
    fi, fq = iqcorr.impair(i, q, **FAULT)
    cases.append((fi, fq, 1))
    cases.append((i, q, 1))
    cases.append((i * 1e-4, q * 1e-4, 1))
    cases.append((fi, fq, 0))
    for ci, cq, count in cases:
        mom = jiq.moments(jnp.asarray(ci, jnp.float32),
                          jnp.asarray(cq, jnp.float32))
        js = jiq.IQCorrState(m=mom, count=jnp.full((4,), count, jnp.int32))
        ts = iqcorr.IQCorrState(
            m=torch.from_numpy(np.array(mom)),
            count=torch.full((4,), count, dtype=torch.int32))
        ref = jiq.coeffs_gaussian(js)
        ours = iqcorr.coeffs_gaussian(ts)
        for name, o, r in zip(iqcorr.IQCorrCoeffs._fields, ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6,
                                       err_msg=name)
    g, phi = FAULT["gain"], np.deg2rad(FAULT["phase_deg"])
    got = iqcorr.coeffs_gaussian(iqcorr.fold(
        iqcorr.init_iqcorr_state((4,)),
        iqcorr.moments(torch.from_numpy(fi.astype(np.float32)),
                       torch.from_numpy(fq.astype(np.float32)))))
    assert abs(float(got.rho[0]) - g * np.sin(phi)) < 0.03
    assert abs(float(got.s[0]) - 1.0 / (g * np.cos(phi))) < 0.03


def test_iqcorr_apply_channelized_matches_dy4tpu():
    rng = np.random.default_rng(4)
    y_i = rng.standard_normal((2, 8, 64)).astype(np.float32)
    y_q = rng.standard_normal((2, 8, 64)).astype(np.float32)
    g_r = rng.standard_normal(8).astype(np.float32)
    g_i = rng.standard_normal(8).astype(np.float32)
    vals = dict(dc_i=[0.03, -0.01], dc_q=[-0.02, 0.0], rho=[0.15, -0.05],
                s=[0.85, 1.1])
    jco = jiq.IQCorrCoeffs(**{k: jnp.asarray(v, jnp.float32)
                              for k, v in vals.items()})
    tco = iqcorr.IQCorrCoeffs(**{k: torch.tensor(v) for k, v in vals.items()})
    for o, r in zip(iqcorr.channel_affine(tco), jiq.channel_affine(jco)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-7)
    ref = jiq.apply_channelized(jnp.asarray(y_i), jnp.asarray(y_q), jco,
                                jnp.asarray(g_r), jnp.asarray(g_i))
    ours = iqcorr.apply_channelized(torch.from_numpy(y_i),
                                    torch.from_numpy(y_q), tco,
                                    torch.from_numpy(g_r),
                                    torch.from_numpy(g_i))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def test_iqcorr_wideband_moments_and_helpers_match_dy4tpu(blocks):
    ref = jiq.wideband_moments(jnp.asarray(blocks[0]))
    ours = iqcorr.wideband_moments(torch.from_numpy(blocks[0]))
    assert ours.shape == (BANDS, 14)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)
    assert iqcorr.image_rejection_db(1.2, 8.0) == jiq.image_rejection_db(
        1.2, 8.0)
    x = np.linspace(-1, 1, 50)
    for o, r in zip(iqcorr.impair(x, x[::-1], **FAULT),
                    jiq.impair(x, x[::-1], **FAULT)):
        np.testing.assert_array_equal(o, r)


def _tone_power(x, freq, fs):
    t = np.arange(len(x)) / fs
    return 2 * np.abs(x @ np.exp(-2j * np.pi * freq * t)) ** 2 / len(x) ** 2


def test_wideband_two_stations_e2e():
    """Two FM stations on one 4-channel capture, without RDS (the case of
    tests/test_channelizer.py): the live channels stand over 15 dB above
    the empty ones, and each station's tone dominates its own channel."""
    n_steps = 6
    n_audio = n_steps * cfg.audio_per_block
    f1, f2 = 800.0, 1500.0
    t1 = fm.tone(f1, cfg.audio_fs, n_audio, amp=0.9)
    t2 = fm.tone(f2, cfg.audio_fs, n_audio, amp=0.9)
    cap = fm.synthesize_wideband(
        cfg, C, n_steps, stations={1: dict(left=t1, right=t1),
                                   3: dict(left=t2, right=t2)}, kf=50e3)
    params = rx.make_params(cfg)
    chan = wb.make_wideband(cfg, C)
    state = wb.wideband_init(cfg, chan, with_rds=False)
    _, outs = wb.run_wideband_blocks(
        params, chan, state,
        torch.from_numpy(cap.reshape(n_steps, STEP_U8)), cfg,
        with_rds=False)
    assert outs.rx.rds_symbols is None
    rssi = outs.rssi.numpy()[1:].mean(0)
    assert rssi[[1, 3]].min() > rssi[[0, 2]].max() + 15.0, rssi
    mono = outs.rx.mono.numpy()[2:].transpose(1, 0, 2).reshape(C, -1)
    p1 = _tone_power(mono[1], f1, cfg.audio_fs)
    p2 = _tone_power(mono[3], f2, cfg.audio_fs)
    assert p1 > 1e-4 and p2 > 1e-4, (p1, p2)
    assert p1 > 30 * _tone_power(mono[1], f2, cfg.audio_fs)
    assert p2 > 30 * _tone_power(mono[3], f1, cfg.audio_fs)
    for ch in (0, 2):
        assert _tone_power(mono[ch], f1, cfg.audio_fs) < 0.3 * p1
        assert _tone_power(mono[ch], f2, cfg.audio_fs) < 0.3 * p2


def _run_tool(args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "dy4tpu_torch.tools.wideband", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_wideband_tool_scans_and_decodes(tmp_path, capsys):
    """``python -m dy4tpu_torch.tools.wideband --device cpu`` on a
    4-channel capture with stations on channels 1 and 3 as
    ``dy4tpu.tools.synth --wideband 4 --stations 1,3`` makes them (tones
    500+100c / 2000+100c Hz, PI 0x5400+c, PS 'WB CH-xx'): the scan marks
    channels 1 and 3, and the decode writes their WAVs and prints their
    PI and PS."""
    n_steps = 20
    n_audio = n_steps * cfg.audio_per_block
    repeats = max(8, int(n_audio / cfg.audio_fs * 1187.5 / 104) + 8)
    stations = {ch: dict(
        left=fm.tone(500.0 + 100.0 * ch, cfg.audio_fs, n_audio, amp=0.8),
        right=fm.tone(2000.0 + 100.0 * ch, cfg.audio_fs, n_audio, amp=0.8),
        rds_bits=coding.make_ps_bitstream(0x5400 + ch, 0, f"WB CH-{ch:02d}",
                                          repeats=repeats))
        for ch in (1, 3)}
    cap = str(tmp_path / "band.raw")
    fm.synthesize_wideband(cfg, C, n_steps, stations=stations).tofile(cap)

    # the scan in this process (its first steps suffice), the decode as
    # the command a user types
    assert tool.main([cap, "--mode", "0", "--channels", "4", "--scan",
                      "--no-rds", "--max-steps", "3", "--device",
                      "cpu"]) == 0
    scan = capsys.readouterr().err
    for ch, live in enumerate([False, True, False, True]):
        line = next(ln for ln in scan.splitlines()
                    if ln.startswith(f"ch   {ch}"))
        assert line.rstrip().endswith("*") == live, scan

    out = tmp_path / "decoded"
    p = _run_tool([cap, "--mode", "0", "--channels", "4", "--out-dir",
                   str(out), "--device", "cpu"])
    assert p.returncode == 0, p.stderr
    assert "PI=5401 PS='WB CH-01'" in p.stderr, p.stderr
    assert "PI=5403 PS='WB CH-03'" in p.stderr, p.stderr
    assert (out / "station001.wav").exists()
    assert (out / "station003.wav").exists()
    assert not (out / "station000.wav").exists()    # squelched
    assert "on cpu" in p.stderr


def test_wideband_tool_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cap = tmp_path / "band.raw"
    np.zeros(STEP_U8, np.uint8).tofile(cap)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([str(cap), "--channels", "4", "--scan"])

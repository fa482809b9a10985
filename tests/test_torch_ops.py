"""The port's plain ops (dy4tpu_torch.ops: firdes, fir, demod, mix, trig)
against dy4tpu's, on the same numpy inputs.

Bars: filter designs equal element for element; FIRs to atol 1e-5 at
mode 0's geometries (float32 sums in another order) with tails exact;
demod to float32 tolerance with the zero-power guard exact; quantize
equal; NCO trig within 2 ulp.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import demod as jdemod  # noqa: E402
from dy4tpu.ops import fir as jfir  # noqa: E402
from dy4tpu.ops import firdes as jfirdes  # noqa: E402
from dy4tpu.ops import mix as jmix  # noqa: E402
from dy4tpu.ops import trig as jtrig  # noqa: E402
from dy4tpu_torch.ops import demod, fir, firdes, mix, trig  # noqa: E402

cfg = get_mode(0)
HI = lax.Precision.HIGHEST


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("design", [
    ("lpf", (2.4e6, 100e3, 101)),
    ("lpf", (240e3 * 19, 3e3, 1919, 19)),
    ("lpf", (240e3 * 147, 16e3, 101 * 147, 147)),
    ("lpf_kaiser", (240e3, 16e3, 101)),
    ("bpf", (240e3, 18.5e3, 19.5e3, 101)),
    ("bpf", (240e3, 113.5e3, 114.5e3, 101)),
    ("rrc", (38e3, 101)),
    ("rrc", (64125.0, 101)),
    ("firwin_lpf", (101, 0.2)),
    ("firwin_bpf", (101, 0.1, 0.3)),
])
def test_firdes_equal(design):
    name, args = design
    ours = getattr(firdes, name)(*args)
    ref = getattr(jfirdes, name)(*args)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def _fir_case(rng, k, up, down, n, batch=(3, 2)):
    h = (firdes.lpf(cfg.if_fs * up, 3e3, k, up_factor=up) if up > 1
         else _f32(rng, k, scale=0.05))
    x = _f32(rng, *batch, n)
    st = _f32(rng, *batch, fir.state_len(k, up))
    return h, x, st


@pytest.mark.parametrize("k,up,down,n", [
    (101, 1, 10, 1280),      # RF LPF, decimate by 10
    (101, 1, 5, 7680),       # audio LPF, 1/5
    (101, 1, 1, 7680),       # RRC / carrier BPF, same rate
    (1919, 19, 120, 7680),   # RDS resampler 19/120
])
def test_block_fir_resample_matches_jax(k, up, down, n):
    rng = np.random.default_rng(k + down)
    h, x, st = _fir_case(rng, k, up, down, n)
    y, ns = fir.block_fir_resample(_t(x), _t(h), _t(st), up=up, down=down)
    jy, jns = jfir.block_fir_resample(jnp.asarray(x), jnp.asarray(h),
                                      jnp.asarray(st), up=up, down=down,
                                      precision=HI)
    assert y.shape == jy.shape == (3, 2, n * up // down)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))


def test_block_fir_decim_and_block_fir_are_resample_cases():
    rng = np.random.default_rng(1)
    h, x, st = _fir_case(rng, 101, 1, 10, 1280)
    y, ns = fir.block_fir_decim(_t(x), _t(h), _t(st), 10)
    jy, jns = jfir.block_fir_decim(jnp.asarray(x), jnp.asarray(h),
                                   jnp.asarray(st), 10, precision=HI)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))
    y, ns = fir.block_fir(_t(x), _t(h), _t(st))
    jy, jns = jfir.block_fir(jnp.asarray(x), jnp.asarray(h),
                             jnp.asarray(st), precision=HI)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))


@pytest.mark.parametrize("shared", [True, False])
def test_block_fir_bank_matches_jax(shared):
    rng = np.random.default_rng(7)
    hs = np.stack([firdes.bpf(cfg.if_fs, 18.5e3, 19.5e3, 101),
                   firdes.bpf(cfg.if_fs, 22e3, 54e3, 101),
                   firdes.bpf(cfg.if_fs, 54e3, 60e3, 101)])
    x = _f32(rng, 3, 7680)
    st = _f32(rng, 3, 100) if shared else _f32(rng, 3, 3, 100)
    y, ns = fir.block_fir_bank(_t(x), _t(hs), _t(st))
    jy, jns = jfir.block_fir_bank(jnp.asarray(x), jnp.asarray(hs),
                                  jnp.asarray(st), precision=HI)
    assert y.shape == (3, 3, 7680)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))


def test_block_fir_rejects_bad_state():
    with pytest.raises(ValueError):
        fir.block_fir_resample(torch.zeros(2, 240), torch.zeros(101),
                               torch.zeros(2, 99), down=10)


def test_fm_demod_diff_matches_jax_with_zero_power_guard():
    rng = np.random.default_rng(3)
    i, q = _f32(rng, 3, 512), _f32(rng, 3, 512)
    i[:, 10:20] = 0.0          # zero power: 0/0 -> 0
    q[:, 10:20] = 0.0
    pi, pq = _f32(rng, 3), _f32(rng, 3)
    pi[1] = pq[1] = 0.0
    i[1, 0] = q[1, 0] = 0.0    # first sample against a zero prev
    fm, ni, nq = demod.fm_demod_diff(_t(i), _t(q), _t(pi), _t(pq))
    jfm, jni, jnq = jdemod.fm_demod_diff(*(jnp.asarray(a)
                                           for a in (i, q, pi, pq)))
    np.testing.assert_allclose(fm.numpy(), np.asarray(jfm), rtol=1e-6,
                               atol=1e-6)
    assert np.all(fm.numpy()[:, 11:20] == 0.0)
    assert fm.numpy()[1, 0] == 0.0
    np.testing.assert_array_equal(ni.numpy(), np.asarray(jni))
    np.testing.assert_array_equal(nq.numpy(), np.asarray(jnq))


def test_quantize_s16_equal_including_saturation_and_nan():
    x = np.array([1.5, -1.5, 2.5, -2.5, 3.0, -3.0, 1e10, -1e10, np.nan,
                  0.25, -0.999], np.float32)
    ours = mix.quantize_s16(_t(x)).numpy()
    ref = np.asarray(jmix.quantize_s16(jnp.asarray(x)))
    assert ours.dtype == np.int16
    np.testing.assert_array_equal(ours, ref)


def test_mix_ops_equal():
    rng = np.random.default_rng(5)
    a, b = _f32(rng, 2, 64), _f32(rng, 2, 64)
    st = _f32(rng, 2, 5)
    for ours, ref in [
            (mix.delay_block(_t(a), _t(st)),
             jmix.delay_block(jnp.asarray(a), jnp.asarray(st))),
            (mix.stereo_matrix(_t(a), _t(b)),
             jmix.stereo_matrix(jnp.asarray(a), jnp.asarray(b))),
            ((mix.mix(_t(a), _t(b)), mix.interleave(_t(a), _t(b)),
              mix.squaring_nonlinearity(_t(a))),
             (jmix.mix(jnp.asarray(a), jnp.asarray(b)),
              jmix.interleave(jnp.asarray(a), jnp.asarray(b)),
              jmix.squaring_nonlinearity(jnp.asarray(a))))]:
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def _ulps(a, b):
    """Distance in float32 ulps (monotone integer view)."""
    def key(v):
        i = v.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def test_sincos_within_2_ulp_of_dy4tpu():
    rng = np.random.default_rng(11)
    x = np.concatenate([
        np.linspace(-64, 64, 200001, dtype=np.float32),
        (rng.uniform(-64, 64, 50000)).astype(np.float32),
        np.float32(np.pi / 4) * np.arange(-81, 82, dtype=np.float32)])
    s, c = trig.sincos(_t(x))
    js, jc = jtrig.sincos(jnp.asarray(x))
    assert _ulps(s.numpy(), np.asarray(js)).max() <= 2
    assert _ulps(c.numpy(), np.asarray(jc)).max() <= 2
    ns, nc = trig.nco_sincos(_t(x))
    assert torch.equal(ns, s) and torch.equal(nc, c)

"""The port's audio post-processing (dy4tpu_torch.ops.deemph and
``mix.stereo_blend``) against dy4tpu's, and de-emphasis against a
sequential float64 recurrence.

Bars: de-emphasis within 1e-5 of dy4tpu (both reassociate the recurrence,
the port as a doubling scan, dy4tpu as ``lax.associative_scan``, in
float32; measured about 2e-7) and of the float64 recurrence; block
continuity within 1e-5 (the split changes the association); the blend
within 1e-6 (the same four float32 operations).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.ops import deemph as jde  # noqa: E402
from dy4tpu.ops import mix as jmix  # noqa: E402
from dy4tpu_torch.ops import deemph, mix  # noqa: E402


def _recurrence(x, a, y0):
    """y[n] = a*y[n-1] + (1-a)*x[n], sequential float64, per row."""
    y = np.empty_like(x, dtype=np.float64)
    prev = np.asarray(y0, np.float64)
    for n in range(x.shape[-1]):
        prev = a * prev + (1.0 - a) * x[..., n]
        y[..., n] = prev
    return y


@pytest.mark.parametrize("tau,fs,n", [(deemph.TAU_US_75, 48e3, 1536),
                                      (deemph.TAU_EU_50, 44.1e3, 1000),
                                      (deemph.TAU_US_75, 48e3, 1)])
def test_deemphasis_matches_dy4tpu_and_the_recurrence(tau, fs, n):
    a = deemph.deemph_coeff(fs, tau)
    assert a == jde.deemph_coeff(fs, tau)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, n)).astype(np.float32)
    y0 = rng.standard_normal(3).astype(np.float32)
    y, last = deemph.deemphasis_block(torch.from_numpy(x),
                                      torch.from_numpy(y0), a)
    jy, jlast = jde.deemphasis_block(jnp.asarray(x), jnp.asarray(y0), a)
    assert y.dtype == torch.float32 and y.shape == (3, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(y.numpy(), _recurrence(x, a, y0), atol=1e-5)
    assert torch.equal(last, y[:, -1])
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-5)


def test_deemphasis_block_continuity():
    """One 2N block equals two N blocks with the carried state, and a
    long block does not underflow into NaN (a^n reaches 0)."""
    a = deemph.deemph_coeff(48e3)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 2048)).astype(np.float32))
    zero = torch.zeros(3)
    y_full, _ = deemph.deemphasis_block(x, zero, a)
    y1, st = deemph.deemphasis_block(x[:, :1024], zero, a)
    y2, _ = deemph.deemphasis_block(x[:, 1024:], st, a)
    np.testing.assert_allclose(y_full.numpy(),
                               torch.cat([y1, y2], -1).numpy(), atol=1e-5)
    long, _ = deemph.deemphasis_block(torch.ones(1, 1 << 16), torch.zeros(1),
                                      a)
    assert bool(torch.isfinite(long).all())
    np.testing.assert_allclose(long[0, -1].item(), 1.0, atol=1e-5)


def test_init_deemph_state():
    st = deemph.init_deemph_state((2,), stereo=True, device="cpu")
    assert len(st) == 2 and all(s.shape == (2,) for s in st)
    assert len(deemph.init_deemph_state((1,), stereo=False, device="cpu")) == 1


def test_stereo_blend_matches_dy4tpu():
    """Full stereo at and above 14 dB, mono at and below 4 dB, linear in
    dB between, on a batch of blocks spanning the range."""
    rng = np.random.default_rng(2)
    left = rng.standard_normal((6, 512)).astype(np.float32)
    right = rng.standard_normal((6, 512)).astype(np.float32)
    snr = np.array([-5.0, 4.0, 6.5, 9.0, 14.0, 30.0], np.float32)
    l, r = mix.stereo_blend(torch.from_numpy(left), torch.from_numpy(right),
                            torch.from_numpy(snr))
    jl, jr = jmix.stereo_blend(jnp.asarray(left), jnp.asarray(right),
                               jnp.asarray(snr))
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-6)
    mono = 0.5 * (left + right)
    np.testing.assert_allclose(l.numpy()[:2], mono[:2], atol=1e-6)
    np.testing.assert_allclose(l.numpy()[4:], left[4:], atol=1e-6)
    np.testing.assert_allclose(r.numpy()[4:], right[4:], atol=1e-6)

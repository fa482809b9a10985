"""B14, the port's decimating block FIR (``fir.block_fir_decim(impl=...)``
and ``fir_cuda.block_fir_decim``, whose CPU route is the plain conv1d),
against dy4tpu's ``block_fir_decim_pallas`` in interpret mode at the
geometries of tests/test_fir_pallas.py, plus streaming continuity and the
dispatch rules.

Bars, as tests/test_fir_pallas.py's: y within 2e-4 x max(1, max|y|) (the
two sum the taps in other orders; the taps and inputs are unit normals, so
|y| reaches about 30), the new state exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.ops import fir_pallas  # noqa: E402
from dy4tpu_torch.ops import fir, fir_cuda  # noqa: E402

CASES = [
    ((2, 2), 76800, 101, 10),   # RF front end geometry (I/Q pairs batched)
    ((3,), 640, 101, 5),        # mode-0 audio decimation geometry
    ((), 1280, 7, 2),           # short filter, no batch dims
    ((5,), 256, 33, 4),         # tile-boundary output count (64 < 128)
]


def _inputs(seed, bshape, n, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*bshape, n)).astype(np.float32)
    h = rng.standard_normal(k).astype(np.float32)
    st = rng.standard_normal((*bshape, k - 1)).astype(np.float32)
    return x, h, st


@pytest.mark.parametrize("bshape,n,k,d", CASES)
def test_plain_matches_pallas(bshape, n, k, d):
    x, h, st = _inputs(5 + n + k, bshape, n, k)
    ref_y, ref_s = fir_pallas.block_fir_decim_pallas(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(st), d, interpret=True)
    ref_y, ref_s = np.asarray(ref_y), np.asarray(ref_s)
    scale = max(1.0, float(np.abs(ref_y).max()))
    args = (torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(st), d)
    for y, s in (fir.block_fir_decim(*args, impl="plain"),
                 fir.block_fir_decim(*args),
                 fir_cuda.block_fir_decim(*args)):
        assert y.shape == ref_y.shape and s.shape == ref_s.shape
        np.testing.assert_allclose(y.numpy(), ref_y, atol=2e-4 * scale)
        np.testing.assert_array_equal(s.numpy(), ref_s)


def test_streaming_continuity():
    """Two chained blocks equal one block of twice the length (the plain
    version and dy4tpu's kernel, each chained on its own state)."""
    n, k, d = 2560, 101, 10
    x, h, _ = _inputs(6, (), 2 * n, k)
    st0 = np.zeros(k - 1, np.float32)
    t = torch.from_numpy
    y_all, _ = fir_cuda.block_fir_decim(t(x), t(h), t(st0), d)
    y1, s = fir_cuda.block_fir_decim(t(x[:n]), t(h), t(st0), d)
    y2, _ = fir_cuda.block_fir_decim(t(x[n:]), t(h), s, d)
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(), y_all.numpy(),
                               atol=1e-5)
    j1, js = fir_pallas.block_fir_decim_pallas(
        jnp.asarray(x[:n]), jnp.asarray(h), jnp.asarray(st0), d,
        interpret=True)
    j2, _ = fir_pallas.block_fir_decim_pallas(
        jnp.asarray(x[n:]), jnp.asarray(h), js, d, interpret=True)
    np.testing.assert_allclose(np.concatenate([j1, j2]), y_all.numpy(),
                               atol=2e-4 * max(1.0, float(y_all.abs().max())))


def test_dispatch_rules():
    """``impl="kernel"`` refuses a CPU tensor (as ``pll(impl="kernel")``
    does) and counts no launch; an unknown impl raises; the wrapper runs
    the plain version on a CPU tensor without a launch; a meta tensor
    reaches the kernel route and is refused there."""
    x, h, st = (torch.from_numpy(a) for a in _inputs(7, (3,), 640, 101))
    before = fir_cuda.block_fir_decim.launches
    with pytest.raises(ValueError, match="CUDA"):
        fir.block_fir_decim(x, h, st, 5, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        fir.block_fir_decim(x, h, st, 5, impl="pallas")
    y, s = fir_cuda.block_fir_decim(x, h, st, 5)
    p_y, p_s = fir_cuda.block_fir_decim_plain(x, h, st, 5)
    assert torch.equal(y, p_y) and torch.equal(s, p_s)
    m = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        fir_cuda.block_fir_decim(m(3, 640), m(101), m(3, 100), 5)
    assert fir_cuda.block_fir_decim.launches == before

"""The port's wideband channelizer (dy4tpu_torch.ops.channelizer, and the
plain version of kernel B7 in ops/channelizer_cuda.py) against dy4tpu's
channelizer on the same inputs, on CPU.

Geometries (C, T): the five of tests/test_channelizer.py's Pallas test
plus C=128 (a 30.72 MS/s band), on 3 band rows of 64 output steps,
mid-stream (random tails, every row different).  Bars: outputs to atol
5e-6 (float32 sums in another order: the DFT matmul, and the folded IQ
correction against the post-bank one), carried tails bitwise.  dy4tpu's
Pallas kernel runs in interpret mode, as its own tests run it; its gate
refuses C=128 (2C must divide 128), where the stock route is the
reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import channelizer as jchz  # noqa: E402
from dy4tpu.ops import iqcorr as jiq  # noqa: E402
from dy4tpu_torch.ops import channelizer as chz  # noqa: E402
from dy4tpu_torch.ops import channelizer_cuda as chc  # noqa: E402
from dy4tpu_torch.ops import iqcorr  # noqa: E402

cfg = get_mode(0)
GEOMS = [(16, 12), (8, 12), (32, 12), (4, 16), (64, 12), (128, 12)]
IDS = [f"C{c}T{t}" for c, t in GEOMS]
BANDS, M = 3, 64
ATOL = 5e-6


def _setup(c, t, seed=None):
    """Both packages' params, a mid-stream state and a u8 block."""
    jp = jchz.make_channelizer(c, cfg.if_fs, taps_per_branch=t)
    tp = chz.make_channelizer(c, cfg.if_fs, taps_per_branch=t, device="cpu")
    k = c * t
    rng = np.random.default_rng(c + t if seed is None else seed)
    x_u8 = rng.integers(0, 256, (BANDS, 2 * c * M)).astype(np.uint8)
    ti = rng.normal(size=(BANDS, k - 1)).astype(np.float32)
    tq = rng.normal(size=(BANDS, k - 1)).astype(np.float32)
    js = jchz.ChannelizerState(jnp.asarray(ti), jnp.asarray(tq))
    ts = chz.ChannelizerState(torch.from_numpy(ti), torch.from_numpy(tq))
    return jp, tp, js, ts, x_u8, rng


def _close(ours, ref, label, atol=ATOL):
    for o, r, part in zip(ours, ref, ("i", "q")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=atol,
                                   err_msg=f"{label} y_{part}")


def _tails_equal(ours, ref, label):
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r),
                                      err_msg=f"{label} tail")


def _coeffs(n):
    """Per-band IQ correction coefficients, band 1 the identity."""
    vals = dict(dc_i=[0.03, 0.0, -0.01], dc_q=[-0.02, 0.0, 0.015],
                rho=[0.15, 0.0, -0.08], s=[0.85, 1.0, 1.1])
    vals = {k: np.asarray(v[:n], np.float32) for k, v in vals.items()}
    return (jiq.IQCorrCoeffs(**{k: jnp.asarray(v) for k, v in vals.items()}),
            iqcorr.IQCorrCoeffs(**{k: torch.from_numpy(v)
                                   for k, v in vals.items()}))


@pytest.mark.parametrize("c,t", GEOMS, ids=IDS)
def test_make_channelizer_equals_dy4tpu(c, t):
    jp = jchz.make_channelizer(c, cfg.if_fs, taps_per_branch=t)
    tp = chz.make_channelizer(c, cfg.if_fs, taps_per_branch=t, device="cpu")
    assert tp.channels == c and tp.taps_per_branch == t
    for name, a, b in zip(tp._fields, jp, tp):
        assert b.dtype == torch.float32, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    st = chz.init_channelizer_state(tp, batch=(BANDS,))
    assert st.tail_i.shape == (BANDS, c * t - 1) and not st.tail_q.any()


@pytest.mark.parametrize("c,t", GEOMS, ids=IDS)
def test_channelize_block_matches_dy4tpu(c, t):
    """The planar form on float32 I/Q."""
    jp, tp, js, ts, _, rng = _setup(c, t)
    xi = rng.standard_normal((BANDS, c * M)).astype(np.float32)
    xq = rng.standard_normal((BANDS, c * M)).astype(np.float32)
    ref, rs = jchz.channelize_block(jp, js, jnp.asarray(xi), jnp.asarray(xq))
    ours, os_ = chz.channelize_block(tp, ts, torch.from_numpy(xi),
                                     torch.from_numpy(xq))
    assert ours[0].shape == (BANDS, c, M)
    _close(ours, ref, "planar")
    _tails_equal(os_, rs, "planar")


@pytest.mark.parametrize("c,t", GEOMS, ids=IDS)
def test_channelize_block_interleaved_matches_dy4tpu(c, t):
    jp, tp, js, ts, _, rng = _setup(c, t)
    x = rng.standard_normal((BANDS, 2 * c * M)).astype(np.float32)
    ref, rs = jchz.channelize_block_interleaved(jp, js, jnp.asarray(x))
    ours, os_ = chz.channelize_block_interleaved(tp, ts, torch.from_numpy(x))
    _close(ours, ref, "interleaved")
    _tails_equal(os_, rs, "interleaved")


@pytest.mark.parametrize("c,t", GEOMS, ids=IDS)
def test_channelize_block_u8_plain_matches_dy4tpu_stock(c, t):
    jp, tp, js, ts, x_u8, _ = _setup(c, t)
    ref, rs = jchz.channelize_block_u8(jp, js, jnp.asarray(x_u8),
                                       impl="stock")
    ours, os_ = chz.channelize_block_u8(tp, ts, torch.from_numpy(x_u8),
                                        impl="plain")
    _close(ours, ref, "u8 plain vs stock")
    _tails_equal(os_, rs, "u8 plain vs stock")


@pytest.mark.parametrize("c,t", GEOMS, ids=IDS)
def test_kernel_route_matches_dy4tpu_pallas(c, t):
    """The port's kernel route (B7's plain version, then the widened DFT
    matmul) and its plain route against dy4tpu's Pallas kernel in
    interpret mode; where dy4tpu's gate refuses the geometry (C=128),
    against its stock route."""
    jp, tp, js, ts, x_u8, _ = _setup(c, t)
    if jchz.fused_channelizer_ok(c):
        ref, rs = jchz.channelize_block_u8(
            jp, js, jnp.asarray(x_u8), impl="pallas", interpret=True,
            precision=jax.lax.Precision.HIGHEST)
    else:
        with pytest.raises(ValueError, match="2\\*C"):
            jchz.channelize_block_u8(jp, js, jnp.asarray(x_u8),
                                     impl="pallas", interpret=True)
        ref, rs = jchz.channelize_block_u8(jp, js, jnp.asarray(x_u8),
                                           impl="stock")
    x = torch.from_numpy(x_u8)
    for label, (ours, os_) in (
            ("kernel route", chz.channelize_u8_folded(
                tp, ts, x, branches=chc.channelize_branches_plain)),
            ("plain route", chz.channelize_block_u8(tp, ts, x,
                                                    impl="plain"))):
        _close(ours, ref, label)
        _tails_equal(os_, rs, label)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_block_continuity(route):
    """Carried tails: two consecutive blocks equal one block of twice the
    length.  B7's branch outputs and the tails are elementwise and must be
    bit-identical; the channels go through a matmul of another size
    (float32 sums blocked differently), hence 5e-6."""
    c, t = 8, 12
    _, tp, _, _, _, rng = _setup(c, t)
    x = rng.integers(0, 256, (BANDS, 4 * c * M)).astype(np.uint8)
    x = torch.from_numpy(x)
    half = 2 * c * M

    def run(st, blk):
        if route == "plain":
            return chz.channelize_block_u8(tp, st, blk, impl="plain")
        return chz.channelize_u8_folded(
            tp, st, blk, branches=chc.channelize_branches_plain)

    st0 = chz.init_channelizer_state(tp, batch=(BANDS,))
    whole, st_w = run(st0, x)
    (ai, aq), st = run(st0, x[:, :half])
    (bi, bq), st = run(st, x[:, half:])
    np.testing.assert_allclose(torch.cat([ai, bi], -1).numpy(),
                               whole[0].numpy(), atol=ATOL)
    np.testing.assert_allclose(torch.cat([aq, bq], -1).numpy(),
                               whole[1].numpy(), atol=ATOL)
    assert torch.equal(st.tail_i, st_w.tail_i)
    assert torch.equal(st.tail_q, st_w.tail_q)

    zero = torch.zeros(BANDS, c * t - 1)
    w_whole, *_ = chc.channelize_branches_plain(x, tp.p, zero, zero)
    w_a, ti, tq = chc.channelize_branches_plain(x[:, :half], tp.p, zero,
                                                zero)
    w_b, *_ = chc.channelize_branches_plain(x[:, half:], tp.p, ti, tq)
    assert torch.equal(torch.cat([w_a, w_b], 1), w_whole)


def test_dc_response_and_rssi_match_dy4tpu():
    jp, tp, js, ts, x_u8, _ = _setup(16, 12)
    for a, b in zip(chz.dc_response(tp), jchz.dc_response(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    (ri, rq), _ = jchz.channelize_block_u8(jp, js, jnp.asarray(x_u8),
                                           impl="stock")
    got = chz.rssi_dbfs(torch.from_numpy(np.array(ri)),
                        torch.from_numpy(np.array(rq)))
    assert got.shape == (BANDS, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(jchz.rssi_dbfs(ri, rq)),
                               atol=1e-4)
    # an empty channel reads the -120 dB floor, not -inf
    z = torch.zeros(2, 4, 8)
    assert torch.all(chz.rssi_dbfs(z, z) == -120.0)


@pytest.mark.parametrize("bands", [None, 1, 3], ids=["none", "one", "batch3"])
def test_dft_mats_corrected_matches_dy4tpu(bands):
    jp = jchz.make_channelizer(8, cfg.if_fs)
    tp = chz.make_channelizer(8, cfg.if_fs, device="cpu")
    jco = tco = None
    if bands is not None:
        jco, tco = _coeffs(3)
        if bands == 1:   # unbatched coefficients
            jco = jiq.IQCorrCoeffs(*(a[0] for a in jco))
            tco = iqcorr.IQCorrCoeffs(*(a[0] for a in tco))
    ref = jchz._dft_mats_corrected(jp, jco)
    ours = chz._dft_mats_corrected(tp, tco)
    for name, o, r in zip(("g_i", "g_q", "kg_r", "kg_i"), ours, ref):
        if r is None:
            assert o is None, name
            continue
        assert tuple(o.shape) == np.asarray(r).shape, name
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6,
                                   err_msg=name)


def test_folded_correction_equals_post_bank():
    """The kernel route's folded-DFT IQ correction equals the plain
    route's post-bank ``apply_channelized``, and both equal dy4tpu's stock
    route with the same per-band coefficients (as
    tests/test_wideband_iqcorr.py holds dy4tpu's two routes)."""
    jp, tp, js, ts, x_u8, _ = _setup(16, 12, seed=5)
    jco, tco = _coeffs(BANDS)
    x = torch.from_numpy(x_u8)
    folded, fs = chz.channelize_u8_folded(
        tp, ts, x, corr=tco, branches=chc.channelize_branches_plain)
    post, ps = chz.channelize_block_u8(tp, ts, x, impl="plain", corr=tco)
    _close(folded, [p.numpy() for p in post], "folded vs post-bank")
    ref, _ = jchz.channelize_block_u8(jp, js, jnp.asarray(x_u8),
                                      impl="stock", corr=jco)
    _close(folded, ref, "folded vs dy4tpu")
    _close(post, ref, "post-bank vs dy4tpu")
    assert torch.equal(fs.tail_i, ps.tail_i)
    # the correction really moved the channels
    plain, _ = chz.channelize_block_u8(tp, ts, x, impl="plain")
    assert float((plain[0] - post[0]).abs().max()) > 1e-2


def test_channelize_branches_refuses_cpu_tensors():
    """B7's wrapper takes CUDA tensors only: no fallback, no launch."""
    _, tp, _, ts, x_u8, _ = _setup(16, 12)
    before = chc.channelize_branches.launches
    with pytest.raises(ValueError, match="CUDA"):
        chc.channelize_branches(torch.from_numpy(x_u8), tp.p, ts.tail_i,
                                ts.tail_q)
    with pytest.raises(ValueError, match="multiple of 2C"):
        chc.channelize_branches(torch.from_numpy(x_u8[:, :-2]), tp.p,
                                ts.tail_i, ts.tail_q)
    assert chc.channelize_branches.launches == before


def test_auto_route_on_cpu_is_the_plain_route():
    jp, tp, js, ts, x_u8, _ = _setup(8, 12)
    x = torch.from_numpy(x_u8)
    before = chc.channelize_branches.launches
    auto, sa = chz.channelize_block_u8(tp, ts, x)
    plain, sp = chz.channelize_block_u8(tp, ts, x, impl="plain")
    assert chc.channelize_branches.launches == before
    assert all(torch.equal(a, b) for a, b in zip(auto, plain))
    assert torch.equal(sa.tail_q, sp.tail_q)
    with pytest.raises(ValueError, match="impl"):
        chz.channelize_block_u8(tp, ts, x, impl="pallas")


def test_channelizer_vs_direct_sum():
    """The defining sum y_c[m] = sum_k h[k] x[mC-k] e^{-j 2pi c (mC-k)/C},
    evaluated directly in float64 (as tests/test_channelizer.py does)."""
    c, t, m_out = 8, 4, 12
    params = chz.make_channelizer(c, 240e3, taps_per_branch=t, device="cpu")
    k = c * t
    rng = np.random.default_rng(0)
    x = rng.standard_normal(c * m_out) + 1j * rng.standard_normal(c * m_out)
    tail = rng.standard_normal(k - 1) + 1j * rng.standard_normal(k - 1)
    h = params.h.double().numpy()
    ext = np.concatenate([tail, x])
    ks = np.arange(k)
    want = np.array([[np.sum(h * ext[m * c + k - 1 - ks]
                             * np.exp(-2j * np.pi * ch * (m * c - ks) / c))
                      for m in range(m_out)] for ch in range(c)])
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    (y_i, y_q), _ = chz.channelize_block(
        params, chz.ChannelizerState(f32(tail.real), f32(tail.imag)),
        f32(x.real), f32(x.imag))
    np.testing.assert_allclose(y_i.numpy(), want.real, atol=2e-4)
    np.testing.assert_allclose(y_q.numpy(), want.imag, atol=2e-4)

"""The port's PLL (dy4tpu_torch.ops.pll, plain scan) against dy4tpu's
scan and its Pallas kernel (interpret mode), on the same numpy inputs.

Against dy4tpu the PLL is held to tolerance only: XLA may contract the
step's multiply-adds, so the phases drift apart by a few ulps.  Inside
the port the recurrence must be exactly reproducible: two chained blocks
equal one block of twice the length, bit for bit (the CUDA kernel is
held bitwise to this plain scan on the card by chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import pll as jpll  # noqa: E402
from dy4tpu_torch.ops import pll, pll_cuda  # noqa: E402

cfg = get_mode(0)
N = cfg.if_per_block

# the receiver's two loop configurations, stacked on a lane axis, and the
# stereo pilot loop alone
LANES = dict(freq=np.array([cfg.pll_freq, cfg.rds_pll_freq], np.float32),
             fs=cfg.if_fs,
             nco_scale=np.array([cfg.pll_nco_scale, cfg.rds_pll_nco_scale],
                                np.float32),
             norm_bandwidth=np.array([cfg.pll_bandwidth,
                                      cfg.rds_pll_bandwidth], np.float32))
PILOT = dict(freq=cfg.pll_freq, fs=cfg.if_fs, nco_scale=cfg.pll_nco_scale,
             norm_bandwidth=cfg.pll_bandwidth)


def _tones(rng, c, n, offset=0):
    """[c, 2, n]: a noisy 19 kHz pilot and 114 kHz carrier per channel."""
    t = (np.arange(n) + offset) / cfg.if_fs
    ph = rng.uniform(0, 2 * np.pi, (c, 2, 1))
    f = np.array([19e3, 114e3])[None, :, None]
    x = np.cos(2 * np.pi * f * t + ph) + 0.3 * rng.standard_normal((c, 2, n))
    x[:, :, :3] = 0.0          # zero-input guard at the block start
    return x.astype(np.float32)


def _state(rng, batch):
    """A mid-stream PLL state as numpy fields."""
    z = lambda lo, hi: rng.uniform(lo, hi, batch).astype(np.float32)  # noqa: E731
    return dict(feedback_i=z(-1, 1), feedback_q=z(-1, 1),
                integrator=z(-1e-3, 1e-3), phase_est=z(0, 4 * np.pi),
                angle=z(0, 4 * np.pi), nco=z(-1, 1), nco_q=z(-1, 1))


@pytest.mark.parametrize("kw", [LANES, PILOT], ids=["lanes", "pilot"])
def test_loop_consts_bit_equal(kw):
    ours = pll._loop_consts(kw["freq"], kw["fs"], kw["norm_bandwidth"])
    ref = jpll._loop_consts(kw["freq"], kw["fs"], kw["norm_bandwidth"],
                            np.dtype(np.float32))
    for o, r in zip(ours, ref):
        assert np.asarray(o).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(o), np.asarray(r))


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("kw", [LANES, PILOT], ids=["lanes", "pilot"])
def test_plain_pll_matches_dy4tpu(kw, impl):
    rng = np.random.default_rng(0)
    x = _tones(rng, 3, N)
    if kw is PILOT:
        x = x[:, 0]
    st = _state(rng, x.shape[:-1])
    ni, nq, ns = pll.pll(torch.from_numpy(x),
                         pll.PLLState(**{k: torch.from_numpy(v)
                                         for k, v in st.items()}),
                         impl="plain", **kw)
    jni, jnq, jns = jpll.pll(jnp.asarray(x),
                             jpll.PLLState(**{k: jnp.asarray(v)
                                              for k, v in st.items()}),
                             impl=impl, **kw)
    # a few ulps of phase drift over 7680 steps, times the NCO scale
    np.testing.assert_allclose(ni.numpy(), np.asarray(jni), atol=2e-4)
    np.testing.assert_allclose(nq.numpy(), np.asarray(jnq), atol=2e-4)
    for f in jpll.PLLState._fields:
        np.testing.assert_allclose(getattr(ns, f).numpy(),
                                   np.asarray(getattr(jns, f)), atol=2e-4,
                                   err_msg=f)


def test_two_chained_blocks_equal_one_long_block():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_tones(rng, 2, 2 * N))
    st = pll.PLLState(**{k: torch.from_numpy(v)
                         for k, v in _state(rng, (2, 2)).items()})
    i_long, q_long, s_long = pll.pll(x, st, impl="plain", **LANES)
    i1, q1, s1 = pll.pll(x[..., :N], st, impl="plain", **LANES)
    i2, q2, s2 = pll.pll(x[..., N:], s1, impl="plain", **LANES)
    assert torch.equal(torch.cat([i1, i2], -1), i_long)
    assert torch.equal(torch.cat([q1, q2], -1), q_long)
    for a, b in zip(s2, s_long):
        assert torch.equal(a, b)


def test_auto_on_cpu_is_the_plain_scan():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_tones(rng, 2, 512))
    st = pll.init_state((2, 2))
    a = pll.pll(x, st, impl="auto", **LANES)
    p = pll.pll(x, st, impl="plain", **LANES)
    for u, v in zip(jax.tree.leaves(a[:2]) + list(a[2]),
                    jax.tree.leaves(p[:2]) + list(p[2])):
        assert torch.equal(u, v)
    assert pll_cuda.phase_scan.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        pll.pll(x, st, impl="kernel", **LANES)

"""The plain versions of the port's back-end kernels (B3
``backend_cuda.fused_audio_backend_plain``, B4
``resample_cuda.fused_rds_backend_plain``, B5
``resample_cuda.fused_audio_backend_rational_plain``; the wrappers run them
on CPU tensors) against dy4tpu's Pallas kernels in interpret mode,
float32, to atol 1e-5 with the tails exact, as in
tests/test_backend_pallas.py: at mode 0, and at the other modes each
kernel serves (B3 at mode 1, B4 at mode 2, B5 at modes 2 and 3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import backend_pallas, resample_pallas  # noqa: E402
from dy4tpu_torch.ops import backend_cuda, firdes, resample_cuda  # noqa: E402

cfg = get_mode(0)
C = 3


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _compare(ours, ref, exact):
    """Every entry to atol 1e-5, and those at the indices ``exact`` (the
    carried input tails) bit for bit."""
    for i, (o, r) in enumerate(zip(ours, ref)):
        assert o.shape == r.shape
        if i in exact:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


def _audio_args(rng, c=cfg):
    h = firdes.lpf(c.if_fs * c.audio_up, c.audio_fc, c.audio_taps,
                   up_factor=c.audio_up)
    s = (c.audio_taps - 1) // c.audio_up
    n = c.if_per_block
    return [_f32(rng, C, n), _f32(rng, C, n), _f32(rng, C, n), h,
            _f32(rng, C, s), _f32(rng, C, s)]


def _rds_args(rng, c=cfg):
    h_lpf = firdes.lpf(c.if_fs * c.rds_up, c.rds_fc, c.rds_taps,
                       up_factor=c.rds_up)
    h_rrc = firdes.rrc(c.rds_fs, c.rds_rrc_taps, c.rds_symbol_rate)
    s = (c.rds_taps - 1) // c.rds_up
    s2 = c.rds_rrc_taps - 1
    n = c.if_per_block
    return [_f32(rng, C, n), _f32(rng, C, n), _f32(rng, C, n), h_lpf, h_rrc,
            _f32(rng, C, s), _f32(rng, C, s), _f32(rng, C, s2),
            _f32(rng, C, s2)]


def test_plain_audio_backend_matches_pallas():
    rng = np.random.default_rng(3)
    args = _audio_args(rng)
    ours = backend_cuda.fused_audio_backend_plain(
        *(torch.from_numpy(a) for a in args), cfg.audio_down)
    ref = backend_pallas.fused_audio_backend(
        *(jnp.asarray(a) for a in args), cfg.audio_down,
        mm_dtype=jnp.float32, interpret=True)
    assert ours[0].shape == (C, cfg.audio_per_block)
    _compare(ours, ref, exact={3, 4})


def test_plain_rds_backend_matches_pallas():
    rng = np.random.default_rng(4)
    args = _rds_args(rng)
    ours = resample_cuda.fused_rds_backend_plain(
        *(torch.from_numpy(a) for a in args), cfg.rds_up, cfg.rds_down)
    ref = resample_pallas.fused_rds_backend(
        *(jnp.asarray(a) for a in args), cfg.rds_up, cfg.rds_down,
        mm_dtype=jnp.float32, interpret=True)
    assert ours[0].shape == (C, cfg.rds_per_block)
    _compare(ours, ref, exact={2, 3, 4, 5})


def test_plain_audio_backend_matches_pallas_mode1():
    """B3 at mode 1's decimation by 8."""
    c1 = get_mode(1)
    rng = np.random.default_rng(6)
    args = _audio_args(rng, c1)
    ours = backend_cuda.fused_audio_backend_plain(
        *(torch.from_numpy(a) for a in args), c1.audio_down)
    ref = backend_pallas.fused_audio_backend(
        *(jnp.asarray(a) for a in args), c1.audio_down,
        mm_dtype=jnp.float32, interpret=True)
    assert ours[0].shape == (C, c1.audio_per_block)
    _compare(ours, ref, exact={3, 4})


def test_plain_rds_backend_matches_pallas_mode2():
    """B4 at mode 2's 171/640 with 17271 taps."""
    c2 = get_mode(2)
    rng = np.random.default_rng(7)
    args = _rds_args(rng, c2)
    ours = resample_cuda.fused_rds_backend_plain(
        *(torch.from_numpy(a) for a in args), c2.rds_up, c2.rds_down)
    ref = resample_pallas.fused_rds_backend(
        *(jnp.asarray(a) for a in args), c2.rds_up, c2.rds_down,
        mm_dtype=jnp.float32, interpret=True)
    assert ours[0].shape == (C, c2.rds_per_block)
    # the RRC tails (4, 5) are resampler outputs, not carried inputs
    _compare(ours, ref, exact={2, 3})


@pytest.mark.parametrize("mode", [2, 3])
def test_plain_rational_audio_backend_matches_pallas(mode):
    """B5 at 147/800 (mode 2) and 147/1280 (mode 3), 14847 taps."""
    cm = get_mode(mode)
    rng = np.random.default_rng(10 + mode)
    args = _audio_args(rng, cm)
    ours = resample_cuda.fused_audio_backend_rational_plain(
        *(torch.from_numpy(a) for a in args), cm.audio_up, cm.audio_down)
    ref = resample_pallas.fused_audio_backend_rational(
        *(jnp.asarray(a) for a in args), cm.audio_up, cm.audio_down,
        mm_dtype=jnp.float32, interpret=True)
    assert ours[0].shape == (C, cm.audio_per_block)
    _compare(ours, ref, exact={3, 4})


@pytest.mark.parametrize("which", ["audio", "rds", "rational"])
def test_wrappers_on_cpu_run_the_plain_versions(which):
    rng = np.random.default_rng(5)
    if which == "audio":
        args = [torch.from_numpy(a) for a in _audio_args(rng)] + [
            cfg.audio_down]
        wrapper = backend_cuda.fused_audio_backend
        plain = backend_cuda.fused_audio_backend_plain
    elif which == "rational":
        c3 = get_mode(3)
        args = [torch.from_numpy(a) for a in _audio_args(rng, c3)] + [
            c3.audio_up, c3.audio_down]
        wrapper = resample_cuda.fused_audio_backend_rational
        plain = resample_cuda.fused_audio_backend_rational_plain
    else:
        args = [torch.from_numpy(a) for a in _rds_args(rng)] + [
            cfg.rds_up, cfg.rds_down]
        wrapper = resample_cuda.fused_rds_backend
        plain = resample_cuda.fused_rds_backend_plain
    before = wrapper.launches
    for a, b in zip(wrapper(*args), plain(*args)):
        assert torch.equal(a, b)
    assert wrapper.launches == before

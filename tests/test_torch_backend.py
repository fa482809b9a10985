"""The plain versions of the port's back-end kernels (B3
``backend_cuda.fused_audio_backend_plain``, B4
``resample_cuda.fused_rds_backend_plain``; the wrappers run them on CPU
tensors) against dy4tpu's Pallas kernels in interpret mode, float32, to
atol 1e-5 with the tails exact, as in tests/test_backend_pallas.py.
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
N = cfg.if_per_block


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _compare(ours, ref, n_tails):
    n_out = len(ours) - n_tails
    for i, (o, r) in enumerate(zip(ours, ref)):
        assert o.shape == r.shape
        if i < n_out:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)
        else:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def _audio_args(rng):
    h = firdes.lpf(cfg.if_fs, cfg.audio_fc, cfg.audio_taps)
    s = cfg.audio_taps - 1
    return [_f32(rng, C, N), _f32(rng, C, N), _f32(rng, C, N), h,
            _f32(rng, C, s), _f32(rng, C, s)]


def _rds_args(rng):
    h_lpf = firdes.lpf(cfg.if_fs * cfg.rds_up, cfg.rds_fc, cfg.rds_taps,
                       up_factor=cfg.rds_up)
    h_rrc = firdes.rrc(cfg.rds_fs, cfg.rds_rrc_taps, cfg.rds_symbol_rate)
    s = (cfg.rds_taps - 1) // cfg.rds_up
    s2 = cfg.rds_rrc_taps - 1
    return [_f32(rng, C, N), _f32(rng, C, N), _f32(rng, C, N), h_lpf, h_rrc,
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
    _compare(ours, ref, n_tails=2)


def test_plain_rds_backend_matches_pallas():
    rng = np.random.default_rng(4)
    args = _rds_args(rng)
    ours = resample_cuda.fused_rds_backend_plain(
        *(torch.from_numpy(a) for a in args), cfg.rds_up, cfg.rds_down)
    ref = resample_pallas.fused_rds_backend(
        *(jnp.asarray(a) for a in args), cfg.rds_up, cfg.rds_down,
        mm_dtype=jnp.float32, interpret=True)
    assert ours[0].shape == (C, cfg.rds_per_block)
    _compare(ours, ref, n_tails=4)


@pytest.mark.parametrize("which", ["audio", "rds"])
def test_wrappers_on_cpu_run_the_plain_versions(which):
    rng = np.random.default_rng(5)
    if which == "audio":
        args = [torch.from_numpy(a) for a in _audio_args(rng)] + [
            cfg.audio_down]
        wrapper = backend_cuda.fused_audio_backend
        plain = backend_cuda.fused_audio_backend_plain
    else:
        args = [torch.from_numpy(a) for a in _rds_args(rng)] + [
            cfg.rds_up, cfg.rds_down]
        wrapper = resample_cuda.fused_rds_backend
        plain = resample_cuda.fused_rds_backend_plain
    before = wrapper.launches
    for a, b in zip(wrapper(*args), plain(*args)):
        assert torch.equal(a, b)
    assert wrapper.launches == before

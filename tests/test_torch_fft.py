"""The port's Fourier transforms and PSD (dy4tpu_torch.ops.fft, and the
plain version of kernel B10 in ops/fft_cuda.py) against dy4tpu's on the
same numpy inputs, on CPU.

Twins of every case of tests/test_fft_psd.py, at its tolerances, plus:
the port's plain four-step against dy4tpu's Pallas kernel (interpret
mode, as dy4tpu's own tests run it) and its ``fft_four_step`` within
1e-5 of the largest magnitude; ``estimate_psd`` against dy4tpu's
``"jnp"`` and ``"four_step"`` routes within 1e-3 dB on white noise
(test_fft_psd.py's bar); and the routing: ``"auto"`` takes
``torch.fft.fft`` for a CPU tensor, and the kernel refuses a CPU tensor
and an N it does not take.  The kernel's radix plan (``_plan``, its
twiddle table and ``_fft_plan_model``, the kernel's passes in torch)
against ``torch.fft.fft`` and dy4tpu's Pallas kernel at every N of
4..2048.  The kernel itself runs only on the card (chip_smoke.py phase
6).
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.ops import fft as jfft  # noqa: E402
from dy4tpu.ops import fft_pallas as jfp  # noqa: E402
from dy4tpu_torch.ops import fft  # noqa: E402
from dy4tpu_torch.ops import fft_cuda  # noqa: E402

RNG = np.random.default_rng(11)
PLAN_NS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)   # all B10 takes


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_dft_matches_numpy():
    x = RNG.normal(size=64).astype(np.float32)
    got = fft.dft(_t(x)).numpy()
    np.testing.assert_allclose(got, np.fft.fft(x), atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(jfft.dft(jnp.asarray(x))),
                               atol=1e-4)


def test_idft_inverts_dft():
    x = RNG.normal(size=128).astype(np.float32)
    rt = fft.idft(fft.dft(_t(x))).numpy()
    np.testing.assert_allclose(rt.real, x, atol=1e-3)
    np.testing.assert_allclose(rt.imag, 0, atol=1e-3)


def test_fft_radix2_matches_numpy():
    for n in (8, 64, 512):
        x = (RNG.normal(size=n) + 1j * RNG.normal(size=n)).astype(np.complex64)
        got = fft.fft_radix2(_t(x)).numpy()
        np.testing.assert_allclose(got, np.fft.fft(x), atol=1e-2)
        np.testing.assert_allclose(
            got, np.asarray(jfft.fft_radix2(jnp.asarray(x))), atol=1e-4)


def test_fft_radix2_batched():
    x = RNG.normal(size=(5, 256)).astype(np.float32)
    got = fft.fft_radix2(_t(x)).numpy()
    np.testing.assert_allclose(got, np.fft.fft(x, axis=-1), atol=1e-2)


def test_fft_radix2_refuses_other_lengths():
    with pytest.raises(ValueError, match="power of two"):
        fft.fft_radix2(torch.zeros(3, 48))


def test_ifft_radix2_roundtrip():
    x = (RNG.normal(size=512) + 1j * RNG.normal(size=512)).astype(np.complex64)
    rt = fft.ifft_radix2(fft.fft_radix2(_t(x))).numpy()
    np.testing.assert_allclose(rt, x, atol=1e-3)


def test_bit_reversal_and_window_equal_dy4tpu():
    for n in (4, 64, 512, 2048):
        np.testing.assert_array_equal(fft._bit_reverse_indices(n),
                                      jfft._bit_reverse_indices(n))
        np.testing.assert_array_equal(fft.hann_sq(n), jfft.hann_sq(n))
    assert fft.NFFT == jfft.NFFT == 512


def test_estimate_psd_finds_tone():
    fs = 48e3
    t = np.arange(8192) / fs
    x = np.sin(2 * np.pi * 6e3 * t).astype(np.float32)
    freq, psd = fft.estimate_psd(_t(x), nfft=512, fs=fs)
    psd = psd.numpy()
    assert freq.shape == (256,) and psd.shape == (256,)
    peak = freq[psd.argmax()]
    assert abs(peak - 6e3) < fs / 512


def test_estimate_psd_matches_naive_bartlett():
    fs = 1e3
    x = RNG.normal(size=2048).astype(np.float32)
    freq, psd = fft.estimate_psd(_t(x), nfft=512, fs=fs)

    # naive Bartlett in dB (fmSupportLib.py:86-161 semantics)
    hann = np.sin(np.arange(512) * np.pi / 512) ** 2
    segs = []
    for k in range(len(x) // 512):
        xf = np.fft.fft(x[k * 512:(k + 1) * 512] * hann)[:256]
        p = 2 * (np.abs(xf) ** 2) / (fs * 256)
        segs.append(10 * np.log10(p))
    ref = np.mean(segs, axis=0)
    np.testing.assert_allclose(psd.numpy(), ref, atol=1e-2)


def test_fft_four_step_matches_dft():
    """The port's plain four-step against the O(N^2) DFT (the twin of
    test_fft_pallas_four_step_matches_dft; the kernel's own check runs on
    the card)."""
    rng = np.random.default_rng(12)
    for n in (64, 512):
        x = (rng.standard_normal((4, n))
             + 1j * rng.standard_normal((4, n))).astype(np.complex64)
        ref = fft.dft(_t(x)).numpy()
        scale = np.abs(ref).max()
        four = fft_cuda.fft_four_step(_t(x)).numpy()
        np.testing.assert_allclose(four / scale, ref / scale, atol=1e-5)


@pytest.mark.parametrize("n", [4, 64, 512, 2048])
def test_fft_four_step_equals_dy4tpu_pallas_and_four_step(n):
    """The port's plain version of B10 against dy4tpu's Pallas kernel in
    interpret mode and against its ``fft_four_step``, real and complex
    rows, within 1e-5 of the largest magnitude; the host-built constants
    are equal."""
    rng = np.random.default_rng(n)
    for x in (rng.standard_normal((5, n)).astype(np.float32),
              (rng.standard_normal((5, n))
               + 1j * rng.standard_normal((5, n))).astype(np.complex64)):
        ours = fft_cuda.fft_four_step(_t(x)).numpy()
        assert ours.dtype == np.complex64 and ours.shape == (5, n)
        pal = np.asarray(jfp.fft_pallas(jnp.asarray(x), interpret=True))
        four = np.asarray(jfp.fft_four_step(jnp.asarray(x)))
        scale = np.abs(four).max()
        np.testing.assert_allclose(ours / scale, pal / scale, atol=1e-5)
        np.testing.assert_allclose(ours / scale, four / scale, atol=1e-5)
    for a, b in zip(fft_cuda._consts(n), jfp._consts(n)):
        np.testing.assert_array_equal(a, b)
    assert fft_cuda.kernel_supported(n) == jfp.pallas_supported(n)


def test_kernel_supported_equals_pallas_supported():
    for n in (2, 3, 4, 6, 8, 100, 128, 2048, 4096, 8192, 16384, 32768):
        assert fft_cuda.kernel_supported(n) == jfp.pallas_supported(n), n


@pytest.mark.parametrize("nfft", [64, 512])
def test_estimate_psd_equals_dy4tpu(nfft):
    """On [3, 4096] white noise: the port's "torch" and "four_step" routes
    against dy4tpu's "jnp" and "four_step" within 1e-3 dB, the same
    frequency grid."""
    x = np.random.default_rng(13).standard_normal((3, 4096)).astype(
        np.float32)
    f_j, p_j = jfft.estimate_psd(jnp.asarray(x), nfft=nfft, fs=48e3,
                                 impl="jnp")
    _, p_j4 = jfft.estimate_psd(jnp.asarray(x), nfft=nfft, fs=48e3,
                                impl="four_step")
    for impl in ("torch", "four_step"):
        f, p = fft.estimate_psd(_t(x), nfft=nfft, fs=48e3, impl=impl)
        np.testing.assert_array_equal(f, f_j)
        assert p.shape == (3, nfft // 2) and p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), np.asarray(p_j), atol=1e-3)
        np.testing.assert_allclose(p.numpy(), np.asarray(p_j4), atol=1e-3)


def test_estimate_psd_impls_agree():
    """The port's routes agree with each other (the twin of dy4tpu's
    test: there the Pallas route, here the kernel's plain version)."""
    x = _t(np.random.default_rng(13).standard_normal(4096).astype(
        np.float32))
    f_t, p_t = fft.estimate_psd(x, nfft=512, fs=48e3, impl="torch")
    f_4, p_4 = fft.estimate_psd(x, nfft=512, fs=48e3, impl="four_step")
    np.testing.assert_array_equal(f_t, f_4)
    np.testing.assert_allclose(p_4.numpy(), p_t.numpy(), atol=1e-3)


def test_auto_on_a_cpu_tensor_takes_torch_fft(monkeypatch):
    """"auto" on a CPU tensor is ``torch.fft.fft`` (dy4tpu's "jnp" off
    the TPU), bit for bit, and touches neither the kernel nor the
    four-step."""
    x = _t(np.random.default_rng(14).standard_normal((2, 2048)).astype(
        np.float32))
    _, want = fft.estimate_psd(x, nfft=256, fs=1e3, impl="torch")

    def refuse(*a, **k):
        raise AssertionError("not the CPU route")

    monkeypatch.setattr(fft_cuda, "fft", refuse)
    monkeypatch.setattr(fft_cuda, "fft_four_step", refuse)
    _, got = fft.estimate_psd(x, nfft=256, fs=1e3)
    assert torch.equal(got, want)


def test_kernel_refuses_cpu_tensors_and_unsupported_n():
    """``impl="kernel"`` raises on a CPU tensor and on an N that B10 does
    not take, and counts no launch; so does the wrapper, and on a dtype
    other than float32 / complex64."""
    before = fft_cuda.fft.launches
    x = torch.zeros(2, 1024)
    with pytest.raises(ValueError, match="CUDA"):
        fft.estimate_psd(x, nfft=512, impl="kernel")
    with pytest.raises(ValueError, match="4..2048"):
        fft.estimate_psd(torch.zeros(2, 8192), nfft=4096, impl="kernel")
    with pytest.raises(ValueError, match="float32 or complex64"):
        fft_cuda.fft(torch.zeros(2, 64, dtype=torch.float64))
    with pytest.raises(ValueError, match="impl"):
        fft.estimate_psd(x, nfft=512, impl="pallas")
    assert fft_cuda.fft.launches == before


def test_vector_magnitude_equals_dy4tpu():
    x = (RNG.normal(size=(3, 64)) + 1j * RNG.normal(size=(3, 64))).astype(
        np.complex64)
    np.testing.assert_allclose(fft.vector_magnitude(_t(x)).numpy(),
                               np.asarray(jfft.vector_magnitude(
                                   jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("n", PLAN_NS)
def test_plan_radices(n):
    """B10's radix plan: radices of 2, 4, 8 or 16 whose product is N, the
    first one the kernel's elements per thread, packed 4 bits a pass as
    the kernel reads them; the twiddle table holds W_{Ns R}^(k r) of every
    pass after the first at [(r - 1) Ns + k], computed in float64."""
    plan = fft_cuda._plan(n)
    assert int(np.prod(plan)) == n
    assert all(r in (2, 4, 8, 16) for r in plan)
    assert plan[0] == (8 if n >= 8 else 4)
    assert all(r == 8 for r in plan[:-1])
    code = fft_cuda._plan_code(n)
    assert [1 << (code >> 4 * p & 15) for p in range(len(plan))] == list(plan)
    assert code >> 4 * len(plan) == 0
    tw = fft_cuda._plan_twiddles(n)
    assert tw.dtype == np.complex64
    ns, off = plan[0], 0
    for r in plan[1:]:
        k = np.arange(ns)
        for j in range(1, r):
            want = np.exp(-2j * np.pi * k * j / (ns * r)).astype(np.complex64)
            np.testing.assert_array_equal(tw[off + (j - 1) * ns + k], want)
        off += (r - 1) * ns
        ns *= r
    assert len(tw) == off
    with pytest.raises(ValueError, match="4..2048"):
        fft_cuda._plan(2 * 2048)


@pytest.mark.parametrize("n", PLAN_NS)
def test_plan_model_equals_torch_fft_and_dy4tpu_pallas(n):
    """``_fft_plan_model`` (B10's passes, twiddle indices, butterflies and
    output order) against ``torch.fft.fft`` and dy4tpu's Pallas kernel in
    interpret mode, real and complex rows, on an odd row count, within
    1e-5 of the largest magnitude."""
    rng = np.random.default_rng(100 + n)
    for x in (rng.standard_normal((7, n)).astype(np.float32),
              (rng.standard_normal((7, n))
               + 1j * rng.standard_normal((7, n))).astype(np.complex64)):
        ours = fft_cuda._fft_plan_model(_t(x)).numpy()
        assert ours.dtype == np.complex64 and ours.shape == (7, n)
        ref = torch.fft.fft(_t(x)).numpy()
        pal = np.asarray(jfp.fft_pallas(jnp.asarray(x), interpret=True))
        scale = np.abs(ref).max()
        np.testing.assert_allclose(ours / scale, ref / scale, atol=1e-5)
        np.testing.assert_allclose(ours / scale, pal / scale, atol=1e-5)


def test_plan_model_real_rows_at_the_psd_path_shape():
    """Real rows as the PSD path gives them (N = 512, Hann-windowed, a
    prime number of rows as chip_smoke.py's FFT_ROWS): the model within
    1e-5 of each batch's largest magnitude of ``torch.fft.fft``, the
    batch dims kept."""
    rng = np.random.default_rng(1531)
    x = (rng.standard_normal((1531, 512)) * fft.hann_sq(512)).astype(
        np.float32).reshape(1531, 1, 512)
    ours = fft_cuda._fft_plan_model(_t(x))
    ref = torch.fft.fft(_t(x))
    assert ours.shape == (1531, 1, 512)
    scale = float(ref.abs().max())
    assert float((ours - ref).abs().max()) <= 1e-5 * scale


def test_plan_model_is_used_by_no_path():
    """``_fft_plan_model`` is for these tests: no module of the port but
    its own calls it."""
    pkg = pathlib.Path(fft_cuda.__file__).resolve().parents[1]
    users = [p for p in pkg.rglob("*.py")
             if "_fft_plan_model" in p.read_text()]
    assert users == [pathlib.Path(fft_cuda.__file__).resolve()]

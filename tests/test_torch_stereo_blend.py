"""Pilot-lock SNR estimate + weak-signal stereo blend through the port
(plain paths on the CPU), the twin of tests/test_stereo_blend.py at its
bars:

1. blend algebra: a high SNR is the identity, a low one collapses to mono;
2. the pilot-SNR estimator reads high on a clean stereo broadcast, low on
   a noisy one, and floor-level on a pilot-less (mono) transmission;
3. end to end, on a noisy capture the blended output's L/R difference
   power drops by an order of magnitude while the sum channel is kept.

The five captures ride one batch (``torch_batch.run_batch``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.ops import mix  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402
from torch_batch import run_batch  # noqa: E402

cfg = get_mode(0)
# (blocks, noise, pilot) of test_stereo_blend.py's five captures
CASES = {"clean6": (6, 0.0, True), "noisy6": (6, 1.2, True),
         "nopilot6": (6, 0.0, False), "clean8": (8, 0.0, True),
         "noisy8": (8, 1.2, True)}


def _capture(n_blocks, noise=0.0, pilot=True):
    n_audio = n_blocks * cfg.audio_per_block
    kw = dict(left=fm.tone(800.0, cfg.audio_fs, n_audio, amp=0.8),
              right=fm.tone(2400.0, cfg.audio_fs, n_audio, amp=0.8),
              noise=noise)
    if not pilot:
        kw.update(a_pilot=0.0, a_stereo=0.0)
    return fm.synthesize(cfg, n_blocks, **kw)


@pytest.fixture(scope="module")
def outs():
    """{case: (left, right, pilot_snr_db)} as tensors [its blocks, ...]."""
    o = run_batch(cfg, [_capture(*c) for c in CASES.values()])
    return {name: (o.left[:c[0], ch], o.right[:c[0], ch],
                   o.pilot_snr_db[:c[0], ch])
            for ch, (name, c) in enumerate(CASES.items())}


def test_blend_algebra():
    rng = np.random.default_rng(0)
    l = torch.as_tensor(rng.standard_normal((2, 64)), dtype=torch.float32)
    r = torch.as_tensor(rng.standard_normal((2, 64)), dtype=torch.float32)
    hi = torch.full((2,), 30.0)      # >= full_db -> identity
    lo = torch.full((2,), -10.0)     # <= mono_db -> mono
    bl, br = mix.stereo_blend(l, r, hi)
    np.testing.assert_allclose(bl.numpy(), l.numpy(), atol=1e-6)
    np.testing.assert_allclose(br.numpy(), r.numpy(), atol=1e-6)
    bl, br = mix.stereo_blend(l, r, lo)
    m = 0.5 * (l.numpy() + r.numpy())
    np.testing.assert_allclose(bl.numpy(), m, atol=1e-6)
    np.testing.assert_allclose(br.numpy(), m, atol=1e-6)


def test_pilot_snr_estimator_levels(outs):
    """dy4tpu's measured curve: clean ~16.5 dB, noise=1.2 ~5.9 dB, a
    pilot-less transmission ~-32 dB."""
    snr = {k: outs[k][2].numpy()[2:] for k in ("clean6", "noisy6",
                                                "nopilot6")}
    assert snr["clean6"].mean() > 15.0, snr
    assert snr["clean6"].mean() > snr["noisy6"].mean() + 6.0, snr
    # no pilot: the estimator must NOT report a confident lock
    assert snr["nopilot6"].mean() < 0.0, snr


@pytest.mark.parametrize("case,expect_stereo", [("clean8", True),
                                                ("noisy8", False)])
def test_blend_collapses_noisy_stereo_not_clean(outs, case, expect_stereo):
    left, right, snr = outs[case]
    bl, br = mix.stereo_blend(left, right, snr)
    l, r = left.numpy()[3:], right.numpy()[3:]
    bl, br = bl.numpy()[3:], br.numpy()[3:]
    diff_raw = np.mean((l - r) ** 2)
    diff_blend = np.mean((bl - br) ** 2)
    sum_raw = np.mean((l + r) ** 2)
    sum_blend = np.mean((bl + br) ** 2)
    # the sum (mono) channel is preserved by the blend algebra
    np.testing.assert_allclose(sum_blend, sum_raw, rtol=1e-5)
    if expect_stereo:
        # clean: ~16.5 dB > full_db=14 -> identity
        np.testing.assert_allclose(diff_blend, diff_raw, rtol=1e-3)
    else:
        # ~5.9 dB -> g ~ 0.2, difference power scales by g^2
        assert diff_blend < 0.15 * diff_raw, (diff_blend, diff_raw)

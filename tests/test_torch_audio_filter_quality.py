"""The Kaiser audio resampler filter of the port (``firdes.lpf_kaiser``
through ``make_params(audio_filter="kaiser")``) against the reference's
Hann design, the twin of tests/test_audio_filter_quality.py at its bars:
at least 15 dB more stopband over the band that folds into the audio
passband, below -85 dB, no more than 1 dB of extra passband droop; a tone
above the output Nyquist folds back at least 15 dB quieter (below -80 dB)
through the receiver's own polyphase call; and the Kaiser params run the
whole receiver.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.ops import fir, firdes  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402


def _response_db(h, n_fft=1 << 18):
    H = np.fft.rfft(np.asarray(h, np.float64), n_fft)
    return 20.0 * np.log10(np.maximum(np.abs(H), 1e-12))


@pytest.mark.parametrize("mode", [2, 3])  # the taps*147 resampler modes
def test_kaiser_stopband_beats_reference(mode):
    cfg = get_mode(mode)
    params = {name: rx.make_params(cfg, audio_filter=name, device=DEV)
              for name in ("reference", "kaiser")}
    h_ref = params["reference"].audio_coeff.numpy()
    h_k = params["kaiser"].audio_coeff.numpy()
    assert h_k.shape == h_ref.shape  # drop-in geometry
    fs = cfg.if_fs * cfg.audio_up
    np.testing.assert_array_equal(
        h_k, firdes.lpf_kaiser(fs, cfg.audio_fc, cfg.audio_taps,
                               up_factor=cfg.audio_up).astype(np.float32))

    n_fft = 1 << 18
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / fs)
    db_ref = _response_db(h_ref, n_fft)
    db_k = _response_db(h_k, n_fft)
    # normalise to each filter's DC level (both carry the x U gain)
    db_ref -= db_ref[0]
    db_k -= db_k[0]
    # content above audio_fs - fc folds into the audible passband
    fold = freqs > (cfg.audio_fs - cfg.audio_fc)
    worst_ref = db_ref[fold].max()
    worst_k = db_k[fold].max()
    assert worst_k < worst_ref - 15.0, (worst_ref, worst_k)
    assert worst_k < -85.0, worst_k
    pb = freqs < cfg.audio_fc
    assert (db_ref[pb] - db_k[pb]).max() < 1.0, (db_ref[pb] - db_k[pb]).max()


def test_kaiser_alias_rejection_end_to_end():
    """Two tones through the receiver's polyphase call at mode 2 (240 kHz
    IF -> 44.1 kHz audio, U/D = 147/800): the tone above the output
    Nyquist folds back ~30 dB quieter with the Kaiser design."""
    cfg = get_mode(2)
    n_in = 6 * cfg.if_per_block
    t = np.arange(n_in) / cfg.if_fs
    f_pass, f_alias = 5000.0, 40000.0  # 40 kHz > 22.05 kHz Nyquist
    x = (np.sin(2 * np.pi * f_pass * t)
         + np.sin(2 * np.pi * f_alias * t)).astype(np.float32)
    level = {}
    for name in ("reference", "kaiser"):
        params = rx.make_params(cfg, audio_filter=name, device=DEV)
        tail = fir.init_state(cfg.audio_taps, cfg.audio_up, device=DEV)
        y, _ = fir.block_fir_resample(torch.from_numpy(x),
                                      params.audio_coeff, tail,
                                      up=cfg.audio_up, down=cfg.audio_down)
        y = y.numpy().astype(np.float64)
        y = y[len(y) // 3:]  # drop transient
        Y = np.abs(np.fft.rfft(y * np.kaiser(len(y), 24.0)))
        freqs = np.fft.rfftfreq(len(y), d=1.0 / cfg.audio_fs)
        pass_pow = Y[np.argmin(np.abs(freqs - f_pass))]
        # the 40 kHz tone folds to 44.1 - 40 = 4.1 kHz
        alias_pow = Y[np.argmin(np.abs(freqs - (cfg.audio_fs - f_alias)))]
        level[name] = 20 * np.log10(alias_pow / pass_pow)
    assert level["kaiser"] < level["reference"] - 15.0, level
    assert level["kaiser"] < -80.0, level


def test_kaiser_params_run_the_full_receiver():
    """``audio_filter="kaiser"`` threads through ``receiver_step``
    unchanged (same shapes); one block gives finite audio."""
    cfg = get_mode(0)
    params = rx.make_params(cfg, audio_filter="kaiser", device=DEV)
    state = rx.init_state(cfg, device=DEV)
    rng = np.random.default_rng(0)
    blk = torch.from_numpy(rng.integers(0, 256, cfg.block_size,
                                        dtype=np.uint8))
    _, out = rx.receiver_step(params, state, blk, cfg)
    assert out.left.shape == (cfg.audio_per_block,)
    assert torch.isfinite(out.left).all()

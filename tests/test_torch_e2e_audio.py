"""End-to-end mono + stereo decode of a synthesised FM broadcast through
the port's receiver (plain paths on the CPU): the twin of
tests/test_e2e_audio.py, at its bars.

Distinct L/R tones must reappear in the right output channels with more
than 15 dB of separation in all four modes, a mono tone must carry most of
the mono power, and the output must not depend on how the stream is cut
into blocks.  The plain PLL runs a torch loop over time, whose cost does
not grow with the channel count, so the mode-0 captures of the three tests
ride one batch (``torch_batch.run_batch``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402
from torch_batch import run_batch  # noqa: E402

LF, RF = 800.0, 2400.0
STEREO_BLOCKS, MONO_BLOCKS, INV_BLOCKS = 8, 6, 4


def _tone_power(x, freq, fs):
    """Power of x at freq via Goertzel-style correlation."""
    t = np.arange(len(x)) / fs
    c = x @ np.exp(-2j * np.pi * freq * t)
    return 2 * np.abs(c) ** 2 / len(x) ** 2


def _run(cfg, captures):
    outs = run_batch(cfg, captures)
    return {f: getattr(outs, f).numpy() for f in ("mono", "left", "right")}


def _stereo_capture(cfg, n_blocks):
    n_audio = n_blocks * cfg.audio_per_block
    return fm.synthesize(cfg, n_blocks,
                         left=fm.tone(LF, cfg.audio_fs, n_audio, amp=0.8),
                         right=fm.tone(RF, cfg.audio_fs, n_audio, amp=0.8))


def _mono_capture(cfg, n_blocks, freq, amp):
    audio = fm.tone(freq, cfg.audio_fs, n_blocks * cfg.audio_per_block,
                    amp=amp)
    return fm.synthesize(cfg, n_blocks, left=audio, right=audio)


@pytest.fixture(scope="module")
def mode0():
    """Mode 0: channel 0 the stereo capture, 1 the 1 kHz mono tone, 2 the
    440 Hz stream of the block-size test."""
    cfg = get_mode(0)
    caps = [_stereo_capture(cfg, STEREO_BLOCKS),
            _mono_capture(cfg, MONO_BLOCKS, 1000.0, 0.9),
            _mono_capture(cfg, INV_BLOCKS, 440.0, 0.5)]
    return caps, _run(cfg, caps)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_stereo_tones_separate(mode, mode0):
    cfg = get_mode(mode)
    outs = (mode0[1] if mode == 0
            else _run(cfg, [_stereo_capture(cfg, STEREO_BLOCKS)]))
    # skip the first blocks (filter warm-up + PLL lock)
    l = outs["left"][3:STEREO_BLOCKS, 0].ravel()
    r = outs["right"][3:STEREO_BLOCKS, 0].ravel()
    l_want = _tone_power(l, LF, cfg.audio_fs)
    l_leak = _tone_power(l, RF, cfg.audio_fs)
    r_want = _tone_power(r, RF, cfg.audio_fs)
    r_leak = _tone_power(r, LF, cfg.audio_fs)
    # channel separation > 15 dB
    assert l_want > 30 * l_leak, (l_want, l_leak)
    assert r_want > 30 * r_leak, (r_want, r_leak)


def test_mono_tone_mode0(mode0):
    cfg = get_mode(0)
    mono = mode0[1]["mono"][2:MONO_BLOCKS, 1].ravel()
    p_sig = _tone_power(mono, 1000.0, cfg.audio_fs)
    p_tot = np.mean((mono - mono.mean()) ** 2)
    # most of the mono power is the tone
    assert p_sig > 0.5 * p_tot
    assert p_sig > 1e-4  # non-degenerate level


def test_block_size_invariance_mono(mode0):
    """Streaming property: the carried state makes the output independent
    of how the stream is cut: the batched ``run_blocks`` (channel 2) and
    one unbatched ``receiver_step`` a block agree."""
    cfg = get_mode(0)
    iq = mode0[0][2]
    a1 = mode0[1]["mono"][:INV_BLOCKS, 2].ravel()
    params = rx.make_params(cfg, device=DEV)
    st = rx.init_state(cfg, device=DEV)
    chunks = []
    for b in range(INV_BLOCKS):
        blk = torch.from_numpy(iq[b * cfg.block_size:(b + 1) * cfg.block_size])
        st, out = rx.receiver_step(params, st, blk, cfg)
        chunks.append(out.mono.numpy())
    np.testing.assert_allclose(a1, np.concatenate(chunks), atol=1e-5)

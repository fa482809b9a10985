"""Decode robustness and recovery on the port (plain paths on the CPU): the
twins of tests/test_noise.py (RDS and stereo through noise 0.05 and a
two-echo urban profile), tests/test_recovery.py (the RDS subcarrier
dropped for 4 blocks, then PI re-acquired; the PLL's NCO after 1.5 M
samples) and tests/test_multichannel.py (three stations in one batch, no
cross-talk), at their bars.

The mode-0 captures, made by the same synth calls as dy4tpu's tests,
ride one batch of six channels (``torch_batch.run_batch``): noise (20
blocks), echoes (14), the 14 + 4 + 14 dropout stream (32) and the three
stations (20 each).  Held to dy4tpu's un-jitted ``receiver_step``
(``dy4tpu_window``) over windows of 8 blocks, one batch of seven: every
channel over [0, 8) (the lock-in), and the dropout stream over [14, 22)
(the dropout and the re-lock) from the port's state after block 13.
RDS hard symbols, resync flags and CDR offsets equal; audio and RDS
baseband within atol 1e-4, the pilot SNR within 1e-3 dB.  dy4tpu's host
decoder and application layer, fed the port's symbols of every block,
give the port's copies' groups and station info.

The NCO twin (``pll.pll`` over 200 blocks of a 19 kHz tone) is held to
dy4tpu's ``pll.pll`` (jitted: its un-jitted scan costs about 1.2 s a
block) at the last block within 1e-4, and to the 0.05 bar.  The port's
plain PLL takes about 1 s a block, so that case is marked slow, as
dy4tpu's is.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu.rds.app import ApplicationLayer as JApp  # noqa: E402
from dy4tpu.rds.decoder import RDSDecoder as JDecoder  # noqa: E402
from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.rds import coding  # noqa: E402
from dy4tpu_torch.rds.app import ApplicationLayer  # noqa: E402
from dy4tpu_torch.rds.decoder import RDSDecoder  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402

import dy4tpu_window as dw  # noqa: E402
from torch_batch import run_batch  # noqa: E402

cfg = get_mode(0)
SEG = 14            # test_recovery.py: signal / 4 blocks without RDS / signal
STATIONS = [        # test_multichannel.py
    dict(pi=0x1111, ps="ALPHA FM", tone=600.0),
    dict(pi=0x2222, ps="BRAVO FM", tone=1000.0),
    dict(pi=0x3333, ps="CHARLIE!", tone=1500.0),
]
NOISE, ECHO, DROPOUT = 0, 1, 2     # channels; the stations are 3, 4, 5
WINDOW_LEN, DROP_WINDOW = 8, SEG   # dy4tpu's windows: [0, 8) and [14, 22)


def _stereo(n_blocks, lf, rf, **kw):
    n_audio = n_blocks * cfg.audio_per_block
    return fm.synthesize(cfg, n_blocks,
                         left=fm.tone(lf, cfg.audio_fs, n_audio, 0.6),
                         right=fm.tone(rf, cfg.audio_fs, n_audio, 0.6), **kw)


def _captures():
    noisy = _stereo(20, 800.0, 2400.0, noise=0.05, seed=3,
                    rds_bits=coding.make_ps_bitstream(0x5A5A, 9, "NOISY OK",
                                                      repeats=60))
    echo = _stereo(14, 800.0, 2400.0,
                   rds_bits=coding.make_ps_bitstream(0x54A7, 9, "ECHO  OK",
                                                     repeats=60),
                   multipath=[(24, 0.5 * np.exp(1j * 2.1)),
                              (60, 0.32 * np.exp(-1j * 0.9))])
    bits = coding.make_ps_bitstream(0xD00D, 7, "RECOVERY", repeats=80)
    drop = np.concatenate([
        _stereo(SEG, 700.0, 1900.0, rds_bits=bits, seed=0),
        _stereo(4, 700.0, 1900.0, rds_bits=None, seed=1),
        _stereo(SEG, 700.0, 1900.0, rds_bits=bits, seed=2)])
    n_audio = 20 * cfg.audio_per_block
    stations = []
    for s in STATIONS:
        audio = fm.tone(s["tone"], cfg.audio_fs, n_audio, amp=0.6)
        stations.append(fm.synthesize(
            cfg, 20, left=audio, right=audio,
            rds_bits=coding.make_ps_bitstream(s["pi"], 10, s["ps"],
                                              repeats=50)))
    return [noisy, echo, drop, *stations]


@pytest.fixture(scope="module")
def batch():
    caps = _captures()
    outs, states = run_batch(cfg, caps, states_at=(DROP_WINDOW,))
    return caps, outs, states[DROP_WINDOW]


@pytest.fixture(scope="module")
def windows(batch):
    """{(channel, first block): (port's outputs, dy4tpu's)} of the eight
    windows, dy4tpu's run as one batch of seven."""
    caps, outs, drop_state = batch
    zero = rx.init_state(cfg, (len(caps),), device="cpu")
    paths = dw.stack(dw.rows(zero, slice(None)),
                     dw.rows(drop_state, [DROPOUT]))
    bs = cfg.block_size
    win = [c.reshape(-1, bs)[:WINDOW_LEN] for c in caps]
    a = DROP_WINDOW
    win.append(caps[DROPOUT].reshape(-1, bs)[a:a + WINDOW_LEN])
    ref = dw.run(cfg, paths, np.stack(win, axis=1))
    keys = [(ch, 0) for ch in range(len(caps))] + [(DROPOUT, a)]
    got = {}
    for j, (ch, start) in enumerate(keys):
        ours = dw.numpy_outputs(outs, slice(start, start + WINDOW_LEN), [ch])
        got[ch, start] = ({f: ours[f][:, 0] for f in ref},
                          {f: v[:, j] for f, v in ref.items()})
    return got


def _twin(windows, ch, start=0):
    ours, ref = windows[ch, start]
    dw.assert_twins(ours, ref, f"channel {ch} from block {start}")


def _decode(outs, ch, n_blocks):
    """The port's decoder and application layer over the channel's first
    ``n_blocks``; dy4tpu's over the same symbols must agree.  Returns
    (station info, the block of each group)."""
    sym = outs.rds_symbols[:n_blocks, ch].numpy()
    rs = outs.rds_resync[:n_blocks, ch].numpy()
    apps, decs, group_blocks = [], [], []
    for app_cls, dec_cls in ((ApplicationLayer, RDSDecoder),
                             (JApp, JDecoder)):
        app = app_cls()
        dec = dec_cls(on_group=app.process)
        blocks = []
        for b in range(n_blocks):
            got = dec.push_block(sym[b], resync=bool(rs[b]))
            blocks.extend([b] * len(got))
        apps.append(app)
        decs.append(dec)
        group_blocks.append(blocks)
    assert ([(g.bit_position, g.blocks) for g in decs[0].groups]
            == [(g.bit_position, g.blocks) for g in decs[1].groups])
    assert group_blocks[0] == group_blocks[1]
    a, b = apps[0].info, apps[1].info
    assert (a.pi, a.ps_name, a.pty, a.groups_seen) == (
        b.pi, b.ps_name, b.pty, b.groups_seen)
    return a, group_blocks[0]


def test_rds_decodes_through_noise(batch, windows):
    _, outs, _ = batch
    info, _ = _decode(outs, NOISE, 20)
    assert info.pi == 0x5A5A
    assert info.groups_seen >= 3
    # stereo separation survives post-lock: test_noise.py's bar, the left
    # tone 10x the right's leak from block 4
    sep_l, _ = fm.stereo_separation_db(cfg, outs.left[:20, NOISE].numpy(),
                                       outs.right[:20, NOISE].numpy(),
                                       skip_blocks=4)
    assert sep_l > 20.0, sep_l
    _twin(windows, NOISE)


def test_decode_through_multipath(batch, windows):
    """-6 dB at 10 us and -10 dB at 25 us: separation stays >= 15 dB and
    the group stream keeps its PI."""
    _, outs, _ = batch
    info, _ = _decode(outs, ECHO, 14)
    assert info.pi == 0x54A7
    assert info.groups_seen >= 2
    sep = min(fm.stereo_separation_db(cfg, outs.left[:14, ECHO].numpy(),
                                      outs.right[:14, ECHO].numpy(),
                                      skip_blocks=4))
    assert sep > 15.0, sep
    _twin(windows, ECHO)


def test_rds_dropout_and_reacquisition(batch, windows):
    _, outs, _ = batch
    n_blocks = 2 * SEG + 4
    info, group_blocks = _decode(outs, DROPOUT, n_blocks)
    assert any(b < SEG for b in group_blocks), group_blocks
    assert any(b >= SEG + 4 + 4 for b in group_blocks), group_blocks
    assert info.pi == 0xD00D
    assert outs.rds_resync[SEG:SEG + 4 + 2, DROPOUT].numpy().any()
    _twin(windows, DROPOUT)
    _twin(windows, DROPOUT, DROP_WINDOW)


@pytest.mark.parametrize("k", range(len(STATIONS)),
                         ids=[s["ps"].strip() for s in STATIONS])
def test_three_stations_decode_independently(batch, windows, k):
    """Each station's channel decodes its own PI/PS, and its mono carries
    its own tone 20 dB over the neighbours'."""
    _, outs, _ = batch
    s, ch = STATIONS[k], 3 + k
    info, _ = _decode(outs, ch, 20)
    assert info.pi == s["pi"], (ch, info.pi_hex)
    assert info.ps_name == s["ps"], (ch, info.ps_name)
    mono = outs.mono[3:20, ch].numpy().ravel()
    t = np.arange(len(mono)) / cfg.audio_fs
    own = np.abs(mono @ np.exp(-2j * np.pi * s["tone"] * t))
    for other in STATIONS:
        if other["tone"] != s["tone"]:
            leak = np.abs(mono @ np.exp(-2j * np.pi * other["tone"] * t))
            assert own > 10 * leak, (ch, own, leak)
    _twin(windows, ch)


@pytest.mark.slow
def test_pll_long_stream_phase_stability():
    """After ~1.5 M samples the NCO still tracks cos(2*(w t + phi)): the
    wrapped accumulators lose no precision; the last block equals
    dy4tpu's within 1e-4."""
    import functools

    import jax
    import jax.numpy as jnp

    from dy4tpu.ops import pll as jpll
    from dy4tpu_torch.ops import pll

    fs, n_block, n_blocks, phi = 240e3, 7680, 200, 0.77
    kw = dict(freq=19e3, fs=fs, nco_scale=2.0)
    jstep = jax.jit(functools.partial(jpll.pll, **kw))
    st, jst = pll.init_state(device="cpu"), jpll.init_state()
    k0 = 0
    for _ in range(n_blocks):
        t = (k0 + np.arange(n_block)) / fs
        x = np.cos(2 * np.pi * 19e3 * t + phi).astype(np.float32)
        nco, _, st = pll.pll(torch.from_numpy(x), st, **kw)
        jnco, _, jst = jstep(jnp.asarray(x), jst)
        k0 += n_block
    want = np.cos(2 * (2 * np.pi * 19e3 * t + phi))
    err_last = float(np.mean(np.abs(nco.numpy()[64:] - want[64:])))
    assert err_last < 0.05, err_last
    np.testing.assert_allclose(nco.numpy(), np.asarray(jnco), atol=1e-4)

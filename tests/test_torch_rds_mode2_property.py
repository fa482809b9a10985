"""Mode-2 RDS through CDR dropouts on the port (plain paths on the CPU):
the twin of tests/test_mode2_rds_property.py, its four cases at its bars,
each also held to dy4tpu.

Mode 2 runs SPS=27 and an odd 95 symbols a block.  The capture is
test_mode2_rds_property.py's: 52 blocks of PI 0x2A95, PTY 7, PS "MODE2
95", dropped to u8 128 (no signal) over blocks [14, 16) (edge-aligned)
and over 1.4 blocks from byte 30*bs + 20011*2 (mid-block, ending
mid-symbol).  The port runs all 52 blocks.

Held to dy4tpu:

- dy4tpu's un-jitted ``receiver_step`` (``dy4tpu_window``) over three
  windows of 4 blocks, each from the port's state at its first block:
  [0, 4) (the lock-in), [14, 18) (dropout A and its re-lock) and
  [30, 34) (dropout B and its re-lock).  RDS hard symbols, resync flags
  and CDR offsets equal; audio and RDS baseband within atol 1e-4, the
  pilot SNR within 1e-3 dB.
- dy4tpu's host decoders (``RDSDecoder``, ``FleetDecoder``) on the port's
  symbols of all 52 blocks give the same groups, bit positions and
  content as the port's copies.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu.rds.decoder import RDSDecoder as JDecoder  # noqa: E402
from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.rds import coding  # noqa: E402
from dy4tpu_torch.rds.decoder import RDSDecoder  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402

import dy4tpu_window as dw  # noqa: E402
from torch_batch import run_batch  # noqa: E402

PI, PTY, PS = 0x2A95, 7, "MODE2 95"
N_BLOCKS = 52
WINDOWS, WINDOW_LEN = (0, 14, 30), 4   # first blocks of dy4tpu's windows

cfg = get_mode(2)


def _capture():
    """test_mode2_rds_property.py's broadcast and its two dropouts."""
    assert cfg.rds_symbols_per_block % 2 == 1, "mode 2 must be odd sym/blk"
    bits = coding.make_ps_bitstream(PI, PTY, PS, repeats=80)
    iq = fm.synthesize(cfg, N_BLOCKS, rds_bits=bits).copy()
    bs = cfg.block_size
    iq[14 * bs:16 * bs] = 128
    start = 30 * bs + 20011 * 2
    iq[start:start + int(1.4 * bs) // 2 * 2] = 128
    return iq


@pytest.fixture(scope="module")
def mode2_run():
    iq = _capture()
    outs, states = run_batch(cfg, [iq], states_at=WINDOWS)
    return iq, outs, states


@pytest.fixture(scope="module")
def decisions(mode2_run):
    _, outs, _ = mode2_run
    return tuple(getattr(outs, f)[:, 0].numpy() for f in dw.DECISIONS)


@pytest.fixture(scope="module")
def windows(mode2_run):
    """dy4tpu's outputs over the three windows (one batch, a window a
    channel) and the port's at the same blocks."""
    iq, outs, states = mode2_run
    blocks = iq.reshape(N_BLOCKS, cfg.block_size)
    paths = dw.stack(*(dw.rows(states[a], [0]) for a in WINDOWS))
    win = np.stack([blocks[a:a + WINDOW_LEN] for a in WINDOWS], axis=1)
    ref = dw.run(cfg, paths, win)
    ours = {f: np.concatenate(
        [dw.numpy_outputs(outs, slice(a, a + WINDOW_LEN), [0])[f]
         for a in WINDOWS], axis=1) for f in ref}
    return ours, ref


def _decode(cls, symbols, resync, offsets, use_offsets):
    dec = cls()
    per_block = []
    for k in range(N_BLOCKS):
        per_block.append(dec.push_block(
            symbols[k], bool(resync[k]),
            offset=int(offsets[k]) if use_offsets else None))
    return dec, per_block


def _groups(dec):
    return [(g.bit_position, g.blocks) for g in dec.groups]


@pytest.mark.parametrize("k", range(len(WINDOWS)),
                         ids=[f"blocks{a}-{a + WINDOW_LEN}" for a in WINDOWS])
def test_window_equals_dy4tpu(windows, k):
    ours, ref = windows
    dw.assert_twins({f: v[:, k] for f, v in ours.items()},
                    {f: v[:, k] for f, v in ref.items()},
                    f"window from block {WINDOWS[k]}")


def test_cdr_reacquires_after_each_dropout(decisions, windows):
    _, resync, _ = decisions
    assert resync[15:18].any(), "no resync after edge-aligned dropout"
    assert resync[31:34].any(), "no resync after mid-block dropout"
    assert not resync[24:30].any()
    assert not resync[40:].any()
    # the re-acquisitions (flags and CDR phases) are dy4tpu's
    ours, ref = windows
    for f in ("rds_resync", "rds_offset"):
        np.testing.assert_array_equal(ours[f], ref[f], err_msg=f)


def test_groups_bit_exact_after_each_relock(decisions, windows):
    """Every decoded group in every lock period carries the exact PI,
    and decoding resumes after both dropouts; dy4tpu's decoder makes the
    same groups of the port's symbols."""
    dec, per_block = _decode(RDSDecoder, *decisions, use_offsets=True)
    assert len(dec.groups) >= 8
    bad = [g for g in dec.groups if g.blocks["A"] != PI]
    assert not bad, f"{len(bad)}/{len(dec.groups)} corrupted groups"
    after_b = sum(len(per_block[k]) for k in range(36, N_BLOCKS))
    assert after_b >= 2, "no groups decoded after second dropout"
    jdec, _ = _decode(JDecoder, *decisions, use_offsets=True)
    assert _groups(dec) == _groups(jdec)
    ours, ref = windows
    np.testing.assert_array_equal(ours["rds_symbols"], ref["rds_symbols"])


def test_same_phase_resync_keeps_continuity(decisions):
    """The offset-gated reset decodes at least as many groups as the
    raw-resync reset, with the same content where they overlap; dy4tpu's
    decoder agrees in both modes."""
    gated, _ = _decode(RDSDecoder, *decisions, use_offsets=True)
    raw, _ = _decode(RDSDecoder, *decisions, use_offsets=False)
    assert len(gated.groups) >= len(raw.groups)
    for g in gated.groups:
        assert g.blocks["A"] == PI
    raw_by_pos = {g.bit_position: g.blocks for g in raw.groups}
    both = [g for g in gated.groups if g.bit_position in raw_by_pos]
    for g in both:
        assert g.blocks == raw_by_pos[g.bit_position]
    jraw, _ = _decode(JDecoder, *decisions, use_offsets=False)
    assert _groups(raw) == _groups(jraw)


def test_fleet_matches_scalar_on_mode2_dropouts(decisions):
    """The port's vectorized fleet layer reproduces its scalar decoder on
    the odd-symbol dropout stream (offset-gated reset), and dy4tpu's
    fleet layer does the same with the port's symbols."""
    from dy4tpu.rds.fleet import FleetDecoder as JFleet
    from dy4tpu.runtime import native as jnative
    from dy4tpu_torch.rds.fleet import FleetDecoder
    from dy4tpu_torch.runtime import native
    if not (native.available() and jnative.available()):
        pytest.skip("native runtime not built")
    symbols, resync, offsets = decisions
    scalar, _ = _decode(RDSDecoder, *decisions, use_offsets=True)
    fleets = [FleetDecoder(2), JFleet(2)]
    for k in range(N_BLOCKS):
        for fleet in fleets:
            fleet.push_block(np.stack([symbols[k], symbols[k]]),
                             resync=np.array([resync[k], resync[k]]),
                             offsets=np.array([offsets[k], offsets[k]]))
    for fleet in fleets:
        for ch in range(2):
            assert len(fleet.groups[ch]) == len(scalar.groups)
            for a, b in zip(fleet.groups[ch], scalar.groups):
                assert (a.blocks == b.blocks
                        and a.bit_position == b.bit_position)

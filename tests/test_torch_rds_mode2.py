"""RDS at mode 2 (SPS=27) through the port (plain paths on the CPU): the
mode-2 cases of tests/test_e2e_rds.py (PI/PTY/PS recovered exactly) and
tests/test_cdr_envelope.py (on a clean capture the reference's two-symbol
peak search mislocks and the whole-block envelope estimate decodes), at
their bars.

The two peak-timed decodes ride one batch (``torch_batch.run_batch``);
``cdr_timing`` is an argument of the step, so the envelope decode is a
run of its own.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.rds import coding  # noqa: E402
from dy4tpu_torch.rds.app import ApplicationLayer  # noqa: E402
from dy4tpu_torch.rds.decoder import RDSDecoder  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402
from torch_batch import run_batch  # noqa: E402

cfg = get_mode(2)
INFO_BLOCKS, CDR_BLOCKS = 28, 16


def _run(captures, timing):
    outs = run_batch(cfg, captures, cdr_timing=timing)
    return outs.rds_symbols.numpy(), outs.rds_resync.numpy()


def _decode(sym, rs, ch, n_blocks):
    app = ApplicationLayer()
    dec = RDSDecoder(on_group=app.process)
    for b in range(n_blocks):
        dec.push_block(sym[b, ch], resync=bool(rs[b, ch]))
    return app.info


def _info_capture():
    """tests/test_e2e_rds.py's capture: PS groups, no audio."""
    bits = coding.make_ps_bitstream(0x54A8, 10, "DY4 TPU ", repeats=40)
    return fm.synthesize(cfg, INFO_BLOCKS, rds_bits=bits)


def _cdr_capture():
    """tests/test_cdr_envelope.py's capture: stereo tones and PS groups."""
    n_audio = CDR_BLOCKS * cfg.audio_per_block
    bits = coding.make_ps_bitstream(0x54A7, 9, "ENVELOPE", repeats=60)
    return fm.synthesize(cfg, CDR_BLOCKS,
                         left=fm.tone(800.0, cfg.audio_fs, n_audio, 0.6),
                         right=fm.tone(2400.0, cfg.audio_fs, n_audio, 0.6),
                         rds_bits=bits)


@pytest.fixture(scope="module")
def peak():
    sym, rs = _run([_info_capture(), _cdr_capture()], "peak")
    return (_decode(sym, rs, 0, INFO_BLOCKS),
            _decode(sym, rs, 1, CDR_BLOCKS))


def test_rds_decodes_station_info_mode2(peak):
    info = peak[0]
    assert info.pi == 0x54A8, f"PI {info.pi_hex}"
    assert info.pty == 10
    assert info.ps_name == "DY4 TPU "
    assert info.pty_name == "Pop Music"
    assert info.groups_seen >= 4


def test_envelope_rescues_mode2(peak):
    """The reference's two-symbol peak search picks a suboptimal phase
    on the clean mode-2 capture; the envelope estimate decodes it."""
    sym, rs = _run([_cdr_capture()], "envelope")
    env = _decode(sym, rs, 0, CDR_BLOCKS)
    assert env.pi == 0x54A7
    assert env.ps_name == "ENVELOPE"
    assert env.groups_seen >= peak[1].groups_seen + 3, (
        env.groups_seen, peak[1].groups_seen)

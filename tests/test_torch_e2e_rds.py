"""Full-chain RDS decode at mode 0 through the port (plain paths on the
CPU): synthesised broadcast -> the port's receiver -> the port's host bit
decoder -> application layer, the twin of tests/test_e2e_rds.py at its
bars: the transmitted PI/PTY/PS recovered exactly, and every group after
lock carrying the exact PI.  Its mode-2 case is in
tests/test_torch_rds_mode2.py.

The three captures ride one batch (``torch_batch.run_batch``).
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

PI, PTY, PS = 0x54A8, 10, "DY4 TPU "
cfg = get_mode(0)
# (blocks, noise, audio) of test_e2e_rds.py's three mode-0 decodes
CASES = {"info": (28, 0.0, False), "ber": (40, 0.0, False),
         "noise": (32, 0.01, True)}


def capture(cfg, n_blocks, noise=0.0, audio=False):
    bits = coding.make_ps_bitstream(PI, PTY, PS, repeats=40)
    n_audio = n_blocks * cfg.audio_per_block
    left = fm.tone(800.0, cfg.audio_fs, n_audio, amp=0.6) if audio else None
    right = fm.tone(2400.0, cfg.audio_fs, n_audio, amp=0.6) if audio else None
    return fm.synthesize(cfg, n_blocks, rds_bits=bits, noise=noise,
                         left=left, right=right)


def decode(symbols, resync, ch, n_blocks):
    dec = RDSDecoder()
    app = ApplicationLayer()
    for k in range(n_blocks):
        for g in dec.push_block(symbols[k, ch], bool(resync[k, ch])):
            app.process(g)
    return app.info, dec


@pytest.fixture(scope="module")
def decoded():
    outs = run_batch(cfg, [capture(cfg, *c) for c in CASES.values()])
    sym, rs = outs.rds_symbols.numpy(), outs.rds_resync.numpy()
    return {name: decode(sym, rs, ch, c[0])
            for ch, (name, c) in enumerate(CASES.items())}


def test_rds_decodes_station_info_mode0(decoded):
    info, _ = decoded["info"]
    assert info.pi == PI, f"PI {info.pi_hex}"
    assert info.pty == PTY
    assert info.ps_name == PS
    assert info.pty_name == "Pop Music"
    assert info.groups_seen >= 4


def test_rds_group_ber_zero_after_lock_mode0(decoded):
    # after first sync every decoded group must carry the exact PI
    groups = decoded["ber"][1].groups
    assert len(groups) >= 10
    bad = [g for g in groups if g.blocks["A"] != PI]
    assert not bad, f"{len(bad)}/{len(groups)} corrupted groups"


def test_rds_with_audio_and_noise_mode0(decoded):
    info, _ = decoded["noise"]
    assert info.pi == PI
    assert info.ps_name == PS

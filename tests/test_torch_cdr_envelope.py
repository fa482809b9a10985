"""The envelope (square-law) RDS timing acquisition under channel noise
through the port (plain paths on the CPU), the twin of
tests/test_cdr_envelope.py's noise case at its bar: with channel noise the
whole-block estimate keeps decoding at least as well as the two-symbol
peak.  Its mode-2 case is in tests/test_torch_rds_mode2.py; the estimator
itself is held to dy4tpu's in tests/test_torch_modes.py.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.rds import coding  # noqa: E402
from dy4tpu_torch.rds.app import ApplicationLayer  # noqa: E402
from dy4tpu_torch.rds.decoder import RDSDecoder  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402


def _decode(mode, timing, n_blocks=16, noise=0.0, seed=0):
    cfg = get_mode(mode)
    n_audio = n_blocks * cfg.audio_per_block
    bits = coding.make_ps_bitstream(0x54A7, 9, "ENVELOPE", repeats=60)
    iq = fm.synthesize(cfg, n_blocks,
                       left=fm.tone(800.0, cfg.audio_fs, n_audio, 0.6),
                       right=fm.tone(2400.0, cfg.audio_fs, n_audio, 0.6),
                       rds_bits=bits, noise=noise, seed=seed)
    params = rx.make_params(cfg, device=DEV)
    st = rx.init_state(cfg, device=DEV)
    blocks = torch.from_numpy(iq.reshape(n_blocks, cfg.block_size))
    _, outs = rx.run_blocks(params, st, blocks, cfg, cdr_timing=timing)
    app = ApplicationLayer()
    dec = RDSDecoder(on_group=app.process)
    sym = outs.rds_symbols.numpy()
    rs = outs.rds_resync.numpy()
    for b in range(n_blocks):
        dec.push_block(sym[b], resync=bool(rs[b]))
    return app.info


def test_envelope_under_noise_mode0():
    peak = _decode(0, "peak", n_blocks=20, noise=0.4, seed=7)
    env = _decode(0, "envelope", n_blocks=20, noise=0.4, seed=7)
    assert env.pi == 0x54A7
    assert env.groups_seen >= max(1, peak.groups_seen)

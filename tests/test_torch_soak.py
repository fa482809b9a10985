"""The long-stream soak's three checks on the port (plain paths on the
CPU): the twin of tests/test_soak.py, cut to 4 cycles of its 25-block
mode-0 cycle (PI 0x54A7, PS "SOAKSOAK", 800 / 2400 Hz tones).  Its 10^4
blocks would take about 3.3 h on the port's plain path here; the
full-length soak (10^4 blocks at mode 0, 5000 at mode 2 with the
envelope CDR) runs through the kernels on the card (chip_smoke.py
phase 9).

  (a) after every cycle, every float state leaf is finite and the
      port's PLL accumulators (``PLLState.phase_est`` / ``angle`` of
      the pilot and RDS loops) stay inside ``2*WRAP + 1``;
  (b) a checkpoint after block 50 through ``utils.checkpoint.save`` /
      ``load`` and disk: the loaded state equals the live one bit for
      bit, and the resumed run's outputs and state equal the live run's
      bit for bit over the two cycles after it;
  (c) the application layer decodes PI and PS from the last cycle, with
      no CDR resync in it.

Held to dy4tpu: its un-jitted ``receiver_step`` (``dy4tpu_window``) from
the loaded checkpoint over blocks [50, 53): RDS hard symbols, resync
flags and CDR offsets equal, audio and RDS baseband within atol 1e-4,
the pilot SNR within 1e-3 dB.  About 200 s here, so marked slow, as
dy4tpu's soak is.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.ops import pll  # noqa: E402
from dy4tpu_torch.pipeline import convert  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.rds import coding  # noqa: E402
from dy4tpu_torch.rds.app import ApplicationLayer  # noqa: E402
from dy4tpu_torch.rds.decoder import RDSDecoder  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402
from dy4tpu_torch.utils import checkpoint as ckpt  # noqa: E402

import dy4tpu_window as dw  # noqa: E402
from torch_batch import run_batch  # noqa: E402

PI_CODE, PS = 0x54A7, "SOAKSOAK"
CYCLE, CYCLES, CKPT_CYCLES = 25, 4, 2   # checkpoint after block 50
TWIN_LEN = 3                            # dy4tpu's window after it
WRAP = 4.0 * np.pi
cfg = get_mode(0)


def _cycle():
    n_audio = CYCLE * cfg.audio_per_block
    bits = coding.make_ps_bitstream(PI_CODE, 10, PS, repeats=3 * CYCLE)
    return fm.synthesize(
        cfg, CYCLE, left=fm.tone(800.0, cfg.audio_fs, n_audio, amp=0.7),
        right=fm.tone(2400.0, cfg.audio_fs, n_audio, amp=0.7),
        rds_bits=bits)


def _assert_bounded(st, where):
    for k, a in convert.state_to_numpy(st).items():
        if np.issubdtype(a.dtype, np.floating):
            assert np.all(np.isfinite(a)), (where, k)
    for loop in (st.audio.pll, st.rds.pll):
        assert isinstance(loop, pll.PLLState)
        for leaf in (loop.phase_est, loop.angle):
            a = leaf.numpy()
            assert np.all(np.abs(a) <= 2 * WRAP + 1.0), (where, a)


def _same_outputs(a, b, where):
    for f, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), (where, f)
        if x is not None:
            assert torch.equal(x, y), (where, f)


def _same_state(a, b, where):
    x, y = convert.state_to_numpy(a), convert.state_to_numpy(b)
    assert x.keys() == y.keys(), where
    for k in x:
        assert x[k].dtype == y[k].dtype, (where, k)
        np.testing.assert_array_equal(x[k], y[k], err_msg=f"{where} {k}")


@pytest.mark.slow
def test_soak_cycles(tmp_path):
    iq = _cycle()
    state = None
    outs = []
    for cycle in range(CYCLES):
        out, st = run_batch(cfg, [iq], state=state, states_at=(CYCLE,))
        state = st[CYCLE]
        outs.append(out)
        _assert_bounded(state, f"cycle {cycle}")
        if cycle == CKPT_CYCLES - 1:
            path = str(tmp_path / "soak.ckpt")
            ckpt.save(path, state, meta={"block": CKPT_CYCLES * CYCLE})
            template = rx.init_state(cfg, (1,), device="cpu")
            resumed, _, meta = ckpt.load(path, template)
            assert meta["block"] == CKPT_CYCLES * CYCLE
            _same_state(state, resumed, "loaded")
            loaded = resumed

    # (b) the resumed twin: bit for bit over the two cycles after
    for cycle in range(CKPT_CYCLES, CYCLES):
        out, st = run_batch(cfg, [iq], state=resumed, states_at=(CYCLE,))
        resumed = st[CYCLE]
        _same_outputs(out, outs[cycle], f"resumed cycle {cycle}")
    _same_state(resumed, state, "resumed")

    # dy4tpu from the loaded checkpoint
    bs = cfg.block_size
    ref = dw.run(cfg, dw.rows(loaded, slice(None)),
                 iq.reshape(CYCLE, 1, bs)[:TWIN_LEN])
    ours = dw.numpy_outputs(outs[CKPT_CYCLES], slice(0, TWIN_LEN))
    dw.assert_twins(ours, ref, "from the checkpoint")

    # (c) RDS still locked in the last cycle
    last = outs[-1]
    assert not last.rds_resync.numpy().any(), "CDR resync in the last cycle"
    app = ApplicationLayer()
    dec = RDSDecoder(on_group=app.process)
    for b in range(CYCLE):
        dec.push_block(last.rds_symbols[b, 0].numpy(), resync=False)
    assert app.info.pi_hex == f"{PI_CODE:04X}", app.info
    assert (app.info.ps_name or "").strip() == PS

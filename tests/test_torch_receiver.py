"""The port's mode-0 receiver (dy4tpu_torch.pipeline.receiver, plain paths
on CPU) against dy4tpu's ``receiver_step`` on the same broadcast, C=2
channels over 3 blocks.

Bars: every float output and state leaf to atol 1e-4 (the two packages
sum in other orders and XLA may fuse multiply-adds; measured about 1e-6),
the pilot SNR to 1e-3 dB, and every decision exact: RDS hard symbols,
resync flags, CDR offsets and lock flags.  dy4tpu runs un-jitted: under
``jax.jit`` XLA's fusion moves the PLL's lock transient in block 0 by up
to ~1e-2 in the stereo channels, a difference inside dy4tpu itself.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import mix as jmix  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.rds import coding  # noqa: E402
from dy4tpu.tx import fm as jfm  # noqa: E402
from dy4tpu_torch.pipeline import convert  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402

cfg = get_mode(0)
C = 2
N_BLOCKS = 3


def _broadcast(n_blocks, c=cfg):
    n_audio = n_blocks * c.audio_per_block
    bits = coding.make_ps_bitstream(fm.PI_CODE, 10, fm.PS_NAME, repeats=4)
    return dict(left=jfm.tone(800.0, c.audio_fs, n_audio, amp=0.7),
                right=jfm.tone(2400.0, c.audio_fs, n_audio, amp=0.7),
                rds_bits=bits, noise=0.02, seed=5)


@pytest.fixture(scope="module")
def runs():
    iq = jfm.synthesize(cfg, N_BLOCKS, **_broadcast(N_BLOCKS)).reshape(
        N_BLOCKS, 1, cfg.block_size)
    # channel 1: the same broadcast with the I/Q legs swapped (a mirrored
    # spectrum) so the two channels carry different signals
    swapped = iq.reshape(N_BLOCKS, 1, -1, 2)[..., ::-1].reshape(iq.shape)
    iq = np.concatenate([iq, swapped], axis=1)
    jp = jrx.make_params(cfg)
    js = jrx.init_state(cfg, batch=(C,))
    tp = convert.params_from_numpy(jp)
    ts = rx.init_state(cfg, batch=(C,))
    out = dict(iq=iq, jp=jp, tp=tp, j_out=[], j_state=[], t_out=[],
               t_state=[])
    for b in range(N_BLOCKS):
        js, jo = jrx.receiver_step(jp, js, jnp.asarray(iq[b]), cfg)
        ts, to = rx.receiver_step(tp, ts, torch.from_numpy(iq[b]), cfg)
        out["j_out"].append(jo)
        out["j_state"].append(js)
        out["t_out"].append(to)
        out["t_state"].append(ts)
    return out


def _assert_leaf(ours, ref, name, atol=1e-4):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, name
    assert ours.dtype == ref.dtype, (name, ours.dtype, ref.dtype)
    if ref.dtype.kind == "f":
        np.testing.assert_allclose(ours, ref, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(ours, ref, err_msg=name)


@pytest.mark.parametrize("field", rx.StepOutputs._fields)
def test_step_outputs_match_dy4tpu(runs, field):
    atol = 1e-3 if field == "pilot_snr_db" else 1e-4
    for b in range(N_BLOCKS):
        _assert_leaf(getattr(runs["t_out"][b], field),
                     getattr(runs["j_out"][b], field), f"{field}[{b}]",
                     atol)


def test_state_matches_dy4tpu_after_every_block(runs):
    for b in range(N_BLOCKS):
        ours = convert.state_to_numpy(runs["t_state"][b])
        ref = convert.leaves_by_path(runs["j_state"][b])
        assert ours.keys() == ref.keys()
        for k in ref:
            _assert_leaf(ours[k], ref[k], f"{k}[{b}]")
        np.testing.assert_array_equal(ours["rf.iq_tail"], ref["rf.iq_tail"])


def test_midstream_handoff_from_dy4tpu(runs):
    """dy4tpu runs blocks 0-1; its state crosses over; the port runs
    block 2 and matches dy4tpu's block 2."""
    st = convert.state_from_numpy(runs["j_state"][1])
    assert st.rds.cdr.offset.dtype == torch.int32
    assert st.rds.cdr.found.dtype == torch.bool
    blk = torch.from_numpy(runs["iq"][2])
    _, to = rx.receiver_step(runs["tp"], st, blk, cfg)
    jo = runs["j_out"][2]
    for f in rx.StepOutputs._fields:
        _assert_leaf(getattr(to, f), getattr(jo, f), f,
                     1e-3 if f == "pilot_snr_db" else 1e-4)


def test_params_and_state_round_trip(runs):
    tp = convert.params_from_numpy(runs["jp"])
    ref = convert.leaves_by_path(rx.make_params(cfg))
    got = convert.leaves_by_path(tp)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    st = runs["t_state"][-1]
    back = convert.state_from_numpy(convert.state_to_numpy(st))
    for a, b in zip(convert.leaves_by_path(back).values(),
                    convert.leaves_by_path(st).values()):
        np.testing.assert_array_equal(a, b)


def test_run_blocks_equals_the_step_loop(runs):
    state, outs = rx.run_blocks(runs["tp"], rx.init_state(cfg, (C,)),
                                torch.from_numpy(runs["iq"]), cfg)
    for f in rx.StepOutputs._fields:
        stacked = torch.stack([getattr(o, f) for o in runs["t_out"]])
        assert torch.equal(getattr(outs, f), stacked), f
    for a, b in zip(convert.leaves_by_path(state).values(),
                    convert.leaves_by_path(runs["t_state"][-1]).values()):
        np.testing.assert_array_equal(a, b)


def test_receiver_step_pcm_matches_dy4tpu_quantizer(runs):
    _, pcm, out = rx.receiver_step_pcm(runs["tp"], rx.init_state(cfg, (C,)),
                                       torch.from_numpy(runs["iq"][0]), cfg)
    assert pcm.dtype == torch.int16 and pcm.shape == (C, 2 * 1536)
    jo = runs["j_out"][0]
    ref = np.asarray(jmix.quantize_s16(jmix.interleave(jo.left, jo.right)))
    # outputs within 1e-4 of each other quantize at most 2 LSB apart
    assert np.abs(pcm.numpy().astype(np.int32) - ref).max() <= 2
    _, mono, _ = rx.receiver_step_pcm(runs["tp"], rx.init_state(cfg, (C,)),
                                      torch.from_numpy(runs["iq"][0]), cfg,
                                      stereo=False)
    assert mono.shape == (C, 1536)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_tx_synthesis_equals_dy4tpu(mode):
    c = get_mode(mode)
    kw = _broadcast(2, c)
    np.testing.assert_array_equal(fm.synthesize(c, 2, **kw),
                                  jfm.synthesize(c, 2, **kw))


def test_16_block_decode_recovers_pi():
    """One channel of the bench broadcast through 16 blocks: stereo
    separation above 15 dB and PI recovered through dy4tpu.rds."""
    iq = fm.stereo_rds_broadcast(cfg, 16)
    _, outs = rx.run_blocks(rx.make_params(cfg), rx.init_state(cfg),
                            torch.from_numpy(iq), cfg)
    got = fm.check_reception(cfg, outs.left.numpy(), outs.right.numpy(),
                             outs.rds_symbols.numpy(),
                             outs.rds_resync.numpy())
    assert got["pi"] == f"{fm.PI_CODE:04X}"


def test_unported_paths_raise():
    """The IQ tracker is not ported (in ``init_state`` and in a state
    handed to the IF entry); unknown options are refused."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rx.init_state(cfg, with_iqcorr=True)
    st = rx.init_state(cfg, (1,))._replace(iqcorr=object())
    i_if = torch.zeros(1, cfg.if_per_block)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 9"):
        rx.receiver_step_if(rx.make_params(cfg), st, i_if, i_if, cfg)
    with pytest.raises(ValueError, match="cdr_timing"):
        rx.receiver_step(rx.make_params(cfg), rx.init_state(cfg),
                         torch.zeros(cfg.block_size, dtype=torch.uint8),
                         cfg, cdr_timing="bogus")
    with pytest.raises(ValueError, match="frontend"):
        rx.receiver_step(rx.make_params(cfg), rx.init_state(cfg),
                         torch.zeros(cfg.block_size, dtype=torch.uint8),
                         cfg, frontend="fused")

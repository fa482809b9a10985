"""The port's receiver in modes 1-3, through the IF entry, and with the
envelope CDR (dy4tpu_torch.pipeline.receiver, plain paths on CPU) against
dy4tpu's un-jitted ``receiver_step`` / ``receiver_step_if`` / ``_cdr`` on
the same inputs.

Modes 1-3: C=2 channels (the bench broadcast, and the same broadcast with
I/Q swapped) over 3 blocks with noise 0.02.  Bars, as for mode 0 in
tests/test_torch_receiver.py: every float output and state leaf to atol
1e-4 (measured about 1e-6), the pilot SNR to 1e-3 dB, and every RDS
decision exact (hard symbols, resync flags, CDR offsets and lock flags).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.rds import coding  # noqa: E402
from dy4tpu.tx import fm as jfm  # noqa: E402
from dy4tpu_torch.pipeline import convert  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402

C = 2
N_BLOCKS = 3


def _swap_iq(iq):
    """[..., 2n] interleaved u8 with I and Q exchanged."""
    return iq.reshape(*iq.shape[:-1], -1, 2)[..., ::-1].reshape(iq.shape)


def _broadcast(cfg, n_blocks):
    """[n_blocks, C, block_size] u8: the bench broadcast on channel 0, the
    same with I/Q swapped (a mirrored spectrum) on channel 1."""
    n_audio = n_blocks * cfg.audio_per_block
    bits = coding.make_ps_bitstream(fm.PI_CODE, 10, fm.PS_NAME, repeats=4)
    iq = jfm.synthesize(cfg, n_blocks,
                        left=jfm.tone(800.0, cfg.audio_fs, n_audio, amp=0.7),
                        right=jfm.tone(2400.0, cfg.audio_fs, n_audio,
                                       amp=0.7),
                        rds_bits=bits, noise=0.02, seed=5).reshape(
                            n_blocks, 1, cfg.block_size)
    return np.concatenate([iq, _swap_iq(iq)], axis=1)


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda m: f"mode{m}")
def runs(request):
    cfg = get_mode(request.param)
    iq = _broadcast(cfg, N_BLOCKS)
    jp = jrx.make_params(cfg)
    js = jrx.init_state(cfg, batch=(C,))
    tp = convert.params_from_numpy(jp)
    ts = rx.init_state(cfg, batch=(C,))
    out = dict(cfg=cfg, iq=iq, tp=tp, j_out=[], j_state=[], t_out=[],
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
    if ref is None:
        assert ours is None, name
        return
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, name
    assert ours.dtype == ref.dtype, (name, ours.dtype, ref.dtype)
    if ref.dtype.kind == "f":
        np.testing.assert_allclose(ours, ref, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(ours, ref, err_msg=name)


def _assert_outputs(ours, ref, label):
    for f in rx.StepOutputs._fields:
        _assert_leaf(getattr(ours, f), getattr(ref, f), f"{label} {f}",
                     1e-3 if f == "pilot_snr_db" else 1e-4)


def test_step_outputs_match_dy4tpu(runs):
    cfg = runs["cfg"]
    for b in range(N_BLOCKS):
        out = runs["t_out"][b]
        assert out.mono.shape == (C, cfg.audio_per_block)
        assert (out.rds_symbols is None) == (not cfg.supports_rds)
        _assert_outputs(out, runs["j_out"][b], f"block {b}")


def test_state_matches_dy4tpu_after_every_block(runs):
    for b in range(N_BLOCKS):
        ours = convert.state_to_numpy(runs["t_state"][b])
        ref = convert.leaves_by_path(runs["j_state"][b])
        assert ours.keys() == ref.keys()
        for k in ref:
            _assert_leaf(ours[k], ref[k], f"{k}[{b}]")
        np.testing.assert_array_equal(ours["rf.iq_tail"], ref["rf.iq_tail"])


def test_run_blocks_equals_the_step_loop(runs):
    cfg = runs["cfg"]
    state, outs = rx.run_blocks(runs["tp"], rx.init_state(cfg, (C,)),
                                torch.from_numpy(runs["iq"]), cfg)
    for f in rx.StepOutputs._fields:
        got = getattr(outs, f)
        if got is None:
            assert getattr(runs["t_out"][0], f) is None, f
            continue
        assert torch.equal(got, torch.stack([getattr(o, f)
                                             for o in runs["t_out"]])), f


def test_midstream_handoff_from_dy4tpu_mode2():
    """dy4tpu runs mode-2 blocks 0-1; its state crosses over; the port
    runs block 2 and matches dy4tpu's block 2, RDS decisions included."""
    cfg = get_mode(2)
    iq = _broadcast(cfg, N_BLOCKS)
    jp = jrx.make_params(cfg)
    js = jrx.init_state(cfg, batch=(C,))
    for b in range(2):
        js, _ = jrx.receiver_step(jp, js, jnp.asarray(iq[b]), cfg)
    st = convert.state_from_numpy(js)
    assert st.rds.cdr.offset.dtype == torch.int32
    _, jo = jrx.receiver_step(jp, js, jnp.asarray(iq[2]), cfg)
    _, to = rx.receiver_step(convert.params_from_numpy(jp), st,
                             torch.from_numpy(iq[2]), cfg)
    _assert_outputs(to, jo, "block 2")


def _if_blocks(cfg, n_blocks):
    """[n_blocks, C, if_per_block] float32 I and Q: the IF-rate FM stream
    of the bench broadcast (what a channelizer channel carries), I/Q
    swapped on channel 1."""
    n_audio = n_blocks * cfg.audio_per_block
    bits = coding.make_ps_bitstream(fm.PI_CODE, 10, fm.PS_NAME, repeats=4)
    m = jfm.multiplex(cfg, n_blocks,
                      left=jfm.tone(800.0, cfg.audio_fs, n_audio, amp=0.7),
                      right=jfm.tone(2400.0, cfg.audio_fs, n_audio, amp=0.7),
                      rds_bits=bits)
    x = np.exp(1j * 2 * np.pi * 75e3 / cfg.if_fs * np.cumsum(m))
    i = x.real.reshape(n_blocks, 1, -1).astype(np.float32)
    q = x.imag.reshape(n_blocks, 1, -1).astype(np.float32)
    return (np.concatenate([i, q], axis=1), np.concatenate([q, i], axis=1))


def test_receiver_step_if_matches_dy4tpu():
    """The IF entry at mode 0 over 2 blocks: every output and state leaf,
    the RF tail carried through untouched."""
    cfg = get_mode(0)
    bi, bq = _if_blocks(cfg, 2)
    jp = jrx.make_params(cfg)
    js = jrx.init_state(cfg, batch=(C,))
    tp = convert.params_from_numpy(jp)
    ts = rx.init_state(cfg, (C,))
    for b in range(2):
        js, jo = jrx.receiver_step_if(jp, js, jnp.asarray(bi[b]),
                                      jnp.asarray(bq[b]), cfg)
        ts, to = rx.receiver_step_if(tp, ts, torch.from_numpy(bi[b]),
                                     torch.from_numpy(bq[b]), cfg)
        _assert_outputs(to, jo, f"block {b}")
        ours = convert.state_to_numpy(ts)
        ref = convert.leaves_by_path(js)
        assert ours.keys() == ref.keys()
        for k in ref:
            _assert_leaf(ours[k], ref[k], f"{k}[{b}]")
        assert not ours["rf.iq_tail"].any()
        np.testing.assert_array_equal(ours["rf.prev_i"], bi[b][:, -1])


def test_cdr_envelope_matches_dy4tpu():
    """``_cdr(timing="envelope")`` on the same baseband: a pulse train
    peaked at a different sampling phase on each row, unlocked rows
    acquiring and locked rows keeping their offset."""
    sps, m = 27, 95
    n = np.arange(m * sps)
    rng = np.random.default_rng(0)
    rows = []
    for k in (0, 5, 13, 26):
        signs = np.repeat(rng.choice([-1.0, 1.0], m + 1), sps)[: len(n)]
        bump = np.maximum(np.cos(2 * np.pi * (n - k) / sps), 0.0) ** 2
        rows.append(signs * bump + 0.01 * rng.standard_normal(len(n)))
    bb_i = np.asarray(rows, np.float32)
    bb_q = (0.1 * rng.standard_normal(bb_i.shape)).astype(np.float32)
    offset = np.array([3, 0, 7, 1], np.int32)
    found = np.array([False, True, False, True])
    ours = rx._cdr(torch.from_numpy(bb_i), torch.from_numpy(bb_q),
                   rx.CDRState(torch.from_numpy(offset),
                               torch.from_numpy(found)), sps,
                   timing="envelope")
    ref = jrx._cdr(jnp.asarray(bb_i), jnp.asarray(bb_q),
                   jrx.CDRState(jnp.asarray(offset), jnp.asarray(found)),
                   sps, timing="envelope")
    names = ("sym_i", "sym_q", "symbols", "resync")
    for name, o, r in zip(names, ours[:4], ref[:4]):
        _assert_leaf(o, r, name, atol=1e-6)
    _assert_leaf(ours[4].offset, ref[4].offset, "offset")
    _assert_leaf(ours[4].found, ref[4].found, "found")
    # the unlocked rows acquired their pulse phase; locked ones kept theirs
    np.testing.assert_array_equal(ours[4].offset.numpy(), [0, 0, 13, 1])


@pytest.mark.parametrize("k", [0, 3, 11, 15])
def test_cdr_envelope_estimator_unit(k):
    """A pulse train peaked at n = k (mod sps) acquires offset k, as in
    tests/test_cdr_envelope.py."""
    sps, m = 16, 64
    n = np.arange(m * sps)
    rng = np.random.default_rng(k)
    signs = np.repeat(rng.choice([-1.0, 1.0], m + 1), sps)[: len(n)]
    bump = np.maximum(np.cos(2 * np.pi * (n - k) / sps), 0.0) ** 2
    bb_i = torch.as_tensor(signs * bump, dtype=torch.float32)
    state = rx.CDRState(offset=torch.zeros((), dtype=torch.int32),
                        found=torch.zeros((), dtype=torch.bool))
    *_, new = rx._cdr(bb_i, torch.zeros_like(bb_i), state, sps,
                      timing="envelope")
    assert int(new.offset) == k


def test_envelope_timing_through_receiver_step_matches_dy4tpu():
    """``cdr_timing="envelope"`` on ``receiver_step``, mode 2, 2 blocks."""
    cfg = get_mode(2)
    iq = _broadcast(cfg, 2)
    jp = jrx.make_params(cfg)
    js = jrx.init_state(cfg, batch=(C,))
    tp = convert.params_from_numpy(jp)
    ts = rx.init_state(cfg, (C,))
    for b in range(2):
        js, jo = jrx.receiver_step(jp, js, jnp.asarray(iq[b]), cfg,
                                   cdr_timing="envelope")
        ts, to = rx.receiver_step(tp, ts, torch.from_numpy(iq[b]), cfg,
                                  cdr_timing="envelope")
        _assert_outputs(to, jo, f"block {b}")

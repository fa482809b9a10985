"""The port's ``precision=`` (``dy4tpu_torch/ops/precision.py``) against
dy4tpu's: below HIGHEST dy4tpu calls every fused kernel with
``mm_dtype=bf16``, and the port's plain versions round the same operands
at the same points (the taps, the band stage's fm and squared RDS band,
the back ends' mixed legs, B4's resampled stream), the products summed in
float32.

(a) Each rounded plain version against dy4tpu's Pallas kernel at
``mm_dtype=bf16`` in interpret mode (``interpret=True``, as
tests/test_frontend_pallas.py runs it; dy4tpu's stock path is no
reference here: on the CPU XLA computes DEFAULT in float32): B1 with and
without RDS, B1-corr, B6, B3 at modes 0 and 1, B5 at modes 2 and 3, B4 at
19/120 and 171/640, B7 at C=16, T=12.  The tails that copy an input are
exact; every other output is within 1e-5 on all but at most 0.5% of its
samples, and each of those within the flip bound 1e-5 + 2^-8 max|x| sum|h|
of the kernel's rounded stages (float32 noise in x can flip a bf16
rounding, which moves an output by up to a bf16 step of x times the
taps).  (b) The same outputs at "highest" miss dy4tpu's bf16 kernel by at
least ten times 1e-5 somewhere, so a port that ignores ``precision``
fails (a).  (c) Mode 0, C=2, 3 blocks: ``receiver_step(precision=
"default")`` against dy4tpu's ``receiver_step(precision=DEFAULT,
frontend="fused", backend="fused")`` with its kernels in interpret mode.
(d) "highest", explicit and by default, is bitwise the float32 path;
"high" rounds the kernels as "default" does.
(e) The DFT's precisions.  (f) The chunk runners at "default" bitwise
their eager loops, keyed apart from "highest".  (g) The sharded receiver
at "default" bitwise ``run_blocks``.  (h) Unknown names raise.

Inputs: the broadcast of ``tx.fm.synthesize`` (B1, B1-corr, B6, the
chain) and seeded numpy draws (the back ends, B7).  The front ends run
mid-stream: block 0 from a zero state through the port's plain version,
block 1 compared (a warm RF tail keeps the demod away from the origin,
where its 1/power amplifies float32 noise).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import backend_pallas  # noqa: E402
from dy4tpu.ops import channelizer as jch  # noqa: E402
from dy4tpu.ops import frontend_pallas, resample_pallas  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.rds import coding  # noqa: E402
from dy4tpu.tx import fm as jfm  # noqa: E402
from dy4tpu_torch.ops import (backend_cuda, channelizer, channelizer_cuda,  # noqa: E402
                              demod, fir, firdes, frontend_cuda, mix,
                              resample_cuda)
from dy4tpu_torch.ops.precision import PRECISIONS, bf16, rounds  # noqa: E402
from dy4tpu_torch.parallel import ShardedReceiver, make_mesh  # noqa: E402
from dy4tpu_torch.pipeline import convert, graph, wideband  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402

C = 3
BAR = 1e-5            # float32 noise: the stages sum in other orders
SHARE = 0.005         # of an output's samples allowed past BAR (flips)
STEP = 2.0 ** -8      # a bf16 rounding step, relative


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _flip_bound(*stages) -> float:
    """1e-5 + 2^-8 max|x| sum|h|, the largest over ``stages`` (x, h): the
    most one flipped bf16 rounding of a stage's input moves its output."""
    return BAR + max(STEP * float(np.abs(np.asarray(x)).max())
                     * float(np.abs(np.asarray(h)).sum()) for x, h in stages)


class Ref:
    """One case of (a)/(b): the port's plain version at "default" and at
    "highest" and dy4tpu's kernel at bf16 on the same inputs; ``exact``:
    the output indices that copy an input; ``bound``: the flip bound."""

    def __init__(self, ours, highest, theirs, exact, bound):
        self.ours, self.highest, self.theirs = ours, highest, theirs
        self.exact, self.bound = exact, bound


def _broadcast(c, n_blocks, seed=3):
    n_audio = n_blocks * c.audio_per_block
    bits = (coding.make_ps_bitstream(fm.PI_CODE, 10, fm.PS_NAME, repeats=4)
            if c.supports_rds else None)
    return jfm.synthesize(c, n_blocks,
                          left=jfm.tone(800.0, c.audio_fs, n_audio, amp=0.7),
                          right=jfm.tone(2400.0, c.audio_fs, n_audio,
                                         amp=0.7),
                          rds_bits=bits, noise=0.05, seed=seed)


def _rows(iq, c, n_blocks, rows=C):
    """[n_blocks, rows, block_size] u8: row r the capture from byte 74*r
    on (wrapping), so no two rows are equal."""
    flat = iq.reshape(-1)
    return np.stack([np.roll(flat, -74 * r).reshape(n_blocks, -1)
                     for r in range(rows)], axis=1)


def _front_case(mode: int, rds: bool, corr: bool = False) -> Ref:
    """B1 (``corr``: its corr variant) on block 1 of the broadcast."""
    c = get_mode(mode)
    blocks = _rows(_broadcast(c, 2), c, 2)
    jp = jrx.make_params(c, with_rds=rds)
    h = [_t(np.array(a)) if a is not None else None
         for a in (jp.rf_coeff, jp.bank_coeff, jp.rds_carrier_coeff)]
    state = rx.front_state_of(rx.init_state(c, (C,), with_rds=rds,
                                            device=DEV))
    tails = [state.rf.iq_tail, state.rf.prev_i, state.rf.prev_q,
             state.bank_tail, state.mono_delay, state.carrier_tail,
             state.rds_delay]
    warm = frontend_cuda.fused_frontend_full_plain(
        _t(blocks[0]), *h, *tails, c.rf_decim, rds=rds, precision="default")
    tails = list(warm[5:12])
    crow = None
    if corr:
        g = np.random.default_rng(mode)
        crow = np.stack([g.uniform(-0.05, 0.05, C), g.uniform(-0.05, 0.05, C),
                         g.uniform(-0.2, 0.2, C), g.uniform(0.8, 1.2, C)],
                        axis=-1).astype(np.float32)
    blk = _t(blocks[1])

    def ours(precision):
        return frontend_cuda.fused_frontend_full_plain(
            blk, *h, *tails, c.rf_decim, rds=rds, corr=_t(crow),
            precision=precision)

    theirs = frontend_pallas.fused_frontend_full(
        _j(blocks[1]), *(_j(a.numpy()) if a is not None else None
                         for a in h),
        *(_j(a.numpy()) if a is not None else None for a in tails),
        c.rf_decim, rds=rds, mm_dtype=jnp.bfloat16, interpret=True,
        corr=_j(crow))
    out = ours("default")
    stages = [(out[0], h[1][:3 if rds else 2])]
    if rds:
        stages.append((out[4] * out[4], h[2]))
    return Ref(out, ours("highest"), theirs[:13 if corr else 12], {5},
               _flip_bound(*stages))


def _if_case() -> Ref:
    """B6 at mode 0 on block 1 of an IF-rate FM stream."""
    c = get_mode(0)
    n_audio = 2 * c.audio_per_block
    bits = coding.make_ps_bitstream(0x1234, 5, "IF TEST!", repeats=4)
    m = jfm.multiplex(c, 2, left=jfm.tone(800.0, c.audio_fs, n_audio, 0.7),
                      right=jfm.tone(2400.0, c.audio_fs, n_audio, 0.7),
                      rds_bits=bits)
    x = np.exp(1j * 2 * np.pi * 75e3 / c.if_fs * np.cumsum(m))
    x = np.stack([np.roll(x, -37 * r) for r in range(C)])   # [C, 2N]
    i = x.real.astype(np.float32).reshape(C, 2, -1).transpose(1, 0, 2)
    q = x.imag.astype(np.float32).reshape(C, 2, -1).transpose(1, 0, 2)
    jp = jrx.make_params(c)
    bank, hc = _t(np.array(jp.bank_coeff)), _t(np.array(jp.rds_carrier_coeff))
    st = rx.front_state_of(rx.init_state(c, (C,), device=DEV))
    warm = frontend_cuda.fused_frontend_if_plain(
        _t(i[0]), _t(q[0]), st.rf.prev_i, st.rf.prev_q, bank, hc,
        st.bank_tail, st.mono_delay, st.carrier_tail, st.rds_delay,
        precision="default")
    tails = warm[5:]

    def ours(precision):
        return frontend_cuda.fused_frontend_if_plain(
            _t(i[1]), _t(q[1]), *tails[:2], bank, hc, *tails[2:],
            precision=precision)

    theirs = frontend_pallas.fused_frontend_if(
        _j(i[1]), _j(q[1]), *(_j(a.numpy()) for a in tails[:2]),
        _j(bank.numpy()), _j(hc.numpy()),
        *(_j(a.numpy()) for a in tails[2:]), rds=True,
        mm_dtype=jnp.bfloat16, interpret=True)
    out = ours("default")
    return Ref(out, ours("highest"), theirs, {5, 6},
               _flip_bound((out[0], bank), (out[4] * out[4], hc)))


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _audio_case(mode: int) -> Ref:
    """B3 (U = 1) or B5 on seeded draws."""
    c = get_mode(mode)
    rng = np.random.default_rng(10 + mode)
    h = firdes.lpf(c.if_fs * c.audio_up, c.audio_fc, c.audio_taps,
                   up_factor=c.audio_up)
    s = (c.audio_taps - 1) // c.audio_up
    n = c.if_per_block
    args = [_f32(rng, C, n), _f32(rng, C, n), _f32(rng, C, n), h,
            _f32(rng, C, s), _f32(rng, C, s)]
    if c.audio_up == 1:
        rate = (c.audio_down,)
        plain = backend_cuda.fused_audio_backend_plain
        theirs = backend_pallas.fused_audio_backend(
            *map(_j, args), *rate, mm_dtype=jnp.bfloat16, interpret=True)
    else:
        rate = (c.audio_up, c.audio_down)
        plain = resample_cuda.fused_audio_backend_rational_plain
        theirs = resample_pallas.fused_audio_backend_rational(
            *map(_j, args), *rate, mm_dtype=jnp.bfloat16, interpret=True)
    targs = [_t(a) for a in args]
    mixed = 2.0 * args[1] * args[2]
    return Ref(plain(*targs, *rate, "default"),
               plain(*targs, *rate, "highest"), theirs, {3, 4},
               _flip_bound((args[0], h), (mixed, h)))


def _rds_case(mode: int) -> Ref:
    """B4 on seeded draws (its resampled stream from the mix's)."""
    c = get_mode(mode)
    rng = np.random.default_rng(20 + mode)
    h_lpf = firdes.lpf(c.if_fs * c.rds_up, c.rds_fc, c.rds_taps,
                       up_factor=c.rds_up)
    h_rrc = firdes.rrc(c.rds_fs, c.rds_rrc_taps, c.rds_symbol_rate)
    s = (c.rds_taps - 1) // c.rds_up
    s2 = c.rds_rrc_taps - 1
    n = c.if_per_block
    args = [_f32(rng, C, n), _f32(rng, C, n), _f32(rng, C, n), h_lpf, h_rrc,
            _f32(rng, C, s), _f32(rng, C, s), _f32(rng, C, s2),
            _f32(rng, C, s2)]
    targs = [_t(a) for a in args]
    rate = (c.rds_up, c.rds_down)
    theirs = resample_pallas.fused_rds_backend(
        *map(_j, args), *rate, mm_dtype=jnp.bfloat16, interpret=True)
    lp, _ = fir.block_fir_resample(
        torch.stack([targs[1] * targs[0], targs[2] * targs[0]]),
        _t(h_lpf), torch.stack([targs[5], targs[6]]), up=c.rds_up,
        down=c.rds_down)
    plain = resample_cuda.fused_rds_backend_plain
    return Ref(plain(*targs, *rate, "default"),
               plain(*targs, *rate, "highest"), theirs, {2, 3},
               _flip_bound((args[1] * args[0], h_lpf), (lp, h_rrc)))


def _b7_case(c: int = 16, t: int = 12) -> Ref:
    """B7's branch FIRs, then the float32 DFT: dy4tpu's DFT einsum at
    DEFAULT is float32 on the CPU, so only the taps' rounding shows."""
    jp = jch.make_channelizer(c, 240e3, taps_per_branch=t)
    tp = convert.chan_params_from_numpy(jp, device=DEV)
    rng = np.random.default_rng(c + t)
    bands = 2
    x_u8 = rng.integers(0, 256, (bands, 2 * c * 24), dtype=np.uint8)
    ti = (rng.integers(0, 256, (bands, c * t - 1)) - 128.0) / 128.0
    tq = (rng.integers(0, 256, (bands, c * t - 1)) - 128.0) / 128.0
    ti, tq = ti.astype(np.float32), tq.astype(np.float32)
    js = jch.ChannelizerState(tail_i=jnp.asarray(ti), tail_q=jnp.asarray(tq))
    (y_i, y_q), st = jch.channelize_block_u8(
        jp, js, jnp.asarray(x_u8), precision=lax.Precision.DEFAULT,
        impl="pallas", interpret=True)
    ts = channelizer.ChannelizerState(tail_i=_t(ti), tail_q=_t(tq))

    def ours(precision):
        w, tail_i, tail_q = channelizer_cuda.channelize_branches_plain(
            _t(x_u8), tp.p, ts.tail_i, ts.tail_q, precision)
        g_i, g_q, _, _ = channelizer._dft_mats_corrected(tp, None)
        return (channelizer._dft(g_i, w), channelizer._dft(g_q, w), tail_i,
                tail_q)

    theirs = (y_i, y_q, st.tail_i, st.tail_q)
    return Ref(ours("default"), ours("highest"), theirs, {2, 3},
               BAR + STEP * float(np.abs(jp.p).sum()) * c)


CASES = {
    "B1_mode0_rds": lambda: _front_case(0, True),
    "B1_mode1": lambda: _front_case(1, False),
    "B1_corr_mode0": lambda: _front_case(0, True, corr=True),
    "B6_mode0": _if_case,
    "B3_mode0": lambda: _audio_case(0),
    "B3_mode1": lambda: _audio_case(1),
    "B5_mode2": lambda: _audio_case(2),
    "B5_mode3": lambda: _audio_case(3),
    "B4_19_120": lambda: _rds_case(0),
    "B4_171_640": lambda: _rds_case(2),
    "B7_C16_T12": _b7_case,
}


@functools.lru_cache(maxsize=None)
def _case(name: str) -> Ref:
    return CASES[name]()


def _errors(ours, theirs):
    """(index, |ours - theirs|) of every output both have."""
    out = []
    for k, (o, r) in enumerate(zip(ours, theirs)):
        assert (o is None) == (r is None), k
        if r is not None:
            o, r = o.numpy(), np.asarray(r)
            assert o.shape == r.shape, (k, o.shape, r.shape)
            out.append((k, np.abs(o.astype(np.float64) - r)))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_rounded_plain_matches_dy4tpu_bf16_kernel(name):
    ref = _case(name)
    assert len(ref.ours) == len(ref.theirs)
    for k, err in _errors(ref.ours, ref.theirs):
        if k in ref.exact:
            assert err.max() == 0.0, f"output {k}: not exact"
            continue
        beyond = float(np.mean(err > BAR))
        assert beyond <= SHARE, f"output {k}: {beyond:.4f} past {BAR:g}"
        assert err.max() <= ref.bound, (
            f"output {k}: {err.max():.3g} past the flip bound "
            f"{ref.bound:.3g}")


@pytest.mark.parametrize("name", list(CASES))
def test_highest_misses_dy4tpu_bf16_kernel(name):
    """A port that ignored ``precision`` would give these outputs."""
    ref = _case(name)
    worst = max(err.max() for _, err in _errors(ref.highest, ref.theirs))
    assert worst >= 10 * BAR, worst


# ---- (c) the chain against dy4tpu's bf16 chain ----

N_BLOCKS = 3


@pytest.fixture(scope="module")
def chains():
    """Mode 0, C=2 (the broadcast and the same with I/Q swapped), 3
    blocks: the port at "default" and dy4tpu's fused kernels at DEFAULT
    in interpret mode, un-jitted."""
    cfg = get_mode(0)
    iq = _broadcast(cfg, N_BLOCKS, seed=5).reshape(N_BLOCKS, 1, -1)
    swapped = iq.reshape(N_BLOCKS, 1, -1, 2)[..., ::-1].reshape(iq.shape)
    iq = np.concatenate([iq, swapped], axis=1)
    jp = jrx.make_params(cfg)
    tp = convert.params_from_numpy(jp, device=DEV)
    interp = lambda f: functools.partial(f, interpret=True)  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DY4TPU_RDS_BACKEND", "fused")
        for mod, name in ((frontend_pallas, "fused_frontend_full"),
                          (backend_pallas, "fused_audio_backend"),
                          (resample_pallas, "fused_rds_backend")):
            mp.setattr(mod, name, interp(getattr(mod, name)))
        js, ts = jrx.init_state(cfg, batch=(2,)), rx.init_state(
            cfg, (2,), device=DEV)
        outs = []
        for b in range(N_BLOCKS):
            js, jo = jrx.receiver_step(jp, js, jnp.asarray(iq[b]), cfg,
                                       precision=lax.Precision.DEFAULT,
                                       frontend="fused", backend="fused")
            ts, to = rx.receiver_step(tp, ts, torch.from_numpy(iq[b]), cfg,
                                      precision="default")
            outs.append((to, jo, ts, js))
    return outs


def test_chain_matches_dy4tpu_default(chains):
    """Every decision exact (RDS symbols, resync flags, CDR offsets) and
    the state after every block to test_torch_receiver.py's 1e-4 (the RF
    tail exact).  From block 1 on, the audio and baseband streams at
    (a)'s bars (the flip bound of their last stage's taps) and the pilot
    SNR to 1e-3 dB.  Block 0 is the PLLs' lock transient: there dy4tpu's
    fused chain departs from its float32 stock chain, and the port's, by
    up to 1.2e-2 at HIGHEST too (measured), a difference inside dy4tpu; it
    is held to 2e-2."""
    cfg = get_mode(0)
    p = rx.make_params(cfg, device=DEV)
    taps = dict(mono=p.audio_coeff, left=p.audio_coeff,
                right=p.audio_coeff, rds_bb_i=p.rds_rrc_coeff,
                rds_bb_q=p.rds_rrc_coeff, rds_sym_i=p.rds_rrc_coeff)
    for b, (to, jo, ts, js) in enumerate(chains):
        for f in rx.StepOutputs._fields:
            o, r = getattr(to, f).numpy(), np.asarray(getattr(jo, f))
            assert o.shape == r.shape and o.dtype == r.dtype, f
            if r.dtype.kind != "f":
                np.testing.assert_array_equal(o, r, err_msg=f"{f}[{b}]")
                continue
            err = np.abs(o - r)
            if b == 0:
                assert err.max() <= 2e-2, (f, b, err.max())
            elif f == "pilot_snr_db":
                assert err.max() <= 1e-3, (f, b, err.max())
            else:
                assert np.mean(err > BAR) <= SHARE, (f, b)
                assert err.max() <= _flip_bound((r, taps[f])), (f, b)
        ours = convert.state_to_numpy(ts)
        ref = convert.leaves_by_path(js)
        assert ours.keys() == ref.keys()
        for k in ref:
            if ref[k].dtype.kind == "f":
                np.testing.assert_allclose(ours[k], ref[k], atol=1e-4,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(ours["rf.iq_tail"], ref["rf.iq_tail"])


# ---- (d) "highest" is the float32 path ----

def _step_case(mode=0):
    cfg = get_mode(mode)
    blocks = torch.from_numpy(_rows(fm.stereo_rds_broadcast(cfg, 2), cfg, 2,
                                    rows=2).copy())
    return cfg, rx.make_params(cfg, device=DEV), blocks


def _equal_trees(a, b, path=""):
    """Two trees of (named) tuples of tensors, bit for bit."""
    if isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor) and torch.equal(a, b), path
    elif b is None:
        assert a is None, path
    else:
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}.{getattr(b, '_fields', ())[k:k + 1]}"
                         if hasattr(b, "_fields") else f"{path}.{k}")


def test_highest_is_the_default_bitwise():
    cfg, params, blocks = _step_case()
    st = rx.init_state(cfg, (2,), device=DEV)
    ref = rx.run_blocks(params, st, blocks, cfg)
    _equal_trees(rx.run_blocks(params, st, blocks, cfg, precision="highest"),
                 ref)
    assert not np.array_equal(
        rx.run_blocks(params, st, blocks, cfg, precision="default")[1]
        .mono.numpy(), ref[1].mono.numpy())


def test_high_rounds_the_kernels_as_default():
    """dy4tpu calls its kernels with ``mm_dtype=bf16`` at HIGH as at
    DEFAULT (only its DFT einsum tells them apart, (e)): the receiver at
    "high" is bitwise the receiver at "default"."""
    cfg, params, blocks = _step_case()
    st = rx.init_state(cfg, (2,), device=DEV)
    _equal_trees(rx.run_blocks(params, st, blocks, cfg, precision="high"),
                 rx.run_blocks(params, st, blocks, cfg, precision="default"))


@pytest.mark.parametrize("rds", [True, False])
def test_highest_front_is_the_float32_composition(rds):
    """B1's plain version at "highest" is bit for bit the float32 ops it
    was written as: the RF LPF, the demod, the delays, the bank and the
    carrier BPF on unrounded streams and taps."""
    cfg, params, blocks = _step_case(0 if rds else 1)
    st = rx.front_state_of(rx.init_state(cfg, (2,), with_rds=rds,
                                         device=DEV))
    got = frontend_cuda.fused_frontend_full_plain(
        blocks[0], params.rf_coeff, params.bank_coeff,
        params.rds_carrier_coeff, st.rf.iq_tail, st.rf.prev_i, st.rf.prev_q,
        st.bank_tail, st.mono_delay, st.carrier_tail, st.rds_delay,
        cfg.rf_decim, rds=rds, precision="highest")
    x = (blocks[0].to(torch.float32) - 128.0) / 128.0
    iq = x.reshape(2, -1, 2).movedim(-1, -2)
    iq_ds, iq_tail = fir.block_fir_decim(iq, params.rf_coeff, st.rf.iq_tail,
                                         cfg.rf_decim)
    fm_, pi, pq = demod.fm_demod_diff(iq_ds[:, 0], iq_ds[:, 1], st.rf.prev_i,
                                      st.rf.prev_q)
    fmd, mono_delay = mix.delay_block(fm_, st.mono_delay)
    bands, bank_tail = fir.block_fir_bank(fm_, params.bank_coeff,
                                          st.bank_tail)
    want = [fmd, bands[:, 0], bands[:, 1], None, None, iq_tail, pi, pq,
            bank_tail, mono_delay, None, None]
    if rds:
        sq = mix.squaring_nonlinearity(bands[:, 2])
        want[3], want[10] = fir.block_fir(sq, params.rds_carrier_coeff,
                                          st.carrier_tail)
        want[4], want[11] = mix.delay_block(bands[:, 2], st.rds_delay)
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), k
        if w is not None:
            assert torch.equal(g, w), k


def test_highest_back_ends_are_the_float32_composition():
    """B3 and B4's plain versions at "highest": the unrounded mix,
    resampler and RRC, bit for bit."""
    cfg = get_mode(0)
    rng = np.random.default_rng(7)
    n, s = cfg.if_per_block, cfg.audio_taps - 1
    p = rx.make_params(cfg, device=DEV)
    fmd, sb, nco, nco_q = (_t(_f32(rng, 2, n)) for _ in range(4))
    mt, stt = _t(_f32(rng, 2, s)), _t(_f32(rng, 2, s))
    got = backend_cuda.fused_audio_backend_plain(
        fmd, sb, nco, p.audio_coeff, mt, stt, cfg.audio_down,
        precision="highest")
    y, tails = fir.block_fir_resample(
        torch.stack([fmd, nco * sb * 2.0], -2), p.audio_coeff,
        torch.stack([mt, stt], -2), down=cfg.audio_down)
    for g, w in zip(got, (y[:, 0], y[:, 0] + y[:, 1], y[:, 0] - y[:, 1],
                          tails[:, 0], tails[:, 1])):
        assert torch.equal(g, w)
    s1, s2 = fir.state_len(cfg.rds_taps, cfg.rds_up), cfg.rds_rrc_taps - 1
    lt = [_t(_f32(rng, 2, s1)) for _ in range(2)]
    rt = [_t(_f32(rng, 2, s2)) for _ in range(2)]
    got = resample_cuda.fused_rds_backend_plain(
        fmd, nco, nco_q, p.rds_lpf_coeff, p.rds_rrc_coeff, *lt, *rt,
        cfg.rds_up, cfg.rds_down, precision="highest")
    lp, lpt = fir.block_fir_resample(
        torch.stack([nco * fmd, nco_q * fmd], -2), p.rds_lpf_coeff,
        torch.stack(lt, -2), up=cfg.rds_up, down=cfg.rds_down)
    bb, rrt = fir.block_fir(lp, p.rds_rrc_coeff, torch.stack(rt, -2))
    for g, w in zip(got, (bb[:, 0], bb[:, 1], lpt[:, 0], lpt[:, 1],
                          rrt[:, 0], rrt[:, 1])):
        assert torch.equal(g, w)


# ---- (e) the DFT ----

def test_dft_precisions():
    """"default": a float32 matmul of bf16-rounded operands (to 1e-6
    relative, float64 the reference); "high" (bf16_3x) within 1e-5
    relative of float32; "highest" float32."""
    jp = jch.make_channelizer(16, 240e3)
    tp = convert.chan_params_from_numpy(jp, device=DEV)
    g, _, _, _ = channelizer._dft_mats_corrected(tp, None)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((2, 48, 32)).astype(np.float32))
    exact = g.double() @ w.double().transpose(-1, -2)
    rounded = bf16(g).double() @ bf16(w).double().transpose(-1, -2)
    scale = float(exact.abs().max())
    got = {p: channelizer._dft(g, w, p).double() for p in PRECISIONS}
    assert float((got["default"] - rounded).abs().max()) <= 1e-6 * scale
    assert float((got["high"] - exact).abs().max()) <= 1e-5 * scale
    assert float((got["highest"] - exact).abs().max()) <= 1e-6 * scale
    # "default" is no float32 product: it misses by a bf16 step's order
    assert float((got["default"] - exact).abs().max()) > 1e-4 * scale


# ---- (f) the chunk runners ----

def test_graph_runners_default_bitwise_eager_and_keyed_apart():
    cfg, params, blocks = _step_case()
    st = rx.init_state(cfg, (2,), device=DEV)
    graph.clear()
    eager = rx.run_blocks(params, st, blocks, cfg, precision="default")
    _equal_trees(graph.run_blocks(params, st, blocks, cfg, chunk=2,
                                  precision="default"), eager)
    keys = {graph.cached_runner(params, st, cfg, "rf", kw).key for kw in
            ({"precision": "default"}, {"precision": "highest"}, {})}
    assert len(keys) == 3
    assert graph.cached_runner(params, st, cfg, "rf", {
        "precision": "default"}) is not graph.cached_runner(
            params, st, cfg, "rf", {"precision": "highest"})
    graph.clear()


def test_graph_wideband_default_bitwise_eager():
    cfg = get_mode(0)
    params = rx.make_params(cfg, device=DEV)
    chan = wideband.make_wideband(cfg, 4, device=DEV)
    rng = np.random.default_rng(9)
    wb = torch.from_numpy(rng.integers(
        0, 256, (2, 1, 2 * 4 * cfg.if_per_block), dtype=np.uint8))
    st = wideband.wideband_init(cfg, chan, batch=(1,))
    graph.clear()
    eager = wideband.run_wideband_blocks(params, chan, st, wb, cfg,
                                         precision="default")
    got = graph.run_wideband_blocks(params, chan, st, wb, cfg, chunk=2,
                                    precision="default")
    _equal_trees(got, eager)
    high = wideband.run_wideband_blocks(params, chan, st, wb, cfg)
    assert not torch.equal(high[1].rssi, eager[1].rssi)
    graph.clear()


def test_sharded_default_bitwise_run_blocks_and_runner_key():
    """(g) and the sharded runner: the exact sharded step at "default" on
    a 1x1 mesh, through its runner, bit for bit ``run_blocks`` at
    "default"; the runner's key holds the precision."""
    cfg, params, _ = _step_case()
    s_blocks = 2
    flat = fm.stereo_rds_broadcast(cfg, s_blocks + 1, noise=0.05).ravel()
    n = s_blocks * cfg.block_size
    iq = torch.from_numpy(np.stack([flat[:n], flat[74:74 + n]]))
    r = ShardedReceiver(cfg, make_mesh(devices=[DEV]), shard_blocks=s_blocks,
                        precision="default")
    assert r.precision == "default"
    runner = graph.sharded_runner(r, params, r.init(2))
    assert ("precision", "default") in runner.key
    out = runner.run(r.input_sharding(iq)[None])
    _, ref = rx.run_blocks(params, rx.init_state(cfg, (2,), device=DEV),
                           iq.reshape(2, s_blocks, -1).transpose(0, 1),
                           cfg, precision="default")
    np.testing.assert_array_equal(
        out.mono[0].numpy(), ref.mono.permute(1, 0, 2).reshape(2, -1)
        .numpy())
    np.testing.assert_array_equal(
        out.rds_symbols[0].numpy(),
        ref.rds_symbols.permute(1, 0, 2).reshape(2, -1).numpy())


# ---- (h) unknown names ----

@pytest.mark.parametrize("call", [
    lambda: rounds("bf16"),
    lambda: rx.receiver_step(*_step_case()[1:2], rx.init_state(
        get_mode(0), (2,), device=DEV), _step_case()[2][0], get_mode(0),
        precision="DEFAULT"),
    lambda: frontend_cuda.fused_frontend_raw_plain(
        torch.zeros(1, 200, dtype=torch.uint8), torch.ones(11),
        torch.zeros(1, 2, 10), torch.zeros(1), torch.zeros(1), 10,
        precision="float32"),
    lambda: ShardedReceiver(get_mode(0), make_mesh(devices=[DEV]),
                            precision="low"),
    lambda: channelizer._dft(torch.ones(2, 2), torch.ones(3, 2), "fast"),
], ids=["rounds", "receiver_step", "B11", "sharded", "dft"])
def test_unknown_precision_raises(call):
    with pytest.raises(ValueError, match="precision"):
        call()

"""B4 / B5's polyphase tile resampler (``csrc/rational.cuh``) on the CPU.

Persistent blocks walk work items of (row group, tile of whole phase
cycles); B4 recomputes a halo of whole cycles before every tile but the
first for its RRC.  The kernels run only on the card, where
``chip_smoke.py`` holds them to their plain versions.  Here:

1. the plan (``resample_cuda._tile_plan``) at every geometry the port
   runs: B4 at modes 0 and 2, B5 at modes 2 and 3 (C = 512), the sharded
   step's back half (C = 128, 7680 inputs, and its mini warm-up's 1920),
   the CLI's C = 1, a ragged C = 37, and pinned plans with a short last
   row group and a last tile shorter than the rest: every tile is whole
   cycles, every output is covered exactly once, the halo holds at least
   K2 - 1 outputs and stays inside the row, and the shared memory is the
   kernel's formula and at most ``kernels.SMEM_MAX``;
2. ``_tiled_model``: the kernel's polyphase table, input windows, halo
   and staged tile over plain torch ops, each output summed tap by tap in
   the kernel's order.  It must equal the plain versions within 1e-5 with
   the carried input tails exact (and B4's RRC tails, resampler outputs,
   within 1e-5), give the same bits under two plans, and once equal
   dy4tpu's Pallas kernel in interpret mode;
3. ``csrc/rds_backend.cu`` and ``csrc/audio_rational.cu`` themselves, with
   ``rational.cuh`` (and ``rational_tc.cuh``, the tensor-core design at
   "default": ``tests/test_torch_resample_mma.py``), built for the host by
   g++ through ``cuda_host.py``'s
   shim (a ``std::thread`` per CUDA thread, ``std::barrier`` for
   ``__syncthreads`` and the compute warps' named barrier, ``std::fma``
   for ``__fmaf_rn``): within 1e-5 of the plain versions with the tails
   exact at a ragged C, bitwise equal under two plans and under every
   (positions, cycles) shape a thread takes, and with inputs off 16-byte
   alignment (the 4-byte copy and staging paths) bitwise equal to aligned
   ones.
"""

import ctypes
import math

import cuda_host
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.ops import resample_pallas  # noqa: E402
from dy4tpu_torch.config import MODES  # noqa: E402
from dy4tpu_torch.ops import fir, firdes, precision  # noqa: E402
from dy4tpu_torch.ops import resample_cuda as rc  # noqa: E402
from dy4tpu_torch.runtime import kernels  # noqa: E402

TOL = 1e-5
RAGGED = 5           # rows: row groups of 2, 2 and 1 under rows=2


def _rds_geom(mode):
    c = MODES[mode]
    return c.if_per_block, c.rds_up, c.rds_down, c.rds_taps, c.rds_rrc_taps


def _audio_geom(mode):
    c = MODES[mode]
    return c.if_per_block, c.audio_up, c.audio_down, c.audio_taps, 0


# (label, rows, (n_in, up, down, k, k2)): every geometry the port runs
GEOMS = [
    ("B4 mode0", 512, _rds_geom(0)), ("B4 mode2", 512, _rds_geom(2)),
    ("B5 mode2", 512, _audio_geom(2)), ("B5 mode3", 512, _audio_geom(3)),
    ("B4 sharded", 128, _rds_geom(0)),
    ("B4 sharded warm-up", 128, (1920,) + _rds_geom(0)[1:]),
    ("B4 CLI mode0", 1, _rds_geom(0)), ("B4 CLI mode2", 1, _rds_geom(2)),
    ("B5 CLI mode2", 1, _audio_geom(2)), ("B5 CLI mode3", 1, _audio_geom(3)),
    ("B4 ragged mode0", 37, _rds_geom(0)),
    ("B4 ragged mode2", 37, _rds_geom(2)),
    ("B5 ragged mode2", 37, _audio_geom(2)),
    ("B5 ragged mode3", 37, _audio_geom(3)),
]
# pinned plans: a short last row group (37 = 9 x 4 + 1) and a last tile
# shorter than the rest
PINNED = [
    ("B4 mode0 rows4", 37, _rds_geom(0), dict(rows=4, cycles=10)),
    ("B4 mode2 rows2", 37, _rds_geom(2), dict(rows=2, cycles=4)),
    ("B5 mode2 rows2", 37, _audio_geom(2), dict(rows=2, cycles=5)),
    ("B5 mode3 rows2", 37, _audio_geom(3), dict(rows=2, cycles=3)),
]


def _items(plan, c, n_in, up, down, k2):
    """The kernel's item walk (``rational.cuh`` item_of): per item its
    rows, tile, outputs [m0, m1) and resampled cycles [c_lo, c_hi)."""
    m_out = n_in * up // down
    for it in range(plan.items):
        g, tile = divmod(it, plan.n_tiles)
        row0 = g * plan.rows
        m0 = tile * plan.tile
        m1 = min(m_out, m0 + plan.tile)
        c_lo = tile * plan.cycles - (plan.halo // up if tile else 0)
        yield (range(row0, min(c, row0 + plan.rows)), tile, m0, m1, c_lo,
               m1 // up)


@pytest.mark.parametrize("label,c,geom,pin", [
    pytest.param(label, c, g, {}, id=label) for label, c, g in GEOMS] + [
    pytest.param(label, c, g, pin, id=label) for label, c, g, pin in PINNED])
def test_plan_covers_every_output_once(label, c, geom, pin):
    n_in, up, down, k, k2 = geom
    plan = rc._tile_plan(c, n_in, up, down, k, k2, **pin)
    for key, v in pin.items():
        assert getattr(plan, key) == v
    m_out = n_in * up // down
    s = (k - 1) // up
    assert m_out % up == 0 and plan.tile == plan.cycles * up
    assert plan.span == up and (plan.lead_group, plan.lead_mod) == (1, 1)
    seen = np.zeros((c, m_out), np.int32)
    lengths = set()
    for rows, tile, m0, m1, c_lo, c_hi in _items(plan, c, n_in, up, down,
                                                 k2):
        assert len(rows) >= 1 and (m1 - m0) % up == 0 and m1 > m0
        lengths.add(m1 - m0)
        seen[rows.start:rows.stop, m0:m1] += 1
        assert c_hi * up == m1 and c_lo >= 0
        if k2:
            # the resampled outputs before m0 that the RRC reads
            before = m0 - c_lo * up if tile else plan.yhead
            assert before >= k2 - 1
        window = s + (c_hi - c_lo) * down
        assert window <= plan.window and c_lo * down + window <= s + n_in
    assert (seen == 1).all(), f"{label}: outputs covered other than once"
    assert max(lengths) == plan.tile
    window, ystride, yhead, smem = rc._layout(
        up, down, s, k2, plan.rows, plan.cycles, plan.halo // up, plan.span,
        plan.phases)
    assert (window, ystride, yhead, smem) == (plan.window, plan.ystride,
                                              plan.yhead, plan.smem)
    assert plan.smem <= kernels.SMEM_MAX
    tuples, lx, guard = rc._tuples(up, down, s, plan.span, plan.phases)
    assert (plan.lx, plan.guard) == (lx, guard) and guard >= lx - s - 1
    assert math.gcd(plan.tmul, tuples) == 1 or tuples == 1
    assert plan.compute_threads >= tuples * plan.groups
    assert plan.compute_threads % 32 == 0 and plan.threads % 32 == 0
    assert plan.threads <= rc.MAX_THREADS
    assert (plan.phases, plan.chunk) in rc.SHAPES
    assert 1 <= plan.ctas <= plan.items
    assert plan.items == -(-c // plan.rows) * plan.n_tiles
    if pin:
        assert len(lengths) == 2, f"{label}: no shorter last tile"
        assert c % plan.rows, f"{label}: no short last row group"


def test_plan_refuses_what_does_not_resample():
    with pytest.raises(ValueError):
        rc._tile_plan(4, 7681, 19, 120, 1919, 101)
    with pytest.raises(ValueError):
        rc._tile_plan(4, 9600, 342, 1280, 17271, 101)    # gcd 2


# ---- _tiled_model: the kernel's index arithmetic over plain ops ----

def _polyphase(h, up, taps):
    """h [K] -> [up, taps]: hp[r, t] = h[r + t*up], 0 past K."""
    hp = torch.zeros(up * taps, dtype=h.dtype)
    hp[:h.shape[0]] = h
    return hp.reshape(taps, up).t().contiguous()


def _tiled_model(x2, tails, h, up, down, plan, h_rrc=None, rrc_tails=None):
    """The kernel on CPU tensors: ``x2`` [C, 2, N] the two mixed streams
    of each row, ``tails`` [C, 2, S]; B4 with ``h_rrc`` and
    ``rrc_tails`` [C, 2, K2-1].  Per item of ``plan`` the window of whole
    cycles from ``c_lo``, the resampled cycles at their positions in the
    staged tile (the halo first), and (B4) the RRC over the staged tile.
    Returns ``(y [C, 2, M], new tails, bb, new RRC tails)``, the last two
    None without ``h_rrc``."""
    c, _, n_in = x2.shape
    k = h.shape[0]
    s = (k - 1) // up
    taps = s + 1
    m_out = n_in * up // down
    k2 = 0 if h_rrc is None else h_rrc.shape[0]
    hp = _polyphase(h, up, taps)
    pos = torch.arange(up)
    phase = pos * down % up
    b = (pos * down - phase) // up
    x_ext = torch.cat([tails, x2], -1)
    y = torch.empty(c, 2, m_out)
    bb = torch.empty(c, 2, m_out) if k2 else None
    for rows, tile, m0, m1, c_lo, c_hi in _items(plan, c, n_in, up, down,
                                                 k2):
        r = slice(rows.start, rows.stop)
        win = x_ext[r, :, c_lo * down:s + c_hi * down]
        cyc = torch.arange(c_hi - c_lo)
        newest = s + cyc[:, None] * down + b[None, :]      # [cycles, up]
        acc = torch.zeros(len(rows), 2, c_hi - c_lo, up)
        for t in range(taps):
            acc = acc + hp[phase, t] * win[..., newest - t]
        ye = acc.reshape(len(rows), 2, -1)                 # m from c_lo*up
        own = ye[..., (m0 - c_lo * up):]
        y[r, :, m0:m1] = own
        if k2:
            if tile == 0:
                ye = torch.cat([rrc_tails[r], ye], -1)
            lead = ye.shape[-1] - (m1 - m0)                # outputs before m0
            acc = torch.zeros(len(rows), 2, m1 - m0)
            for j in range(k2):
                acc = acc + h_rrc[j] * ye[..., lead - j:lead - j + m1 - m0]
            bb[r, :, m0:m1] = acc
    new_tails = x_ext[..., n_in:n_in + s]
    rrc_new = y[..., m_out - (k2 - 1):] if k2 else None
    return y, new_tails, bb, rrc_new


def _rds_args(rng, mode, c):
    cfg = MODES[mode]
    h_lpf = firdes.lpf(cfg.if_fs * cfg.rds_up, cfg.rds_fc, cfg.rds_taps,
                       up_factor=cfg.rds_up)
    h_rrc = firdes.rrc(cfg.rds_fs, cfg.rds_rrc_taps, cfg.rds_symbol_rate)
    s, s2 = (cfg.rds_taps - 1) // cfg.rds_up, cfg.rds_rrc_taps - 1
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    n = cfg.if_per_block
    return (f(c, n), f(c, n), f(c, n), torch.from_numpy(h_lpf),
            torch.from_numpy(h_rrc), f(c, s), f(c, s), f(c, s2), f(c, s2))


def _audio_args(rng, mode, c):
    cfg = MODES[mode]
    h = firdes.lpf(cfg.if_fs * cfg.audio_up, cfg.audio_fc, cfg.audio_taps,
                   up_factor=cfg.audio_up)
    s = (cfg.audio_taps - 1) // cfg.audio_up
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    n = cfg.if_per_block
    return (f(c, n), f(c, n), f(c, n), torch.from_numpy(h), f(c, s),
            f(c, s))


def _model_rds(args, up, down, plan):
    rds, nco_i, nco_q, h_lpf, h_rrc, lti, ltq, rti, rtq = args
    x2 = torch.stack([nco_i * rds, nco_q * rds], 1)
    y, tails, bb, rrc = _tiled_model(
        x2, torch.stack([lti, ltq], 1), h_lpf, up, down, plan, h_rrc,
        torch.stack([rti, rtq], 1))
    return (bb[:, 0], bb[:, 1], tails[:, 0], tails[:, 1], rrc[:, 0],
            rrc[:, 1])


def _model_audio(args, up, down, plan):
    fmd, sb, nco, h, mt, st = args
    x2 = torch.stack([fmd, nco * sb * 2.0], 1)
    y, tails, _, _ = _tiled_model(x2, torch.stack([mt, st], 1), h, up, down,
                                  plan)
    mono, stereo = y[:, 0], y[:, 1]
    return mono, mono + stereo, mono - stereo, tails[:, 0], tails[:, 1]


def _case(which, mode, c, seed):
    rng = np.random.default_rng(seed)
    cfg = MODES[mode]
    if which == "B4":
        return (_rds_args(rng, mode, c), cfg.rds_up, cfg.rds_down,
                rc.fused_rds_backend_plain, _model_rds, {2, 3})
    return (_audio_args(rng, mode, c), cfg.audio_up, cfg.audio_down,
            rc.fused_audio_backend_rational_plain, _model_audio, {3, 4})


def _plans(which, args, up, down, c):
    """The wrapper's own plan at ``c`` rows and a pinned other one: row
    groups of 2 (the last one short) and tiles of 3 cycles (B4 at mode 0:
    7, for its halo of 6)."""
    n = args[0].shape[-1]
    k = args[3].shape[0]
    k2 = args[4].shape[0] if which == "B4" else 0
    own = rc._tile_plan(c, n, up, down, k, k2)
    other = rc._tile_plan(c, n, up, down, k, k2, rows=2,
                          cycles=7 if up == 19 else 3)
    assert own != other and other.n_tiles > 1
    return own, other


def _check(got, want, exact):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        if i in exact:
            assert torch.equal(g, w), i
        else:
            err = float((g.double() - w.double()).abs().max())
            assert err <= TOL, (i, err)


CASES = [("B4", 0), ("B4", 2), ("B5", 2), ("B5", 3)]


@pytest.mark.parametrize("which,mode", CASES,
                         ids=[f"{w}-mode{m}" for w, m in CASES])
def test_tiled_model_matches_plain_under_two_plans(which, mode):
    args, up, down, plain, model, exact = _case(which, mode, RAGGED, mode)
    want = plain(*args, up, down)
    outs = [model(args, up, down, p)
            for p in _plans(which, args, up, down, RAGGED)]
    for got in outs:
        _check(got, want, exact)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which,mode", CASES,
                         ids=[f"{w}-mode{m}" for w, m in CASES])
def test_host_kernel_bf16_matches_rounded_plain(host_lib, which, mode):
    """At bf16 (precision "default"), the tensor-core design
    (``csrc/rational_tc.cuh``, rounding its own taps) against the plain
    version at "default", bit for bit under two plans (B4's halo rounded
    as its own tile rounds it).  Both round the same mixed products, so
    B5 holds 1e-5 with its tails exact.  B4 sums its resampled stream in
    another order than the plain version, so the stream's rounding before
    the RRC can flip: at most 0.5% of the baseband past 1e-5, each within
    2^-8 max|y| sum|h_rrc|; the LPF tails exact, the RRC tails (the
    unrounded stream) within 1e-5."""
    args, up, down, plain, _, exact = _case(which, mode, RAGGED, 80 + mode)
    want = plain(*args, up, down, "default")
    n, k = args[0].shape[-1], args[3].shape[0]
    k2 = args[4].shape[0] if which == "B4" else 0
    plans = (rc._tc_plan(RAGGED, n, up, down, k, k2),
             rc._tc_plan(RAGGED, n, up, down, k, k2, rows=2,
                         cycles=7 if up == 19 else 3))
    assert plans[0] != plans[1] and plans[1].n_tiles > 1
    outs = [_host_run(host_lib[which], which, args, up, down, p, bf16=1)
            for p in plans]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    if which == "B5":
        _check(outs[0], want, exact)
        return
    y, _ = fir.block_fir_resample(
        precision.bf16(torch.stack([args[1] * args[0], args[2] * args[0]])),
        precision.taps(args[3], "default"),
        precision.bf16(torch.stack(args[5:7])), up=up, down=down)
    bound = TOL + 2.0 ** -8 * float(y.abs().max()) * float(
        args[4].abs().sum())
    for i, (g, w) in enumerate(zip(outs[0], want)):
        err = (g.double() - w.double()).abs()
        if i in exact:
            assert torch.equal(g, w), i
        elif i < 2:
            assert float((err > TOL).double().mean()) <= 0.005, i
            assert float(err.max()) <= bound, (i, float(err.max()))
        else:
            assert float(err.max()) <= TOL, i


def test_tiled_model_matches_pallas():
    """B4 at mode 0, C = 3, against dy4tpu's Pallas kernel in interpret
    mode (float32), as tests/test_torch_backend.py runs it."""
    cfg = MODES[0]
    args, up, down, _, model, _ = _case("B4", 0, 3, 4)
    plan = rc._tile_plan(3, cfg.if_per_block, up, down, cfg.rds_taps,
                         cfg.rds_rrc_taps, cycles=16)
    ours = model(args, up, down, plan)
    ref = resample_pallas.fused_rds_backend(
        *(jnp.asarray(a.numpy()) for a in args), up, down,
        mm_dtype=jnp.float32, interpret=True)
    for i, (o, r) in enumerate(zip(ours, ref)):
        if i in (2, 3):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=TOL)


# ---- the .cu files on the host ----

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``csrc/rds_backend.cu`` and ``csrc/audio_rational.cu`` with
    ``rational.cuh`` and ``rational_tc.cuh`` built for the host: their
    entry points, the float32 walk's under "B4" / "B5" and the
    tensor-core design's under "B4 tc" / "B5 tc"."""
    so = cuda_host.build_rational(tmp_path_factory.mktemp("rational_host"),
                                  "librational_host.so",
                                  ("rds_backend", "audio_rational"))
    fns = {}
    for which, name, argtypes in (("B4", "dy4_rds_backend", rc._ARGS),
                                  ("B5", "dy4_audio_rational",
                                   rc._AUDIO_ARGS),
                                  ("B4 tc", "dy4_rds_backend_tc",
                                   rc._TC_ARGS),
                                  ("B5 tc", "dy4_audio_rational_tc",
                                   rc._AUDIO_TC_ARGS)):
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[which] = fn
    for which in ("B4", "B5"):
        fns[which].tc = fns[f"{which} tc"]
    return fns


def _host_run(fn, which, args, up, down, plan, bf16=0):
    """One launch of the host build under ``plan`` with one copy warp (a
    thread of the block is a host thread here): the float32 walk, or
    where ``bf16`` the tensor-core design (``fn.tc``, ``plan`` a
    ``TcPlan``, two compute warps): the outputs the wrapper would
    allocate, filled."""
    if bf16:
        fn = fn.tc
        plan = plan._replace(compute_threads=64)
    plan = plan._replace(threads=plan.compute_threads + 32)
    c, n = args[0].shape
    k = args[3].shape[0]
    s = (k - 1) // up
    m = n * up // down
    if which == "B4":
        k2 = args[4].shape[0]
        outs = [torch.full(shape, math.nan) for shape in
                ((c, m), (c, m), (c, s), (c, s), (c, k2 - 1), (c, k2 - 1))]
        geom = (c, n, up, down, k, k2)
    else:
        outs = [torch.full(shape, math.nan) for shape in
                ((c, m),) * 3 + ((c, s),) * 2]
        geom = (c, n, up, down, k)
    plan_args = (rc._tc_plan_args if bf16 else rc._plan_args)(plan, up,
                                                              down)
    status = fn(*(t.data_ptr() for t in args), *(t.data_ptr() for t in outs),
                *geom, *plan_args, None)
    assert status == 0
    return outs


@pytest.mark.parametrize("which,mode", CASES,
                         ids=[f"{w}-mode{m}" for w, m in CASES])
def test_host_kernel_matches_plain_under_two_plans(host_lib, which, mode):
    """At C = 5: the wrapper's own plan and row groups of 2 (the last one
    short) with tiles of 3 (7) cycles, a last tile shorter than the rest
    and, for B4, a recomputed halo."""
    args, up, down, plain, _, exact = _case(which, mode, RAGGED, 20 + mode)
    want = plain(*args, up, down)
    outs = [_host_run(host_lib[which], which, args, up, down, p)
            for p in _plans(which, args, up, down, RAGGED)]
    for got in outs:
        _check(got, want, exact)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", rc.SHAPES,
                         ids=[f"P{p}-chunk{q}" for p, q in rc.SHAPES])
@pytest.mark.parametrize("which,mode", [("B4", 2), ("B5", 3)])
def test_host_kernel_every_shape(host_lib, which, mode, shape):
    """Each (positions, cycles) a thread takes, at C = 3 in row groups of
    2 and tiles of 3 cycles (B4: a recomputed halo): within 1e-5 of the
    plain version and bitwise equal to the wrapper's own plan."""
    args, up, down, plain, _, exact = _case(which, mode, 3, 40 + mode)
    n, k = args[0].shape[-1], args[3].shape[0]
    k2 = args[4].shape[0] if which == "B4" else 0
    plan = rc._tile_plan(3, n, up, down, k, k2, rows=2, cycles=3,
                         shape=shape)
    got = _host_run(host_lib[which], which, args, up, down, plan)
    _check(got, plain(*args, up, down), exact)
    own = _host_run(host_lib[which], which, args, up, down,
                    rc._tile_plan(3, n, up, down, k, k2))
    for a, b in zip(got, own):
        assert torch.equal(a, b)


def _misaligned(t):
    """A contiguous copy of ``t`` 4 bytes off 16-byte alignment."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("which,mode", [("B4", 0), ("B5", 3)])
def test_host_kernel_misaligned_inputs(host_lib, which, mode):
    """Inputs and taps off 16-byte alignment: the copy warps' 4-byte path
    and the taps' 4-byte staging give the bits of the 16-byte ones."""
    args, up, down, _, _, _ = _case(which, mode, 3, 60 + mode)
    n, k = args[0].shape[-1], args[3].shape[0]
    k2 = args[4].shape[0] if which == "B4" else 0
    plan = rc._tile_plan(3, n, up, down, k, k2, rows=2, cycles=7 if up == 19
                         else 3)
    want = _host_run(host_lib[which], which, args, up, down, plan)
    got = _host_run(host_lib[which], which, tuple(_misaligned(t) for t in
                                                  args), up, down, plan)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_host_kernel_refuses_a_plan_it_cannot_run(host_lib):
    args, up, down, _, _, _ = _case("B5", 2, 2, 0)
    plan = rc._tile_plan(2, args[0].shape[-1], up, down, args[3].shape[0], 0)
    bad = plan._replace(smem=plan.smem + 16)
    outs = [torch.empty(2, 1764) for _ in range(3)] + [
        torch.empty(2, 100) for _ in range(2)]
    status = host_lib["B5"](*(t.data_ptr() for t in args),
                            *(t.data_ptr() for t in outs), 2,
                            args[0].shape[-1], up, down, args[3].shape[0],
                            *rc._plan_args(bad, up, down), None)
    assert status == 1               # cudaErrorInvalidValue, no launch

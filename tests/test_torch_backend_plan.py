"""B3, the audio back end of the U=1 modes, as the decimating case of the
polyphase tile resampler (``csrc/rational.cuh``), on the CPU.

``backend_cuda.fused_audio_backend`` launches ``csrc/audio_rational.cu``
with U = 1: a cycle of the walk is ``span`` consecutive outputs, a thread
owns a tuple of P of them whose tap rows are shifted to share each input
read, and tuple k reads ``(k // lead_group) % lead_mod`` steps ahead of
its newest input, which spreads a warp's window reads over the banks at
even D.  The kernel runs only on the card, where ``chip_smoke.py`` holds
it to its plain version.  Here:

1. the plan (``resample_cuda._tile_plan`` at U = 1) at D = 5 and 8, at
   full width (C = 512), a ragged 37 rows, the CLI's C = 1 and the
   sharded step's long rows (C = 128, six blocks and a halo), and pinned
   plans with a short last row group and a last tile shorter than the
   rest: every output covered exactly once, the leads below D, the loop
   long enough for every shifted row, and the shared memory the kernel's
   formula and at most ``kernels.SMEM_MAX``;
2. ``_shifted_model``: the kernel's shifted tap rows, leads and item walk
   over plain torch ops, each output summed step by step from +0.  It
   must equal ``fused_audio_backend_plain`` within 1e-5 with the tails
   exact, and give the same bits under two plans;
3. ``csrc/audio_rational.cu`` with ``rational.cuh`` (and
   ``rational_tc.cuh``, whose tensor-core design runs "default") built for
   the host through ``cuda_host.py``'s shim, at U = 1: within 1e-5 of the plain
   version with the tails exact and bitwise equal under two plans and
   under every (outputs, cycles) shape a thread takes; one long row with
   a halo bitwise equal to the same samples run block by block with
   carried tails (the exact sharded receiver's contract); inputs off
   16-byte alignment bitwise equal to aligned ones; and a plan it cannot
   run refused.
"""

import ctypes
import math

import cuda_host
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu_torch.config import MODES  # noqa: E402
from dy4tpu_torch.ops import backend_cuda, firdes  # noqa: E402
from dy4tpu_torch.ops import resample_cuda as rc  # noqa: E402
from dy4tpu_torch.parallel.sharded import exact_min_halo_if  # noqa: E402
from dy4tpu_torch.runtime import kernels  # noqa: E402

TOL = 1e-5
RAGGED = 5           # rows: row groups of 2, 2 and 1 under rows=2
# the sharded step's long row: six blocks and its halo
SHARDED_BLOCKS = 6
HALO = {m: exact_min_halo_if(MODES[m]) for m in (0, 1)}


def _geom(mode, blocks=1):
    c = MODES[mode]
    n = blocks * c.if_per_block + (HALO[mode] if blocks > 1 else 0)
    return n, c.audio_down, c.audio_taps


# (label, rows, mode, n_in blocks): every geometry B3 runs
GEOMS = [(f"mode{m} {label}", c, m, b) for m in (0, 1) for label, c, b in
         (("full", 512, 1), ("ragged", 37, 1), ("CLI", 1, 1),
          ("sharded", 128, SHARDED_BLOCKS))]
# pinned plans: a short last row group (37 = 18 x 2 + 1) and a last tile
# shorter than the rest
PINNED = [("mode0 rows2", 37, 0, dict(rows=2, cycles=7, shape=(1, 2))),
          ("mode1 rows2", 37, 1, dict(rows=2, cycles=7, shape=(1, 2))),
          ("mode1 rows4 P4", 37, 1, dict(rows=4, cycles=4, shape=(4, 1)))]


def _items(plan, c, n_in, down):
    """The kernel's item walk (``rational.cuh`` item_of) at U = 1: per
    item its rows, outputs [m0, m1) and cycles [c_lo, c_hi)."""
    m_out = n_in // down
    for it in range(plan.items):
        g, tile = divmod(it, plan.n_tiles)
        m0 = tile * plan.tile
        m1 = min(m_out, m0 + plan.tile)
        yield (range(g * plan.rows, min(c, (g + 1) * plan.rows)), m0, m1,
               tile * plan.cycles, m1 // plan.span)


@pytest.mark.parametrize("label,c,mode,blocks,pin", [
    pytest.param(label, c, m, b, {}, id=label) for label, c, m, b in GEOMS]
    + [pytest.param(label, c, m, 1, pin, id=label)
       for label, c, m, pin in PINNED])
def test_plan_covers_every_output_once(label, c, mode, blocks, pin):
    n_in, down, k = _geom(mode, blocks)
    plan = rc._tile_plan(c, n_in, 1, down, k, 0, **pin)
    for key, v in pin.items():
        assert (getattr(plan, key) if key != "shape" else
                (plan.phases, plan.chunk)) == v
    m_out = n_in // down
    s = k - 1
    step = plan.span * down
    assert m_out % plan.span == 0 and plan.span % plan.phases == 0
    assert plan.tile == plan.cycles * plan.span and plan.halo == 0
    assert 1 <= plan.lead_mod <= down
    seen = np.zeros((c, m_out), np.int32)
    lengths = set()
    for rows, m0, m1, c_lo, c_hi in _items(plan, c, n_in, down):
        assert len(rows) >= 1 and m1 > m0 and (m1 - m0) % plan.span == 0
        lengths.add(m1 - m0)
        seen[rows.start:rows.stop, m0:m1] += 1
        assert c_hi * plan.span == m1 and c_lo * plan.span == m0
        assert s + (c_hi - c_lo) * step <= plan.window
    assert (seen == 1).all(), f"{label}: outputs covered other than once"
    assert max(lengths) == plan.tile
    lead = (plan.lead_group, plan.lead_mod)
    anchors = rc._anchors(1, down, plan.span, plan.phases, lead)
    tuples = len(anchors)
    assert tuples * plan.phases == plan.span
    # each tuple's loop holds its first output's taps after the shift, and
    # its reads stay inside the window: at most the cycle's last input
    for kt, a in enumerate(anchors):
        assert a - kt * plan.phases * down + k <= plan.lx
        assert a <= step - 1
    window, ystride, yhead, smem = rc._layout(
        1, down, s, 0, plan.rows, plan.cycles, 0, plan.span, plan.phases,
        lead)
    assert (window, ystride, yhead, smem) == (plan.window, plan.ystride,
                                              plan.yhead, plan.smem)
    assert plan.smem <= kernels.SMEM_MAX
    assert (plan.lx, plan.guard) == rc._tuples(1, down, s, plan.span,
                                               plan.phases, lead)[1:]
    assert plan.guard >= plan.lx - k
    assert plan.compute_threads >= tuples * plan.groups
    assert plan.compute_threads % 32 == 0 and plan.threads <= rc.MAX_THREADS
    assert plan.threads - plan.compute_threads >= 32 * rc.MIN_COPY_WARPS
    assert (plan.phases, plan.chunk) in rc.SHAPES
    assert 1 <= plan.ctas <= plan.items
    assert plan.items == -(-c // plan.rows) * plan.n_tiles
    if pin:
        assert len(lengths) == 2, f"{label}: no shorter last tile"
        assert c % plan.rows, f"{label}: no short last row group"


def test_leads_spread_a_warp_over_the_banks():
    """At D = 8 every tuple's newest input falls on one of two bank pairs,
    so the first warp of 16 tuples reads the window in eight wavefronts or
    more; with the plan's leads in at most four, at every shape."""
    for phases, chunk in rc.SHAPES:
        span = max(rc._spans(1, 8, 9216, phases))
        tmul, lead = rc._tuple_order(1, 8, span, phases, chunk)
        if span // phases < 16:
            continue
        bare = rc._anchors(1, 8, span, phases)
        spread = rc._anchors(1, 8, span, phases, lead)
        warp = lambda a: [a[lane % 16] + lane // 16 * chunk * span * 8  # noqa
                          for lane in range(32)]
        assert rc._half_warp_wavefronts(warp(bare)) >= 8
        assert rc._half_warp_wavefronts(warp(spread)) <= 4, (phases, lead)


def test_plan_refuses_what_does_not_decimate():
    with pytest.raises(ValueError):
        rc._tile_plan(4, 7681, 1, 5, 101, 0)


# ---- _shifted_model: the kernel's index arithmetic over plain ops ----

def _args(rng, mode, c, n=None):
    cfg = MODES[mode]
    h = firdes.lpf(cfg.if_fs, cfg.audio_fc, cfg.audio_taps)
    n = cfg.if_per_block if n is None else n
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    s = cfg.audio_taps - 1
    return (f(c, n), f(c, n), f(c, n), torch.from_numpy(h), f(c, s),
            f(c, s))


def _shifted_model(args, down, plan):
    """B3 on CPU tensors as the kernel runs it under ``plan``: the mixed
    streams' windows of whole cycles (the carried tail first in tile 0,
    zeros in the guard before it), each position's tap row shifted onto
    its tuple's anchor (b_p of the tuple's last position plus its lead),
    every output summed over the loop's steps tau = 0..lx-1 from +0, then
    the L/R matrix.  Returns what ``fused_audio_backend`` returns."""
    fmd, sb, nco, h, mt, st = args
    c, n_in = fmd.shape
    k = h.shape[0]
    s = k - 1
    span, phases = plan.span, plan.phases
    step = span * down
    anchors = rc._anchors(1, down, span, phases,
                          (plan.lead_group, plan.lead_mod))
    pos = torch.arange(span)
    anchor = torch.tensor(anchors)[pos // phases]        # [span]
    rows = torch.zeros(span, plan.lx)
    for p in range(span):
        shift = anchors[p // phases] - p * down
        rows[p, shift:shift + k] = h
    x_ext = torch.cat([torch.stack([mt, st], 1),
                       torch.stack([fmd, nco * sb * 2.0], 1)], -1)
    y = torch.empty(c, 2, n_in // down)
    for rws, m0, m1, c_lo, c_hi in _items(plan, c, n_in, down):
        r = slice(rws.start, rws.stop)
        win = x_ext[r, :, c_lo * step:s + c_hi * step]
        win = torch.cat([torch.zeros(win.shape[:2] + (plan.guard,)), win],
                        -1)
        cyc = torch.arange(c_hi - c_lo)
        newest = plan.guard + s + cyc[:, None] * step + anchor[None, :]
        assert int(newest.max()) < win.shape[-1]
        acc = torch.zeros(len(rws), 2, c_hi - c_lo, span)
        for tau in range(plan.lx):
            assert int((newest - tau).min()) >= 0
            acc = acc + rows[:, tau] * win[..., newest - tau]
        y[r, :, m0:m1] = acc.reshape(len(rws), 2, -1)
    mono, stereo = y[:, 0], y[:, 1]
    new = x_ext[..., n_in:n_in + s]
    return mono, mono + stereo, mono - stereo, new[:, 0], new[:, 1]


def _check(got, want):
    """Within 1e-5 of ``want``, the tails (the last two) bit for bit."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        if i >= 3:
            assert torch.equal(g, w), i
        else:
            err = float((g.double() - w.double()).abs().max())
            assert err <= TOL, (i, err)


def _plans(args, down):
    """The wrapper's own plan at the args' rows and a pinned other one:
    row groups of 2 (the last one short), one output a thread and tiles
    of 7 cycles of 16 outputs (a shorter last one)."""
    c, n = args[0].shape
    own = rc._tile_plan(c, n, 1, down, args[3].shape[0], 0)
    other = rc._tile_plan(c, n, 1, down, args[3].shape[0], 0, rows=2,
                          cycles=7, shape=(1, 2))
    assert own != other and other.n_tiles > 1
    return own, other


@pytest.mark.parametrize("mode", [0, 1])
def test_shifted_model_matches_plain_under_two_plans(mode):
    down = MODES[mode].audio_down
    args = _args(np.random.default_rng(mode), mode, RAGGED)
    want = backend_cuda.fused_audio_backend_plain(*args, down)
    outs = [_shifted_model(args, down, p) for p in _plans(args, down)]
    for got in outs:
        _check(got, want)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---- csrc/audio_rational.cu on the host, at U = 1 ----

@pytest.fixture(scope="module")
def host_b3(tmp_path_factory):
    """``csrc/audio_rational.cu`` with ``rational.cuh`` and
    ``rational_tc.cuh`` built for the host: its float32 walk's entry
    point, the tensor-core design's as its ``tc``."""
    so = cuda_host.build_rational(tmp_path_factory.mktemp("b3_host"),
                                  "libb3_host.so", ("audio_rational",))
    fn = so.dy4_audio_rational
    fn.argtypes = rc._AUDIO_ARGS
    fn.restype = ctypes.c_int
    fn.tc = so.dy4_audio_rational_tc
    fn.tc.argtypes = rc._AUDIO_TC_ARGS
    fn.tc.restype = ctypes.c_int
    return fn


def _host_run(fn, args, down, plan=None, bf16=0):
    """One launch of the host build under ``plan`` (the wrapper's own by
    default) with one copy warp (a thread of the block is a host thread
    here): the float32 walk, or where ``bf16`` the tensor-core design
    (``plan`` a ``TcPlan``, two compute warps): the outputs
    ``fused_audio_backend`` would return, filled."""
    c, n = args[0].shape
    k = args[3].shape[0]
    if bf16:
        fn = fn.tc
        plan = (plan or rc._tc_plan(c, n, 1, down, k, 0))._replace(
            compute_threads=64)
        plan_args = rc._tc_plan_args
    else:
        plan = plan or rc._tile_plan(c, n, 1, down, k, 0)
        plan_args = rc._plan_args
    plan = plan._replace(threads=plan.compute_threads + 32)
    outs = [torch.full(shape, math.nan) for shape in
            ((c, n // down),) * 3 + ((c, k - 1),) * 2]
    status = fn(*(t.data_ptr() for t in args), *(t.data_ptr() for t in outs),
                c, n, 1, down, k, *plan_args(plan, 1, down), None)
    assert status == 0
    return outs


@pytest.mark.parametrize("mode", [0, 1])
def test_host_kernel_matches_plain_under_two_plans(host_b3, mode):
    """At C = 5: the wrapper's own plan and row groups of 2 (the last one
    short) with a last tile shorter than the rest."""
    down = MODES[mode].audio_down
    args = _args(np.random.default_rng(20 + mode), mode, RAGGED)
    want = backend_cuda.fused_audio_backend_plain(*args, down)
    outs = [_host_run(host_b3, args, down, p) for p in _plans(args, down)]
    for got in outs:
        _check(got, want)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", [0, 1])
def test_host_kernel_bf16_matches_rounded_plain(host_b3, mode):
    """At bf16 (precision "default"): the tensor-core design
    (``csrc/rational_tc.cuh`` at U = 1, rounding its own taps, both legs
    staged rounded) against the plain version at "default" within 1e-5,
    its tails (the unrounded legs) exact, bit for bit under two plans."""
    down = MODES[mode].audio_down
    args = _args(np.random.default_rng(80 + mode), mode, RAGGED)
    want = backend_cuda.fused_audio_backend_plain(*args, down, "default")
    n, k = args[0].shape[-1], args[3].shape[0]
    plans = (rc._tc_plan(RAGGED, n, 1, down, k, 0),
             rc._tc_plan(RAGGED, n, 1, down, k, 0, rows=2, cycles=7))
    assert plans[0] != plans[1]
    outs = [_host_run(host_b3, args, down, p, bf16=1) for p in plans]
    for got in outs:
        _check(got, want)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", rc.SHAPES,
                         ids=[f"P{p}-chunk{q}" for p, q in rc.SHAPES])
def test_host_kernel_every_shape(host_b3, shape):
    """Each (outputs, cycles) a thread takes at D = 8 (the leads at work),
    C = 3 in row groups of 2 and tiles of 3 cycles: within 1e-5 of the
    plain version and bitwise equal to the wrapper's own plan."""
    down = MODES[1].audio_down
    args = _args(np.random.default_rng(40), 1, 3)
    plan = rc._tile_plan(3, args[0].shape[-1], 1, down, args[3].shape[0], 0,
                         rows=2, cycles=3, shape=shape)
    got = _host_run(host_b3, args, down, plan)
    _check(got, backend_cuda.fused_audio_backend_plain(*args, down))
    for a, b in zip(got, _host_run(host_b3, args, down)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", [0, 1])
def test_host_kernel_long_row_equals_blocks(host_b3, mode):
    """The exact sharded receiver runs B3 once on a row of a halo and its
    blocks, ``run_blocks`` block by block with the tails carried: a halo
    and two blocks as one row give the bits of the three run in turn, each
    under its own plan."""
    cfg = MODES[mode]
    down, n, halo = cfg.audio_down, cfg.if_per_block, HALO[mode]
    args = _args(np.random.default_rng(60 + mode), mode, 3, halo + 2 * n)
    whole = _host_run(host_b3, args, down)
    tails = args[4:]
    pieces = []
    for a, b in ((0, halo), (halo, halo + n), (halo + n, halo + 2 * n)):
        cut = tuple(t[:, a:b].contiguous() for t in args[:3])
        out = _host_run(host_b3, cut + (args[3],) + tuple(tails), down)
        pieces.append(out[:3])
        tails = out[3:]
    for i in range(3):
        assert torch.equal(whole[i], torch.cat([p[i] for p in pieces], -1))
    for a, b in zip(whole[3:], tails):
        assert torch.equal(a, b)


def _misaligned(t):
    """A contiguous copy of ``t`` 4 bytes off 16-byte alignment."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("mode", [0, 1])
def test_host_kernel_misaligned_inputs(host_b3, mode):
    """Inputs and taps off 16-byte alignment: the copy warps' 4-byte path
    gives the bits of the 16-byte one."""
    down = MODES[mode].audio_down
    args = _args(np.random.default_rng(80 + mode), mode, 3)
    want = _host_run(host_b3, args, down)
    got = _host_run(host_b3, tuple(_misaligned(t) for t in args), down)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["lead past D", "short loop", "smem",
                                 "span not dividing the row"])
def test_host_kernel_refuses_a_plan_it_cannot_run(host_b3, bad):
    down = MODES[1].audio_down
    args = _args(np.random.default_rng(0), 1, 2)
    n, k = args[0].shape[-1], args[3].shape[0]
    plan = next(p for _, p in rc._candidates(2, n, 1, down, k, 0, rc.SMS,
                                             shape=(1, 1)) if p.span == 16)
    assert plan.lead_mod == down
    plan = {"lead past D": plan._replace(lead_mod=down + 1),
            "short loop": plan._replace(lx=plan.lx - 1),
            "smem": plan._replace(smem=plan.smem + 16),
            "span not dividing the row": plan._replace(span=plan.span * 5),
            }[bad]
    outs = [torch.empty(2, n // down) for _ in range(3)] + [
        torch.empty(2, k - 1) for _ in range(2)]
    status = host_b3(*(t.data_ptr() for t in args),
                     *(t.data_ptr() for t in outs), 2, n, 1, down, k,
                     *rc._plan_args(plan, 1, down), None)
    assert status == 1               # cudaErrorInvalidValue, no launch

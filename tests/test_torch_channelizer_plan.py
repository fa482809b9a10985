"""B7, the wideband channelizer's branch FIRs, as a register-blocked
column FIR over staged u8 tiles, on the CPU.

``channelizer_cuda.channelize_branches`` launches ``csrc/channelizer.cu``
under a plan from ``channelizer_cuda._tile_plan``: blocks walk (band, tile
of rows) items, copying the next item's u8 window into shared memory while
they compute this one; a thread takes units of R rows of one column of
``w``.  The kernel runs only on the card, where ``chip_smoke.py`` holds it
to its plain version.  Here:

1. the plan at every geometry ``chip_smoke.py`` runs (its ``WB_GEOMS`` on
   32 bands, the wideband tool's one band at C = 8 and C = 25, 37 ragged
   bands of 1531 rows, T = 24 taps, C = 100) and at pinned plans: every
   output (band, m, j) covered exactly once by the kernel's item walk and
   thread layout, each item's copies and reads inside its stage at every
   alignment of the input, and the shared memory the kernel's own formula
   and at most what the card allows; a plan for every bank the first
   design (a block per 8192 outputs, float32 staging) served;
2. ``csrc/channelizer.cu`` built for the host through ``cuda_host.py``'s
   shim: within 1e-5 of ``channelize_branches_plain`` with the tails
   bit-equal at C = 3, 4, 8, 16, 25, 100 and 128 and at T = 17, 24 and 32
   (the last with no stage head), bitwise equal under two plans and at an
   input off 16-byte alignment, right where a band's new tail crosses a
   tile boundary or reaches into the old tail, over tiles shorter than T,
   and a plan it cannot run refused.
"""

import ctypes

import cuda_host
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.ops import channelizer as chz  # noqa: E402
from dy4tpu_torch.ops import channelizer_cuda as cc  # noqa: E402
from dy4tpu_torch.runtime import kernels  # noqa: E402

TOL = 1e-5
M_BLOCK = get_mode(0).if_per_block        # rows of w a wideband step
# (label, bands, m, C, T): chip_smoke.py's WB_GEOMS on 32 bands, the
# wideband tool's one band at C = 8, 37 ragged bands of 1531 rows, and its
# B7_MORE (an odd C, two groups of taps); C = 100 (2C divides no block)
GEOMS = ([(f"C{c}T{t}", 32, M_BLOCK, c, t)
          for c, t in ((16, 12), (8, 12), (32, 12), (4, 16), (64, 12),
                       (128, 12))]
         + [("tool C8", 1, M_BLOCK, 8, 12), ("ragged", 37, 1531, 16, 12),
            ("tool C25", 1, M_BLOCK, 25, 12), ("C16T24", 32, M_BLOCK, 16, 24),
            ("C100", 1, M_BLOCK, 100, 12)])
# pinned plans: a last tile shorter than T, units of 12 rows with a
# partial last one, one item a block, a band of one tile, tiles under T
PINNED = [("short last tile", 3, 2 * 40 + 5, 16, 12,
           dict(rows=8, tile=40, threads=128, ctas=2)),
          ("rows12", 5, 97, 8, 12, dict(rows=12, tile=24, ctas=7)),
          ("one tile", 4, 9, 4, 16, dict(rows=4, tile=9, ctas=4)),
          ("tiles under T", 3, 50, 25, 24,
           dict(rows=4, tile=8, threads=96, ctas=5))]


def _items(plan, bands, m):
    """The kernel's item walk (``item_of``): band and rows [m0, m1)."""
    for it in range(plan.items):
        band, tile = divmod(it, plan.n_tiles)
        m0 = tile * plan.tile
        yield band, m0, min(m, m0 + plan.tile)


def _check_plan(plan, bands, m, c, t):
    """Every output covered once by the items, each item's units and the
    block's threads; every copy and read inside its stage."""
    c2 = 2 * c
    n2 = c2 * m
    assert plan.n_tiles == -(-m // plan.tile) and plan.tile <= m
    assert plan.items == bands * plan.n_tiles
    assert 1 <= plan.ctas <= plan.items
    assert plan.rows in cc.ROWS and plan.threads <= cc.MAX_THREADS
    assert plan.threads % 32 == 0
    assert plan.smem == cc._smem_bytes(c, t, plan.rows, plan.tile)
    assert plan.smem <= kernels.SMEM_MAX
    seen = np.zeros((bands, m, c2), np.int8)
    stage = plan.smem // 2 - cc._head_bytes(c, t)     # the u8 window
    r = plan.rows
    zeros = cc._tap_bound(t) - t
    for band, m0, m1 in _items(plan, bands, m):
        units = -(-(m1 - m0) // r) * c2
        # thread tid: units tid, tid + threads, ...: (chunk u // 2C,
        # column u % 2C)
        for tid in range(min(plan.threads, units)):
            for u in range(tid, units, plan.threads):
                ch, j = divmod(u, c2)
                r_a = m0 + ch * r
                seen[band, r_a:min(r_a + r, m1), j] += 1
        lo, hi = max(0, (m0 - t) * c2 + 2), (m1 - 1) * c2 + 2
        assert 0 <= lo < hi <= n2
        # the highest x byte a unit reads (its last window step of the
        # zero taps) and the lowest (only where the window stays above
        # the tail)
        last = m0 + (units // c2 - 1) * r
        top = (last + r - 2 + zeros) * c2 + c2 - 1 + 2
        low = (m0 - t) * c2 + 2 if m0 >= t else 0
        for align in (0, 1, 4, 15):
            shift = (align + band * n2 + lo) % 16
            assert -(-(shift + hi - lo) // 16) * 16 <= stage
            assert shift + top - lo < stage
            assert shift + low - lo >= 0
    assert (seen == 1).all(), "outputs covered other than once"


@pytest.mark.parametrize("label,bands,m,c,t",
                         [pytest.param(*g, id=g[0]) for g in GEOMS])
def test_plan_covers_every_output_once(label, bands, m, c, t):
    _check_plan(cc._tile_plan(bands, m, c, t), bands, m, c, t)


@pytest.mark.parametrize("label,bands,m,c,t,pin",
                         [pytest.param(*g, id=g[0]) for g in PINNED])
def test_pinned_plan_covers_every_output_once(label, bands, m, c, t, pin):
    plan = cc._tile_plan(bands, m, c, t, **pin)
    for key, v in pin.items():
        assert getattr(plan, key) == v
    _check_plan(plan, bands, m, c, t)


def test_plan_spreads_the_tool_band_over_the_sms():
    """The first design lit 15 of 132 SMs at the tool's one band, C = 8:
    the plan's items fill the card."""
    plan = cc._tile_plan(1, M_BLOCK, 8, 12)
    assert plan.ctas >= cc.SMS * 0.9


@pytest.mark.parametrize("bad", ["taps", "smem", "threads"])
def test_plan_refuses_what_the_kernel_cannot_run(bad):
    """A bank of no taps, a tile whose stages overflow the shared memory,
    a block not of whole warps."""
    with pytest.raises(ValueError):
        {"taps": lambda: cc._tile_plan(32, M_BLOCK, 16, 0),
         "smem": lambda: cc._tile_plan(1, M_BLOCK, 128, 12, tile=M_BLOCK),
         "threads": lambda: cc._tile_plan(1, 64, 512, 12,
                                          threads=48)}[bad]()


def _first_design_smem(m: int, c: int, t: int) -> int:
    """Shared memory a block of the first design took: the taps and
    (tm + T-1) rows of the window as float32, tm = 8192 / 2C rows (at
    least 1, at most m)."""
    tm = min(max(1, 8192 // (2 * c)), m)
    return 4 * 2 * c * (t + tm + t - 1)


@pytest.mark.parametrize("t", [1, 5, 12, 16, 17, 24, 40])
def test_plan_serves_every_bank_the_first_design_did(t):
    """Every C the first design's block fitted the shared memory at, on a
    wideband step's rows and on a short row: the plan has one, and it is
    a plan the kernel takes."""
    cs = sorted({1, 3, 4, 7, 17, 25, 33, 34, 50, 68, 100, 129, 256, 257,
                 500, 512, 1000} | {c for c in range(200, 4097, 131)})
    served = 0
    for c in cs:
        for bands, m in ((32, M_BLOCK), (1, 5)):
            if _first_design_smem(m, c, t) > kernels.SMEM_MAX:
                continue
            plan = cc._tile_plan(bands, m, c, t)
            assert plan.smem <= kernels.SMEM_MAX
            assert plan.n_tiles == -(-m // plan.tile)
            served += 1
    assert served >= 20


# ---- csrc/channelizer.cu on the host ----

_REWRITES = (
    (r"#include <cuda_runtime\.h>", '#include "shim.h"'),
    (r"extern __shared__ __align__\(16\) unsigned char smem\[\];",
     "unsigned char* smem = g_smem;"),
    cuda_host.LAUNCH,
)


@pytest.fixture(scope="module")
def host_b7(tmp_path_factory):
    """``csrc/channelizer.cu`` built for the host: its entry point and its
    shared-memory formula."""
    src = cuda_host.rewrite((kernels.CSRC / "channelizer.cu").read_text(),
                            "csrc/channelizer.cu", _REWRITES)
    so = cuda_host.build(tmp_path_factory.mktemp("b7_host"),
                         "libb7_host.so",
                         {"cp_async.cuh": cuda_host.cp_async_header(),
                          "channelizer.cpp": src})
    fn = so.dy4_channelizer
    fn.argtypes = cc._ARGS
    fn.restype = ctypes.c_int
    smem = so.dy4_channelizer_smem
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_longlong
    return fn, smem


def _args(seed, bands, m, c, t):
    """A u8 block and mid-stream tails from a seed, and the bank's p."""
    rng = np.random.default_rng(seed)
    p = chz.make_channelizer(c, get_mode(0).if_fs, taps_per_branch=t,
                             device="cpu").p
    x = torch.from_numpy(rng.integers(0, 256, (bands, 2 * c * m),
                                      dtype=np.uint8))
    ti, tq = (torch.from_numpy(rng.standard_normal(
        (bands, c * t - 1)).astype(np.float32)) for _ in range(2))
    return x, p, ti, tq


def _host_run(host, args, plan=None, status=0):
    """One launch of the host build under ``plan`` (the wrapper's own by
    default): ``(w, tail_i, tail_q)``, filled with NaN before."""
    fn, _ = host
    x, p, ti, tq = args
    bands, n2 = x.shape
    c, t = p.shape
    m = n2 // (2 * c)
    if plan is None:
        plan = cc._tile_plan(bands, m, c, t)
    outs = (torch.full((bands, m, 2 * c), float("nan")),
            torch.full((bands, c * t - 1), float("nan")),
            torch.full((bands, c * t - 1), float("nan")))
    got = fn(*(a.data_ptr() for a in args), *(o.data_ptr() for o in outs),
             cc._launch_array(bands, n2, c, t, plan), None)
    assert got == status
    return outs


def _check(got, want):
    """w within 1e-5 of ``want``, the tails bit for bit."""
    assert got[0].shape == want[0].shape
    err = float((got[0].double() - want[0].double()).abs().max())
    assert err <= TOL, err
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


def _other(bands, m, c, t):
    """A second plan, unlike the wrapper's own: units of 4 rows (8 where
    the own plan has 4), blocks of 64 threads, two blocks, tiles of 19
    rows."""
    own = cc._tile_plan(bands, m, c, t)
    other = cc._tile_plan(bands, m, c, t, rows=4 if own.rows != 4 else 8,
                          tile=min(m, 19), threads=64, ctas=2)
    assert other != own and other.n_tiles > 1
    return own, other


def test_host_smem_formula_is_the_plans(host_b7):
    _, smem = host_b7
    for _, bands, m, c, t in GEOMS:
        plan = cc._tile_plan(bands, m, c, t)
        assert smem(c, t, plan.rows, plan.tile) == plan.smem


@pytest.mark.parametrize("c,t", [(4, 16), (8, 12), (16, 12), (25, 12),
                                 (100, 12), (16, 24), (3, 17), (128, 32)],
                         ids=["C4T16", "C8T12", "C16T12", "C25T12",
                              "C100T12", "C16T24", "C3T17", "C128T32"])
def test_host_kernel_matches_plain_under_two_plans(host_b7, c, t):
    """Three bands of 45 rows (ragged against every tile and unit): the
    wrapper's own plan and a second one, within 1e-5 of the plain version
    with the tails exact, and bitwise equal to each other.  At C = 25 and
    100 a thread's column changes from unit to unit; at T = 24 and 17 the
    taps run in two groups of 16, the first with 8 and 15 zero taps; at
    C = 128, T = 32 the stages have no head (units read the tail from
    device memory)."""
    assert (cc._head_bytes(c, t) == 0) == ((c, t) == (128, 32))
    args = _args(c + t, 3, 45, c, t)
    want = cc.channelize_branches_plain(*args)
    outs = [_host_run(host_b7, args, plan) for plan in _other(3, 45, c, t)]
    for got in outs:
        _check(got, want)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows", cc.ROWS)
def test_host_kernel_every_rows(host_b7, rows):
    """Each R the kernel is instantiated for, at T = 5 (a tap bound of 8
    with three zero taps) and C = 4: bitwise the wrapper's own plan,
    within 1e-5 of the plain version."""
    args = _args(rows, 2, 41, 4, 5)
    got = _host_run(host_b7, args, cc._tile_plan(2, 41, 4, 5, rows=rows,
                                                 tile=11, ctas=3))
    _check(got, cc.channelize_branches_plain(*args))
    for a, b in zip(got, _host_run(host_b7, args)):
        assert torch.equal(a, b)


def test_host_kernel_misaligned_input(host_b7):
    """x off 16-byte alignment by 1 and 3 bytes (the copy's byte path at
    the tensor's ends): the bits of the aligned input."""
    args = _args(7, 3, 45, 8, 12)
    want = _host_run(host_b7, args)
    for off in (1, 3):
        buf = torch.empty(args[0].numel() + 16, dtype=torch.uint8)
        x = buf[off:off + args[0].numel()].view(args[0].shape)
        x.copy_(args[0])
        assert x.data_ptr() % 16 == off
        got = _host_run(host_b7, (x,) + args[1:])
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("m,tile", [(2 * 40 + 5, 40), (7, 7), (3, 3),
                                   (45, 8)],
                         ids=["last tile short", "one tile", "row < T",
                              "tiles under T"])
def test_host_kernel_new_tail_across_tiles(host_b7, m, tile):
    """The new tail is the last K-1 complex samples of [tail || x]: over
    a last tile of 5 rows and the one before it (C = 16, T = 12: the tail
    spans 12 rows), where the row is shorter than T rows, into the old
    tail, and over tiles of 8 rows (the second tile's window reaching into
    the old tail too).  Within 1e-5, the tails exact."""
    args = _args(m, 3, m, 16, 12)
    plan = cc._tile_plan(3, m, 16, 12, rows=8, tile=tile, ctas=2)
    _check(_host_run(host_b7, args, plan),
           cc.channelize_branches_plain(*args))


def test_host_kernel_carries_tails_across_blocks(host_b7):
    """Two blocks with the tails carried by the kernel give the bits of
    one block of both (the wideband step's contract)."""
    x, p, ti, tq = _args(11, 2, 60, 8, 12)
    whole = _host_run(host_b7, (x, p, ti, tq))
    half = x.shape[1] // 2
    w_a, ta, qa = _host_run(host_b7, (x[:, :half].contiguous(), p, ti, tq))
    w_b, tb, qb = _host_run(host_b7, (x[:, half:].contiguous(), p, ta, qa))
    assert torch.equal(torch.cat([w_a, w_b], 1), whole[0])
    assert torch.equal(tb, whole[1]) and torch.equal(qb, whole[2])


@pytest.mark.parametrize("bad", ["smem", "rows", "tile under T", "threads",
                                 "ctas"])
def test_host_kernel_refuses_a_plan_it_cannot_run(host_b7, bad):
    """Shared memory other than its formula, R not instantiated, tiles
    under T whose count leaves rows out (40 rows in three of 10), a block
    not of whole warps, more blocks than items: refused, nothing
    written."""
    args = _args(0, 2, 40, 8, 12)
    plan = cc._tile_plan(2, 40, 8, 12, rows=8, tile=20, threads=128, ctas=2)
    plan = {"smem": plan._replace(smem=plan.smem + 16),
            "rows": plan._replace(rows=5),
            "tile under T": plan._replace(
                tile=10, n_tiles=3, items=6,
                smem=cc._smem_bytes(8, 12, 8, 10)),
            "threads": plan._replace(threads=48),
            "ctas": plan._replace(ctas=plan.items + 1)}[bad]
    w, ti, tq = _host_run(host_b7, args, plan,
                          status=1)             # cudaErrorInvalidValue
    assert bool(w.isnan().all()) and bool(ti.isnan().all())

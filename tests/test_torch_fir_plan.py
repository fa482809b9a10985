"""B14, the port's decimating block FIR, as the kernel it runs on the card,
on the CPU.

``fir_cuda.block_fir_decim`` launches ``csrc/fir.cu`` under a plan from
``fir_cuda._fir_plan``: a block owns a tile of one row's outputs, fills
each pass's polyphase window by asynchronous copies through a ring of
stages, and makes 4 outputs a thread with ``csrc/rf_stage.cuh``'s MACs.
The kernel runs only on the card, where ``chip_smoke.py`` holds it to
its plain version.  Here:

1. the plan: every output written by exactly one tile and one pass, the
   block's shared memory its kernel's formula and within what the card
   allows, a plan for every (K, D) whose first-port block fitted, the plan
   never raising, and at the RF geometry tiles of 960 outputs and one
   stage (ten blocks an SM), at a short grid smaller tiles and a ring of
   two;
2. ``csrc/fir.cu`` built for the host through ``cuda_host.py``'s shim (a
   copy for each ``cp.async``, nothing for commit and wait): held to
   ``block_fir_decim_plain`` and to dy4tpu's ``block_fir_decim_pallas``
   in interpret mode at tests/test_fir_pallas.py's four cases, 37 ragged
   rows and a row of one tile (y within 2e-4 x max(1, max|y|), as
   test_fir_pallas.py's bar: the two sum the taps in other orders; the
   state exact); under a second plan (other tiles, passes and stages) bit
   for bit; rows independent of one another; two chained blocks bit for
   bit one long block; a plan it cannot run refused;
3. ``csrc/frontend_rf.cu`` (B11) built for the host too: B14 on mode 0's
   and mode 1's normalized RF legs, through ``demod.fm_demod_diff``, gives
   B11's fm, ``iq_tail`` and ``prev_i``/``prev_q`` bit for bit (one tap
   order, one exact normalize, one rounded demod).
"""

import ctypes

import cuda_host
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.ops import fir_pallas  # noqa: E402
from dy4tpu_torch.config import MODES  # noqa: E402
from dy4tpu_torch.ops import demod, fir_cuda as fc  # noqa: E402
from dy4tpu_torch.ops import frontend_cuda  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.runtime import kernels  # noqa: E402
# B11 built for the host, and its u8 FM rows
from test_torch_frontend_rf_plan import _signal, host_rf  # noqa: E402,F401

FIR_TOL = 2e-4
RF = (7680, 10, 101)         # mode 0's RF legs: outputs a row, D, K
# (K, D) the first port served, at its edges (no state, D = 1, long taps)
NAMED_KD = [(1, 1), (7, 2), (33, 4), (101, 5), (101, 10), (129, 8),
            (5000, 64), (20001, 2)]


# ---- 1. the plan ----

def _parent_smem(decim: int, k: int) -> int:
    """Bytes a block of the first port's kernel took: the taps [D, s/D +
    1] and the window [D, 256 + s/D], s = K-1."""
    s = k - 1
    return 4 * decim * (s // decim + 1 + 256 + s // decim)


def _check_plan(plan, n_out: int, decim: int, k: int) -> None:
    """The kernel's walk: tiles [m0, m1) in passes of ``sub``; each output
    made by exactly one tile and one pass, and a pass's window (its
    outputs' taps and the 4 a thread reads past them) within a row of the
    ring."""
    assert plan.tile >= 1 and plan.n_tiles == -(-n_out // plan.tile)
    assert plan.n_tiles <= fc.MAX_TILES
    assert plan.sub >= 4 and plan.sub % 4 == 0
    assert 1 <= plan.stages <= fc.FIR_MAX_STAGES
    nq = fc._phase_taps(decim, k)
    # a thread's window reads run from t0 to t0 + nq + 3, t0 <= sub - 4
    assert plan.sub + nq <= fc._window_row(plan.sub + nq)
    made = np.zeros(n_out, np.int32)
    for tile in range(plan.n_tiles):
        m0 = tile * plan.tile
        m1 = min(m0 + plan.tile, n_out)
        for p in range(-(-(m1 - m0) // plan.sub)):
            lo = m0 + p * plan.sub
            made[lo:min(lo + plan.sub, m1)] += 1
    assert (made == 1).all()
    assert fc._fir_smem_bytes(decim, k, plan.sub,
                              plan.stages) <= kernels.SMEM_MAX


PLAN_CASES = [("rf", *RF), ("rf mode1", 9216, 5, 101),
              ("audio", 128, 5, 101), ("short", 640, 2, 7),
              ("tile edge", 64, 4, 33), ("ragged", 1531, 10, 101),
              ("two tiles ragged", 2 * 2048 + 37, 10, 101),
              ("one output", 1, 10, 11)] + [
    (f"K{k} D{d}", max(256, -(-(k - 1) // d)), d, k) for k, d in NAMED_KD]


@pytest.mark.parametrize("label,n_out,decim,k", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
@pytest.mark.parametrize("rows", [1, 1024], ids=["one row", "1024 rows"])
def test_plan_covers_every_output_once(label, n_out, decim, k, rows):
    _check_plan(fc._fir_plan(n_out, decim, k, rows=rows), n_out, decim, k)


def test_plan_at_the_rf_geometry():
    """Mode 0's RF legs at C=512 (and 128 rows): eight tiles of 960, passes
    of 480 and one stage, ten blocks an SM; never refused.  Four rows (a
    grid short of two blocks an SM): tiles of 128 and a ring of two."""
    for rows in (1024, 128):
        plan = fc._fir_plan(*RF, rows=rows)
        assert plan == fc.FirPlan(960, 8, 480, 1)
        smem = fc._fir_smem_bytes(RF[1], RF[2], plan.sub, plan.stages)
        assert 10 * (smem + fc.BLOCK_RESERVED) <= fc.SM_BYTES, smem
        assert fc._blocks_an_sm(smem) == 10
    assert fc._fir_plan(*RF, rows=4) == fc.FirPlan(128, 60, 128, 2)


def test_plan_serves_every_geometry_the_first_port_did():
    """Every (K, D) at which the first port's block fitted the card, on
    rows of 256 outputs (or the fewest that hold the state), one row and
    1024: a plan that fits, and the plan never raises."""
    served = 0
    for decim in (1, 2, 3, 4, 5, 8, 10, 16, 33, 64, 100, 128):
        for k in (1, 2, 7, 11, 33, 101, 129, 257, 1001, 2049, 5000, 5001,
                  8001, 12001, 20001, 28801, 40001):
            n_out = max(256, -(-(k - 1) // decim))
            for rows in (1, 1024):
                plan = fc._fir_plan(n_out, decim, k, rows=rows)
                if _parent_smem(decim, k) > kernels.SMEM_MAX:
                    continue
                _check_plan(plan, n_out, decim, k)
                served += 1
    for k, d in NAMED_KD:
        assert _parent_smem(d, k) <= kernels.SMEM_MAX
    assert served >= 300


def test_plan_shrinks_pass_then_ring():
    """K = 28801, D = 2 (past what the first port served): at 1024 rows one
    stage of a pass of 256 outputs overflows, so the pass halves; at one
    row the ring of two overflows even with passes of 4, so it drops to
    one stage at the rule's pass.  K = 20001, D = 2: one stage."""
    assert fc._fir_plan(256, 2, 28801, rows=1024) == fc.FirPlan(256, 1, 128,
                                                                 1)
    assert fc._fir_plan(256, 2, 28801) == fc.FirPlan(128, 2, 128, 1)
    assert fc._fir_plan(256, 2, 20001).stages == 1


def test_pinned_plan():
    plan = fc._fir_plan(1000, 10, 101, tile=300, sub=48, stages=3)
    assert plan == fc.FirPlan(300, 4, 48, 3)
    _check_plan(plan, 1000, 10, 101)
    assert fc._fir_plan(1000, 10, 101, tile=300).sub == 300


# ---- 2. csrc/fir.cu on the host ----

_COMMON = ((r"#include <cuda_runtime\.h>", '#include "shim.h"'),)
_SMEM = (r"extern __shared__ float4 smem4\[\];",
         "float4* smem4 = reinterpret_cast<float4*>(g_smem);")


def _header(name: str) -> str:
    return cuda_host.rewrite((kernels.CSRC / name).read_text(),
                             f"csrc/{name}", _COMMON)


@pytest.fixture(scope="module")
def host_fir(tmp_path_factory):
    """``csrc/fir.cu`` built for the host: its entry point and its
    shared-memory formula."""
    src = cuda_host.rewrite(
        (kernels.CSRC / "fir.cu").read_text(), "csrc/fir.cu",
        _COMMON + (_SMEM, (r"fir_decim_kernel<<<grid, kThreads, smem, "
                           r"st>>>\((.*?)\);",
                           r"emulate(fir_decim_kernel, grid, kThreads, "
                           r"smem, \1);")))
    so = cuda_host.build(tmp_path_factory.mktemp("fir_host"),
                         "libfir_host.so",
                         {"cp_async.cuh": cuda_host.cp_async_header(),
                          "rf_stage.cuh": _header("rf_stage.cuh"),
                          "fir.cpp": src})
    fn = so.dy4_fir_decim
    fn.argtypes = fc._ARGS
    fn.restype = ctypes.c_int
    smem = so.dy4_fir_decim_smem
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_longlong
    return fn, smem


def _host_run(host, x, h, st, decim, plan=None, status=0):
    """One launch of the host build under ``plan`` (the wrapper's own by
    default): ``(y, new_state)``, filled with NaN before."""
    fn, _ = host
    n, k = x.shape[-1], h.shape[0]
    rows = x.numel() // n
    if plan is None:
        plan = fc._fir_plan(n // decim, decim, k, rows=rows)
    y = torch.full((*x.shape[:-1], n // decim), float("nan"))
    new_state = torch.full(st.shape, float("nan"))
    got = fn(x.data_ptr(), h.data_ptr(), st.data_ptr(), y.data_ptr(),
             new_state.data_ptr(), rows, n, decim, k, plan.tile, plan.sub,
             plan.stages, None)
    assert got == status
    return y, new_state


def _inputs(seed, bshape, n, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*bshape, n)).astype(np.float32)
    h = rng.standard_normal(k).astype(np.float32)
    st = rng.standard_normal((*bshape, k - 1)).astype(np.float32)
    return x, h, st


def _other_plan(rows: int, n_out: int, decim: int, k: int):
    """A second plan, unlike the wrapper's: tiles of a third of the row
    and one output (so the last is shorter; 4 more where that is the
    wrapper's), passes of 16 outputs, three stages."""
    own = fc._fir_plan(n_out, decim, k, rows=rows)
    tile = n_out // 3 + 1
    other = fc._fir_plan(n_out, decim, k, rows=rows,
                         tile=tile + 4 if tile == own.tile else tile,
                         sub=16, stages=3)
    assert other != own
    return other


HOST_CASES = [((2, 2), 76800, 101, 10),   # test_fir_pallas.py's four
              ((3,), 640, 101, 5),
              ((), 1280, 7, 2),
              ((5,), 256, 33, 4),
              ((37,), 15310, 101, 10),    # 37 rows, a ragged last tile
              ((1,), 2000, 51, 4)]        # a row of one tile


@pytest.mark.parametrize("bshape,n,k,d", HOST_CASES,
                         ids=[f"{list(c[0])}x{c[1]} K{c[2]} D{c[3]}"
                              for c in HOST_CASES])
def test_host_kernel_matches_plain_and_pallas(host_fir, bshape, n, k, d):
    """y within FIR_TOL x max(1, max|y|) of the plain version and of
    dy4tpu's Pallas kernel in interpret mode, the state exact; bit for bit
    under a second plan."""
    x, h, st = _inputs(5 + n + k, bshape, n, k)
    t = torch.from_numpy
    y, s = _host_run(host_fir, t(x), t(h), t(st), d)
    p_y, p_s = fc.block_fir_decim_plain(t(x), t(h), t(st), d)
    ref_y, ref_s = fir_pallas.block_fir_decim_pallas(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(st), d, interpret=True)
    for want_y, want_s in ((p_y.numpy(), p_s.numpy()),
                           (np.asarray(ref_y), np.asarray(ref_s))):
        scale = max(1.0, float(np.abs(want_y).max()))
        np.testing.assert_allclose(y.numpy(), want_y, rtol=0,
                                   atol=FIR_TOL * scale)
        np.testing.assert_array_equal(s.numpy(), want_s)
    rows = x.size // n
    o_y, o_s = _host_run(host_fir, t(x), t(h), t(st), d,
                         _other_plan(rows, n // d, d, k))
    assert torch.equal(o_y, y) and torch.equal(o_s, s)


def test_host_kernel_rows_are_independent(host_fir):
    """The first 36 of 37 rows give the bits of the 37 (each block reads and
    writes its own row)."""
    x, h, st = (torch.from_numpy(a) for a in _inputs(9, (37,), 15310, 101))
    plan = fc._fir_plan(1531, 10, 101, tile=1531)
    y37, s37 = _host_run(host_fir, x, h, st, 10, plan)
    y36, s36 = _host_run(host_fir, x[:36].contiguous(), h,
                         st[:36].contiguous(), 10, plan)
    assert torch.equal(y36, y37[:36]) and torch.equal(s36, s37[:36])


def test_host_kernel_chained_blocks_equal_one_long_block(host_fir):
    """Two blocks with the state carried by the kernel give the bits of one
    block of both."""
    x, h, st = (torch.from_numpy(a) for a in _inputs(6, (4,), 2 * 2560,
                                                     101))
    y_all, s_all = _host_run(host_fir, x, h, st, 10)
    y1, s1 = _host_run(host_fir, x[:, :2560].contiguous(), h, st, 10)
    y2, s2 = _host_run(host_fir, x[:, 2560:].contiguous(), h, s1, 10)
    assert torch.equal(torch.cat([y1, y2], -1), y_all)
    assert torch.equal(s2, s_all)


def test_host_smem_formula_is_the_plans(host_fir):
    _, smem = host_fir
    for _, n_out, decim, k in PLAN_CASES:
        for rows in (1, 1024):
            p = fc._fir_plan(n_out, decim, k, rows=rows)
            assert smem(decim, k, p.sub, p.stages) == fc._fir_smem_bytes(
                decim, k, p.sub, p.stages)


@pytest.mark.parametrize("bad", ["sub", "tile", "tiles", "stages", "smem"])
def test_host_kernel_refuses_what_it_cannot_run(host_fir, bad):
    """Passes not of whole units of 4 outputs, no tile, more tiles than
    grid.y takes (65,536 tiles of one output), a ring of 4, a block over
    227 KB: refused, nothing written."""
    n = 10 * (fc.MAX_TILES + 1) if bad == "tiles" else 2560
    x, h, st = (torch.from_numpy(a) for a in _inputs(0, (2,), n, 101))
    plan = fc._fir_plan(256, 10, 101)
    plan = {"sub": plan._replace(sub=6), "tile": plan._replace(tile=0),
            "tiles": fc.FirPlan(1, n // 10, 4, 1),
            "stages": plan._replace(stages=4),
            "smem": plan._replace(sub=2048, stages=3)}[bad]
    y, s = _host_run(host_fir, x, h, st, 10, plan,
                     status=1)                      # cudaErrorInvalidValue
    assert bool(y.isnan().all()) and bool(s.isnan().all())


# ---- 3. B14's I/Q through the demod is B11's fm ----

@pytest.mark.parametrize("mode", [0, 1])
def test_host_b14_iq_through_demod_is_b11(host_fir, host_rf, mode):
    """B14 on the normalized legs [C, 2, n] of a mode's u8 block, from the
    RF tail B11 carries, then ``demod.fm_demod_diff`` from B11's prev:
    fm, the new tail and prev_i/prev_q bit for bit B11's."""
    cfg = MODES[mode]
    c, decim = 3, cfg.rf_decim
    rng = np.random.default_rng(40 + mode)
    h = rx.make_params(cfg, device="cpu").rf_coeff
    k = h.shape[0]
    u8 = torch.from_numpy(_signal(rng, c, cfg.block_size // 2))
    f = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * 0.1).astype(np.float32))
    tail, prev_i, prev_q = f(c, 2, k - 1), f(c) + 0.5, f(c) + 0.5
    n_out = cfg.if_per_block
    plan = frontend_cuda._rf_plan(n_out, decim, k)
    nan = lambda *s: torch.full(s, float("nan"))  # noqa: E731
    b11 = (nan(c, n_out), nan(c, 2, k - 1), nan(c), nan(c))
    assert host_rf[0](frontend_cuda._PAIRS, u8.data_ptr(), h.data_ptr(),
                      *(a.data_ptr() for a in (tail, prev_i, prev_q)),
                      *(o.data_ptr() for o in b11), c, u8.shape[1], decim,
                      k, plan.tile, plan.sub, None) == 0
    legs = ((u8.to(torch.float32) - 128.0) / 128.0).reshape(
        c, -1, 2).movedim(-1, -2).contiguous()
    iq, new_tail = _host_run(host_fir, legs, h, tail, decim)
    fm, last_i, last_q = demod.fm_demod_diff(iq[:, 0], iq[:, 1], prev_i,
                                             prev_q)
    assert bool(torch.isfinite(fm).all())
    assert torch.equal(fm, b11[0])
    assert torch.equal(new_tail, b11[1])
    assert torch.equal(last_i, b11[2]) and torch.equal(last_q, b11[3])

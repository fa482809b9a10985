"""B11-B13, dy4tpu's A/B RF front ends, as one (row, tile) kernel on B1's
register-blocked RF stage, on the CPU.

``frontend_cuda.fused_frontend_raw`` (B11), ``fused_frontend`` (B12) and
``fused_frontend_raw_pm`` (B13) launch ``csrc/frontend_rf.cu`` under a plan
from ``frontend_cuda._rf_plan``: a thread block owns a tile of one row's
IF outputs and recomputes the I/Q sample before it, ``csrc/rf_stage.cuh``
(the RF stage B1 runs, moved out of ``csrc/frontend.cu``) fills the tile's
I/Q in passes, and the demod writes fm.  The kernel runs only on the card,
where ``chip_smoke.py`` holds it to its plain versions.  Here:

1. the plan: every fm output written by exactly one tile, every RF output
   a tile needs made by exactly one of its passes, the block's shared
   memory its kernel's formula and within what the card allows, 2 blocks
   an SM at modes 0-3, and a plan for every (K, D) whose first-port block
   (a window of 256 + (K-1)/D samples a phase) fitted, the plan never
   raising;
2. ``csrc/frontend_rf.cu`` built for the host through ``cuda_host.py``'s
   shim: all three entries held to ``fused_frontend_raw_plain`` (fm within
   1e-3 where the decimated power is above 1e-3, ``iq_tail`` exact,
   ``prev_i``/``prev_q`` within 1e-5) at modes 0 and 1, C = 1 and 37, a
   last tile shorter than the rest, a row of one tile, the three fuzz
   geometries of ``test_raw_geometry_fuzz`` and a filter whose pass window
   takes two fetch rounds; two plans, and B12 and B13 against B11, bit for
   bit; once against dy4tpu's Pallas ``fused_frontend_raw`` in interpret
   mode; a plan it cannot run refused;
3. ``csrc/frontend.cu`` built for the host too: B11's fm, ``prev_i``/
   ``prev_q`` and ``iq_tail`` bit for bit B1's (fm delayed by B1's mono
   delay), with and without RDS;
4. B1, B1-corr and B6 at precision "default", the tensor-core design
   (``csrc/mma_bf16.cuh``: bf16 ``mma.sync`` Toeplitz products), through
   the shim's warp-wide ``mma.sync``, ``ldmatrix`` and shuffles: each
   lane's B fragment and the shim's instructions against numpy by the
   PTX fragment layout; B1 with and without RDS at modes 0 and 1, C = 1,
   C = 37, a short last tile (rows that start off a word: the funnel
   shift) and one tile, held to the plain version (fm, the RF tail and
   prev at ``_check``'s bars, the band stage on its own fm at 1e-5) and,
   at modes 0 and 1, bit for bit under a second plan; B1-corr's moments
   within 1e-5 of their scale; B6; plans it cannot run refused.
"""

import ctypes

import cuda_host
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.ops import frontend_pallas  # noqa: E402
from dy4tpu_torch.config import MODES  # noqa: E402
from dy4tpu_torch.ops import frontend_cuda as fc  # noqa: E402
from dy4tpu_torch.ops import iqcorr  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.runtime import kernels  # noqa: E402

AB_TOL, AB_POWER, PREV_TOL = 1e-3, 1e-3, 1e-5
MOM_TOL = 1e-5       # the tracker moments, relative to E[|i|^p |q|^r]
SM_BYTES = 233472            # shared memory of one H100 SM (228 KB)
BLOCK_RESERVED = 1024        # the card's own shared memory per block
FUZZ = [(51, 4), (129, 8), (75, 3)]   # test_raw_geometry_fuzz's (K, D)
# (K, D): a pass window of two fetch rounds (D * (4 + nq) > 5120)
LONG = (5000, 64)


# ---- 1. the plan ----

def _parent_smem(decim: int, k: int) -> int:
    """Bytes a block of the first port's kernel took: the taps [D, qmax],
    the windows [2, D, 256 + (K-1)/D], the decimated I/Q [2, 256]."""
    s = k - 1
    return 4 * (decim * (s // decim + 1) + 2 * decim * (256 + s // decim)
                + 2 * 256)


def _check_plan(plan, n_out: int, decim: int, k: int) -> None:
    """The kernel's walk: tiles [m0, m1) write fm once each; a tile's RF
    outputs [g0, m1) (g0 = m0 - 1, or 0 in tile 0 whose slot 0 holds the
    carried prev) come from its passes, each once, and every pass's
    window stays in its window row."""
    assert plan.tile >= 1 and plan.n_tiles == -(-n_out // plan.tile)
    assert plan.n_tiles <= 65535
    assert plan.sub >= 4 and plan.sub % 4 == 0
    nq = fc._phase_taps(decim, k)
    # a thread reads its window from t0 to t0 + nq + 3, t0 <= sub - 4
    assert plan.sub + nq <= fc._window_row(plan.sub + nq)
    written = np.zeros(n_out, np.int32)
    for tile in range(plan.n_tiles):
        m0 = tile * plan.tile
        m1 = min(m0 + plan.tile, n_out)
        g0 = 0 if tile == 0 else m0 - 1
        written[m0:m1] += 1
        n_rf = m1 - g0
        made = np.zeros(n_rf, np.int32)
        passes = -(-n_rf // plan.sub)
        for p in range(passes):
            lo = p * plan.sub
            made[lo:min(lo + plan.sub, n_rf)] += 1
        assert (made == 1).all()
        # the I/Q buffer: slot l = m - (m0 - 1), l0 = g0 - (m0 - 1)
        assert (g0 - (m0 - 1)) + n_rf <= fc._round4(plan.tile + 1)
    assert (written == 1).all()
    assert fc._rf_smem_bytes(plan, decim, k) <= kernels.SMEM_MAX


PLAN_CASES = ([(f"mode{m}", MODES[m].if_per_block, MODES[m].rf_decim, 101)
               for m in sorted(MODES)]
              + [(f"fuzz K{k} D{d}", 256, d, k) for k, d in FUZZ]
              + [("one output", 1, 10, 11), ("ragged", 2 * 2048 + 37, 10, 101),
                 ("long K", 100, LONG[1], LONG[0]),
                 ("tile shrinks", 19000, 1, 19000)])


@pytest.mark.parametrize("label,n_out,decim,k", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_covers_every_output_once(label, n_out, decim, k):
    plan = fc._rf_plan(n_out, decim, k)
    _check_plan(plan, n_out, decim, k)
    if label == "tile shrinks":          # taps and window leave ~540 floats
        assert plan.tile < fc.RF_TILE and plan.sub == 4
    if label.startswith("mode"):
        # 2 blocks an SM (the kernel's kRfBlocks), a pass's window in two
        # fetch rounds
        smem = fc._rf_smem_bytes(plan, decim, k)
        assert 2 * (smem + BLOCK_RESERVED) <= SM_BYTES, smem
        assert plan.tile <= fc.RF_TILE and decim * (plan.sub + fc._phase_taps(
            decim, k)) <= fc.RF_PASS_SAMPLES


def test_plan_serves_every_geometry_the_parent_did():
    """Every (K, D) at which the first port's block fitted the card, on a
    row of 256 outputs (or the fewest that hold the tail): a plan that
    fits, and the plan never raises."""
    served = 0
    for decim in (1, 2, 3, 4, 5, 8, 10, 16, 33, 64, 100, 128):
        for k in (1, 2, 11, 51, 75, 101, 129, 257, 1001, 2049, 5001, 8001,
                  12001, 17001, 19000, 19500):
            n_out = max(256, -(-(k - 1) // decim))
            plan = fc._rf_plan(n_out, decim, k)        # never raises
            if _parent_smem(decim, k) > kernels.SMEM_MAX:
                continue
            _check_plan(plan, n_out, decim, k)
            served += 1
    assert served >= 140


def test_pinned_plan():
    plan = fc._rf_plan(1000, 10, 101, tile=300, sub=48)
    assert plan == fc.RfPlan(300, 4, 48)
    _check_plan(plan, 1000, 10, 101)
    assert fc._rf_plan(1000, 10, 101, tile=300).sub == fc._rf_passes(
        301, 10, 101)


# ---- 2. csrc/frontend_rf.cu on the host ----

_COMMON = ((r"#include <cuda_runtime\.h>", '#include "shim.h"'),)
_SMEM = (r"extern __shared__ float4 smem4\[\];",
         "float4* smem4 = reinterpret_cast<float4*>(g_smem);")




@pytest.fixture(scope="module")
def host_rf(tmp_path_factory):
    """``csrc/frontend_rf.cu`` built for the host: its entry point and its
    shared-memory formula."""
    src = cuda_host.rewrite(
        (kernels.CSRC / "frontend_rf.cu").read_text(), "csrc/frontend_rf.cu",
        _COMMON + (_SMEM, (r"rf_tile_kernel<Src, kLong><<<grid, kThreads, "
                           r"smem, stream>>>\((.*?)\);",
                           r"emulate(rf_tile_kernel<Src, kLong>, grid, "
                           r"kThreads, smem, \1);")))
    so = cuda_host.build(tmp_path_factory.mktemp("rf_host"), "librf_host.so",
                         {"rf_stage.cuh": cuda_host.rf_stage_header(),
                          "frontend_rf.cpp": src})
    fn = so.dy4_frontend_rf
    fn.argtypes = fc._RF_ARGS
    fn.restype = ctypes.c_int
    smem = so.dy4_frontend_rf_smem
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_longlong
    return fn, smem


def _signal(rng, c: int, n_in: int) -> np.ndarray:
    """u8 [c, 2 n_in]: an FM carrier with a slow tone and noise, a random
    phase and level per row (a few rows dip to the origin), so no two rows
    are equal."""
    t = np.arange(n_in)[None] + rng.integers(0, 10**6, (c, 1))
    ph = (0.3 * np.sin(2 * np.pi * t / 4000.0) + 0.05 * t
          + rng.uniform(0, 6, (c, 1)))
    amp = 90 + 20 * rng.random((c, 1))
    iq = (np.stack([128 + amp * np.cos(ph), 128 + amp * np.sin(ph)], -1)
          + rng.normal(0, 3, (c, n_in, 2)))
    return np.clip(np.rint(iq), 0, 255).astype(np.uint8).reshape(c, -1)


def _case(seed: int, c: int, n_out: int, decim: int, k: int = 101):
    """B11's five tensors: a signal, taps (the mode-0 RF LPF at K = 101,
    else a random filter), and random carried state."""
    rng = np.random.default_rng(seed)
    if k == 101:
        h = rx.make_params(MODES[0], device="cpu").rf_coeff
    else:
        h = torch.from_numpy((rng.standard_normal(k) * 0.05
                              ).astype(np.float32))
    f = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * 0.1).astype(np.float32))
    u8 = torch.from_numpy(_signal(rng, c, n_out * decim))
    return u8, h, f(c, 2, k - 1), f(c) + 0.5, f(c) + 0.5


def _host_run(host, source, args, decim, plan=None, status=0):
    """One launch of the host build (``fc._PAIRS`` or ``fc._WORDS``) under
    ``plan`` (the wrapper's own by default): ``(fm, iq_tail, prev_i,
    prev_q)``, filled with NaN before."""
    fn, _ = host
    u8, h, tail, pi, pq = args
    c, bs = u8.shape
    k = h.shape[0]
    n_out = bs // 2 // decim
    if plan is None:
        plan = fc._rf_plan(n_out, decim, k)
    nan = lambda *s: torch.full(s, float("nan"))  # noqa: E731
    outs = (nan(c, n_out), nan(c, 2, k - 1), nan(c), nan(c))
    got = fn(source, *(a.data_ptr() for a in args),
             *(o.data_ptr() for o in outs), c, bs, decim, k, plan.tile,
             plan.sub, None)
    assert got == status
    return outs


def _check(got, want, args, decim):
    """fm within AB_TOL where the plain decimated power is above AB_POWER,
    iq_tail exact, prev_i/prev_q within PREV_TOL."""
    i_ds, q_ds, _ = fc.rf_lpf_plain(args[0], args[1], args[2], decim)
    live = i_ds * i_ds + q_ds * q_ds > AB_POWER
    assert float(live.double().mean()) > 0.9
    assert got[0].shape == want[0].shape
    assert bool(torch.isfinite(got[0]).all())
    err = float((got[0] - want[0]).abs()[live].max())
    assert err <= AB_TOL, err
    assert torch.equal(got[1], want[1])
    for a, b in zip(got[2:], want[2:]):
        assert float((a - b).abs().max()) <= PREV_TOL


def _other_plan(n_out, decim, k):
    """A second plan, unlike the wrapper's: tiles of about a third of the
    row (or its own less 5), passes of 16 outputs."""
    own = fc._rf_plan(n_out, decim, k)
    other = fc._rf_plan(n_out, decim, k, tile=max(1, min(own.tile - 5,
                                                         n_out // 3 + 1)),
                        sub=16)
    assert other != own
    return other


HOST_CASES = [("mode0", 2, MODES[0].if_per_block, 10, 101),
              ("mode1", 2, MODES[1].if_per_block, 5, 101),
              ("C=1", 1, 700, 10, 101), ("C=37", 37, 256, 5, 101),
              ("last tile short", 2, 2 * fc.RF_TILE + 37, 10, 101),
              ("one tile", 3, 150, 10, 101)] + [
    (f"fuzz K{k} D{d}", 2, 256, d, k) for k, d in FUZZ] + [
    ("two fetch rounds", 2, 100, LONG[1], LONG[0])]


@pytest.mark.parametrize("label,c,n_out,decim,k", HOST_CASES,
                         ids=[h[0] for h in HOST_CASES])
def test_host_kernel_matches_plain(host_rf, label, c, n_out, decim, k):
    """B11 (pairs) and B13 (words) of the host build against the plain
    version; B13 and B12 (B11's launch, where the taps phase-align) bit
    for bit B11, and B11 under a second plan bit for bit its own."""
    args = _case(n_out * decim + k, c, n_out, decim, k)
    want = fc.fused_frontend_raw_plain(*args, decim)
    b11 = _host_run(host_rf, fc._PAIRS, args, decim)
    _check(b11, want, args, decim)
    if (k - 1) % decim == 0:
        _check(b11, fc.fused_frontend_plain(*args, decim), args, decim)
    if args[0].shape[1] % 4 == 0:
        b13 = _host_run(host_rf, fc._WORDS, args, decim)
        for a, b in zip(b13, b11):
            assert torch.equal(a, b)
    other = _host_run(host_rf, fc._PAIRS, args, decim,
                      _other_plan(n_out, decim, k))
    for a, b in zip(other, b11):
        assert torch.equal(a, b)


def test_host_kernel_odd_word_phase(host_rf):
    """B13 where a pass's window starts on an odd sample of the row, the
    funnel shift's case (D = 3, K = 50, passes of 8 outputs: a pass of
    tile g0 starts at sample 3*g0 - 49 + 24p, odd in tiles 0 and 1, g0 =
    0 and 20, even in tile 2, g0 = 41): the bits of B11."""
    args = _case(5, 2, 64, 3, 50)
    plan = fc._rf_plan(64, 3, 50, tile=21, sub=8)
    b11 = _host_run(host_rf, fc._PAIRS, args, 3, plan)
    b13 = _host_run(host_rf, fc._WORDS, args, 3, plan)
    for a, b in zip(b13, b11):
        assert torch.equal(a, b)
    _check(b11, fc.fused_frontend_raw_plain(*args, 3), args, 3)


def test_host_kernel_carries_state_across_blocks(host_rf):
    """Two blocks with the state carried by the kernel give the bits of
    one block of both (the stream's contract)."""
    args = _case(11, 3, 600, 5)
    whole = _host_run(host_rf, fc._PAIRS, args, 5)
    half = args[0].shape[1] // 2
    first = _host_run(host_rf, fc._PAIRS,
                      (args[0][:, :half].contiguous(), *args[1:]), 5)
    second = _host_run(host_rf, fc._PAIRS,
                       (args[0][:, half:].contiguous(), args[1], *first[1:]),
                       5)
    assert torch.equal(torch.cat([first[0], second[0]], 1), whole[0])
    for a, b in zip(second[1:], whole[1:]):
        assert torch.equal(a, b)


def test_host_smem_formula_is_the_plans(host_rf):
    _, smem = host_rf
    for _, n_out, decim, k in PLAN_CASES:
        plan = fc._rf_plan(n_out, decim, k)
        assert smem(plan.tile, plan.sub, decim, k) == fc._rf_smem_bytes(
            plan, decim, k)


@pytest.mark.parametrize("bad", ["sub", "tile", "source"])
def test_host_kernel_refuses_what_it_cannot_run(host_rf, bad):
    """Passes not of whole units of outputs, no tile, an unknown source:
    refused, nothing written."""
    args = _case(0, 2, 100, 10)
    plan = fc._rf_plan(100, 10, 101)
    plan, source = {"sub": (plan._replace(sub=6), fc._PAIRS),
                    "tile": (plan._replace(tile=0), fc._PAIRS),
                    "source": (plan, 7)}[bad]
    fm, tail, _, _ = _host_run(host_rf, source, args, 10, plan,
                               status=1)            # cudaErrorInvalidValue
    assert bool(fm.isnan().all()) and bool(tail.isnan().all())


def test_host_kernel_matches_pallas_interpret(host_rf):
    """One case against dy4tpu's ``fused_frontend_raw`` in interpret mode
    (float32 ``mm_dtype``, as tests/test_frontend_pallas.py runs it): C = 2,
    mode 0's taps, 256 outputs."""
    args = _case(3, 2, 256, 10)
    got = _host_run(host_rf, fc._PAIRS, args, 10)
    ref = frontend_pallas.fused_frontend_raw(
        *(jnp.asarray(a.numpy()) for a in args), 10, mm_dtype=jnp.float32,
        interpret=True)
    _check(got, tuple(torch.from_numpy(np.array(r)) for r in ref), args,
           10)


# ---- 3. csrc/frontend.cu (B1) on the host ----

@pytest.fixture(scope="module")
def host_b1(tmp_path_factory):
    """``csrc/frontend.cu`` built for the host: B1's and B6's entry
    points (``cuda_host.build_frontend``)."""
    return cuda_host.build_frontend(tmp_path_factory.mktemp("b1_host"))


@pytest.mark.parametrize("mode,rds", [(0, True), (1, False)])
def test_host_b11_is_b1_bit_for_bit(host_rf, host_b1, mode, rds):
    """B1 and B11 on the same block and RF state: B11's fm[m - Kb/2] is
    B1's fm_delayed[m], and prev_i/prev_q and iq_tail are B1's, bit for
    bit (one RF stage, one demod)."""
    cfg = MODES[mode]
    c, n_out, decim = 2, 2 * fc.TILE + 60, cfg.rf_decim
    u8, h, tail, pi, pq = _case(mode + 40, c, n_out, decim)
    p = rx.make_params(MODES[0], device="cpu")
    kb = p.bank_coeff.shape[-1]
    rng = np.random.default_rng(mode)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * 0.1).astype(np.float32))
    bands = (f(c, kb - 1), f(c, kb // 2), f(c, kb - 1), f(c, kb // 2))
    ins = (u8, h, p.bank_coeff, p.rds_carrier_coeff, tail, pi, pq, *bands)
    new = lambda *s: torch.full(s, float("nan"))  # noqa: E731
    outs = [new(c, n_out) for _ in range(5)] + [
        new(c, 2, 100), new(c), new(c), new(c, kb - 1), new(c, kb // 2),
        new(c, kb - 1), new(c, kb // 2)]
    plan = fc._tile_plan(n_out, decim, 101, kb, rds)
    assert host_b1.dy4_frontend_full(
        *(a.data_ptr() for a in ins), *(o.data_ptr() for o in outs), c,
        u8.shape[1], decim, 101, kb, int(rds), 0, plan.tile, plan.sub,
        None) == 0
    b11 = _host_run(host_rf, fc._PAIRS, (u8, h, tail, pi, pq), decim)
    dly = kb // 2
    assert torch.equal(b11[0][:, :n_out - dly], outs[0][:, dly:])
    for a, b in zip(b11[1:], outs[5:8]):
        assert torch.equal(a, b)
    # and B1 itself within its bar of its plain version
    plain = fc.fused_frontend_full_plain(*ins, decim, rds=rds)
    assert float((outs[0] - plain[0]).abs().max()) <= 1e-5


def _band_case(mode: int, rds: bool):
    """B1's inputs over two tiles and a short last one (as above), the
    band tails random: ``(ins, c, n_out, decim, kb)``."""
    cfg = MODES[mode]
    c, n_out, decim = 2, 2 * fc.TILE + 60, cfg.rf_decim
    u8, h, tail, pi, pq = _case(mode + 50, c, n_out, decim)
    p = rx.make_params(MODES[0], device="cpu")
    kb = p.bank_coeff.shape[-1]
    rng = np.random.default_rng(mode + 7)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * 0.1).astype(np.float32))
    bands = (f(c, kb - 1), f(c, kb // 2), f(c, kb - 1), f(c, kb // 2))
    return ((u8, h, p.bank_coeff, p.rds_carrier_coeff, tail, pi, pq, *bands),
            c, n_out, decim, kb)


def _held_band_stage(outs, ins, fm, kb, rds):
    """The band stage of B1 / B6 at bf16 against its plain version fed the
    kernel's own float32 fm (and, for the carrier, its own RDS band), so
    that no bf16 rounding flips between the two: the streams within 1e-5,
    the tails that copy the kernel's streams exact.  ``outs``: the
    kernel's fm_delayed, pilot, stereo, carrier, rds_delayed and its new
    bank_tail, mono_delay, carrier_tail, rds_delay; ``ins``: the taps and
    the old band tails; ``fm``: the kernel's fm."""
    from dy4tpu_torch.ops import fir, precision
    h_bank, h_c, bank_tail, mono_delay, carrier_tail, rds_delay = ins
    fmd, pilot, stereo, carrier, rdsdel, bt, md, ct, rdl = outs
    dly = kb // 2
    assert torch.equal(fmd[:, :dly], mono_delay)
    want = fc.band_stages_plain(fm, h_bank, h_c, bank_tail, mono_delay,
                                carrier_tail, rds_delay, rds=rds,
                                precision="default")
    for got, w in ((pilot, want[1]), (stereo, want[2])):
        assert float((got - w).abs().max()) <= TOL_BAND
    assert torch.equal(bt, want[5])
    if not rds:
        return
    assert torch.equal(rdsdel[:, :dly], rds_delay)
    band = torch.cat([rdsdel[:, dly:], rdl], -1)       # the kernel's
    assert float((band - torch.cat([want[4][:, dly:], want[8]], -1))
                 .abs().max()) <= TOL_BAND
    sq = band * band
    want_c, _ = fir.block_fir(precision.bf16(sq), precision.bf16(h_c),
                              precision.bf16(carrier_tail))
    assert float((carrier - want_c).abs().max()) <= TOL_BAND
    assert torch.equal(ct, sq[:, -(kb - 1):])


TOL_BAND = 1e-5


@pytest.mark.parametrize("mode,rds", [(0, True), (1, False)])
def test_host_b1_b6_bf16_band_stage(host_b1, mode, rds):
    """B1 and B6 at bf16 (precision "default"), the wrapper's rounded taps:
    B1's fm at the RF stage's bar (``_check``: its I/Q are the float32
    stage's on rounded taps) and its RF tail exact, and both kernels' band
    stages held to the plain band stage on their own fm
    (``_held_band_stage``), over two tiles and a short last one, each
    tile's halo rounded as its own tile rounds it."""
    from dy4tpu_torch.ops import demod, precision
    ins, c, n_out, decim, kb = _band_case(mode, rds)
    rt = [precision.taps(t, "default") for t in ins[1:4]]
    new = lambda *s: torch.full(s, float("nan"))  # noqa: E731
    outs = [new(c, n_out) for _ in range(5)] + [
        new(c, 2, 100), new(c), new(c), new(c, kb - 1), new(c, kb // 2),
        new(c, kb - 1), new(c, kb // 2)]
    plan = fc._tile_plan(n_out, decim, 101, kb, rds, bf16=True)
    assert plan.n_tiles == 3
    assert host_b1.dy4_frontend_full(
        *(a.data_ptr() for a in (ins[0], *rt, *ins[4:])),
        *(o.data_ptr() for o in outs), c, ins[0].shape[1], decim, 101, kb,
        int(rds), 1, plan.tile, plan.sub, None) == 0
    plain = fc.fused_frontend_full_plain(*ins, decim, rds=rds,
                                         precision="default")
    dly = kb // 2
    fm = torch.cat([outs[0][:, dly:], outs[9]], -1)
    fm_p = torch.cat([plain[0][:, dly:], plain[9]], -1)
    _check((fm, outs[5], outs[6], outs[7]), (fm_p, *plain[5:8]),
           (ins[0], rt[0], ins[4]), decim)
    sel = [0, 1, 2, 3, 4, 8, 9, 10, 11]
    band_ins = (ins[2], ins[3], *ins[7:])
    _held_band_stage([outs[k] for k in sel], band_ins, fm, kb, rds)

    # B6 on the I/Q of the same block by the plain RF LPF
    i_if, q_if, _ = fc.rf_lpf_plain(ins[0], ins[1], ins[4], decim)
    i_if, q_if = i_if.contiguous(), q_if.contiguous()
    iouts = [new(c, n_out) for _ in range(5)] + [
        new(c), new(c), new(c, kb - 1), new(c, kb // 2), new(c, kb - 1),
        new(c, kb // 2)]
    assert host_b1.dy4_frontend_if(
        *(a.data_ptr() for a in (i_if, q_if, rt[1], rt[2], ins[5], ins[6],
                                  *ins[7:])),
        *(o.data_ptr() for o in iouts), c, n_out, kb, int(rds), 1,
        fc._tile_plan(n_out, 1, 0, kb, rds, bf16=True).tile, None) == 0
    fm_p, pi, pq = demod.fm_demod_diff(i_if, q_if, ins[5], ins[6])
    assert torch.equal(iouts[5], pi) and torch.equal(iouts[6], pq)
    fm = torch.cat([iouts[0][:, dly:], iouts[8]], -1)
    live = i_if * i_if + q_if * q_if > AB_POWER
    assert float((fm - fm_p).abs()[live].max()) <= AB_TOL
    _held_band_stage([iouts[k] for k in (0, 1, 2, 3, 4, 7, 8, 9, 10)],
                     band_ins, fm, kb, rds)


# ---- 4. the tensor-core design (precision "default") on the host ----

_HARNESS = r"""
#include "mma_bf16.cuh"
// every lane's B fragment of the Toeplitz product through `taps` taps h
// at decimation `decim`, k-steps [0, ks), in the quad layout or not:
// out[(32 kk + lane) * 2 + i]
extern "C" void toeplitz_frags(const float* h, int taps, int decim, int ks,
                               int quad, unsigned* out) {
  for (int kk = 0; kk < ks; ++kk)
    for (int lane = 0; lane < 32; ++lane) {
      auto tap = [&](int a) { return h[a]; };
      const uint2 b =
          quad ? tc::toeplitz_frag<true>(tap, taps, decim, kk, lane)
               : tc::toeplitz_frag<false>(tap, taps, decim, kk, lane);
      out[2 * (32 * kk + lane)] = b.x;
      out[2 * (32 * kk + lane) + 1] = b.y;
    }
}
// one warp: a [16, 16] bf16 tile (rows `stride` apart) through ldsm_x4,
// times b [16, 8] bf16 (each lane's fragment from the PTX layout), into
// d [16, 8] float32; a's fragments out as regs [32, 4]
static void warp_mma(const uint16_t* a, int stride, const uint16_t* b,
                     float* d, unsigned* regs) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  unsigned r[4];
  tc::ldsm_x4(r, a + tc::ldsm_row(lane, stride));
  for (int i = 0; i < 4; ++i) regs[4 * lane + i] = r[i];
  auto bb = [&](int k) { return unsigned(b[8 * k + g]); };
  const uint2 bf = make_uint2(bb(2 * t) | bb(2 * t + 1) << 16,
                              bb(2 * t + 8) | bb(2 * t + 9) << 16);
  float acc[4] = {d[8 * g + 2 * t], d[8 * g + 2 * t + 1],
                  d[8 * (g + 8) + 2 * t], d[8 * (g + 8) + 2 * t + 1]};
  tc::mma(acc, r, bf);
  d[8 * g + 2 * t] = acc[0];
  d[8 * g + 2 * t + 1] = acc[1];
  d[8 * (g + 8) + 2 * t] = acc[2];
  d[8 * (g + 8) + 2 * t + 1] = acc[3];
}
extern "C" void one_mma(const uint16_t* a, int stride, const uint16_t* b,
                        float* d, unsigned* regs) {
  emulate(warp_mma, 1, 32, 0, a, stride, b, d, regs);
}
// u8_leg_pair of every word in w: out[2 j + leg]
extern "C" void leg_pairs(const unsigned* w, int n, unsigned* out) {
  for (int j = 0; j < n; ++j)
    for (int leg = 0; leg < 2; ++leg)
      out[2 * j + leg] = tc::u8_leg_pair(w[j], leg);
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """``csrc/mma_bf16.cuh`` alone, built for the host with the shim's
    warp exchange."""
    so = cuda_host.build(tmp_path_factory.mktemp("mma_host"),
                         "libmma_host.so",
                         {"mma_bf16.cuh": cuda_host.mma_header(),
                          "harness.cpp": '#include "shim.h"\n' + _HARNESS})
    p = ctypes.c_void_p
    so.toeplitz_frags.argtypes = [p] + [ctypes.c_int] * 4 + [p]
    so.one_mma.argtypes = [p, ctypes.c_int, p, p, p]
    so.leg_pairs.argtypes = [p, ctypes.c_int, p]
    return so


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bits, round to nearest even (as torch)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return (t.to(torch.bfloat16).view(torch.int16).numpy()
            .astype(np.uint16))


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("quad", [False, True], ids=["bank", "rf quad"])
@pytest.mark.parametrize("taps,decim", [(101, 10), (101, 5), (101, 1),
                                        (50, 3)])
def test_toeplitz_fragments_hold_the_band(harness, taps, decim, quad):
    """Each lane's B fragment at k-step kk holds H[j][n] = h[j - n*D]
    (bf16, zero off the band) at n = g and j = 16 kk + 2t (+1, +8, +9),
    or in the RF stage's quad layout j = 16 kk + 4t (+1, +2, +3): the
    numpy matrix, entry by entry, and its product with a window row is
    the decimating FIR's 8 outputs."""
    rng = np.random.default_rng(taps + decim)
    h = (rng.standard_normal(taps) * 0.1).astype(np.float32)
    ks = -(-(7 * decim + taps) // 16)
    out = np.zeros((ks, 32, 2), np.uint32)
    harness.toeplitz_frags(h.ctypes.data, taps, decim, ks, int(quad),
                           out.ctypes.data)
    hb = _bf16_bits(h)
    want = np.zeros((16 * ks, 8), np.uint16)          # H[j][n], bf16 bits
    for n in range(8):
        want[n * decim:n * decim + taps, n] = hb
    for kk in range(ks):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            j = 16 * kk + (4 if quad else 2) * t
            hi = 2 if quad else 8
            for reg, js in ((0, (j, j + 1)), (1, (j + hi, j + hi + 1))):
                got = out[kk, lane, reg]
                assert got & 0xFFFF == want[js[0], g]
                assert got >> 16 == want[js[1], g]
    x = rng.standard_normal(16 * ks)
    y = x @ _bf16_value(want).astype(np.float64)
    ref = [float(np.dot(_bf16_value(hb).astype(np.float64),
                        x[n * decim:n * decim + taps])) for n in range(8)]
    np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-12)


def test_host_mma_and_ldmatrix_follow_the_ptx_layout(harness):
    """The shim's ldmatrix (each lane at ``tc::ldsm_row``) and mma.sync
    against numpy: the A fragments hold the tile's pairs where the PTX
    layout puts them (a0 row g, a1 row g+8, a2 / a3 columns 8 on), and D
    = C + A B."""
    rng = np.random.default_rng(9)
    stride = 24                                       # rows 48 bytes apart
    buf = _bf16_bits(rng.standard_normal(16 * stride + 8))
    tile = buf[(np.arange(16)[:, None] * stride + np.arange(16))]
    b = _bf16_bits(rng.standard_normal((16, 8)))
    d = rng.standard_normal((16, 8)).astype(np.float32)
    want = d.astype(np.float64) + (_bf16_value(tile).astype(np.float64)
                                   @ _bf16_value(b))
    regs = np.zeros((32, 4), np.uint32)
    harness.one_mma(buf.ctypes.data, stride, b.ctypes.data, d.ctypes.data,
                    regs.ctypes.data)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                        (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            assert regs[lane, i] == tile[row, col] | (
                np.uint32(tile[row, col + 1]) << 16)
    np.testing.assert_allclose(d, want, rtol=1e-6, atol=1e-6)


def test_u8_leg_pairs_are_exact(harness):
    """``tc::u8_leg_pair``: bytes 0, 2 (I) and 1, 3 (Q) of a word as the
    bf16 pair (b - 128), for every byte value."""
    b = np.arange(256, dtype=np.uint32)
    w = b | (b[::-1] << 8) | (((b + 7) % 256) << 16) | (((b * 5) % 256) << 24)
    out = np.zeros((256, 2), np.uint32)
    harness.leg_pairs(w.ctypes.data, 256, out.ctypes.data)
    for leg in range(2):
        lo = (w >> (8 * leg)) & 0xFF
        hi = (w >> (8 * (leg + 2))) & 0xFF
        assert (_bf16_value((out[:, leg] & 0xFFFF).astype(np.uint16))
                == lo.astype(np.float32) - 128).all()
        assert (_bf16_value((out[:, leg] >> 16).astype(np.uint16))
                == hi.astype(np.float32) - 128).all()


def _tc_full(host, ins, decim, rds, plan=None, corr=None, status=0):
    """One launch of B1's host build at bf16 (``ins``: the eleven tensors
    of ``fused_frontend_full``, the taps unrounded, as the wrapper passes
    them: the kernel rounds them; ``corr`` [C, 4] selects the corr entry)
    under ``plan`` (the wrapper's by default): the twelve outputs (and
    ``mom``), filled with NaN before."""
    u8, h = ins[0], ins[1]
    c, bs = u8.shape
    k, kb = h.shape[0], ins[2].shape[-1]
    n_out = bs // 2 // decim
    if plan is None:
        plan = fc._tile_plan(n_out, decim, k, kb, rds, bf16=True)
    nan = lambda *s: torch.full(s, float("nan"))  # noqa: E731
    outs = [nan(c, n_out) for _ in range(5)] + [
        nan(c, 2, k - 1), nan(c), nan(c), nan(c, kb - 1), nan(c, kb // 2),
        nan(c, kb - 1), nan(c, kb // 2)]
    ptrs = [a.data_ptr() for a in ins] + [o.data_ptr() for o in outs]
    if corr is None:
        got = host.dy4_frontend_full(*ptrs, c, bs, decim, k, kb, int(rds), 1,
                                     plan.tile, plan.sub, None)
    else:
        mom = nan(c, fc.MOMENTS)
        partial = nan(c, plan.n_tiles, fc.MOMENTS)
        count = torch.zeros(c, dtype=torch.int32)
        got = host.dy4_frontend_full_corr(
            *ptrs, corr.data_ptr(), mom.data_ptr(), partial.data_ptr(),
            count.data_ptr(), c, bs, decim, k, kb, int(rds), 1, plan.tile,
            plan.sub, None)
        outs.append(mom)
    assert got == status
    return outs


def _tc_ins(seed: int, c: int, n_out: int, decim: int):
    """B1's eleven tensors: ``_case``'s signal, mode 0's RF taps and
    random RF state, mode 0's bank and carrier taps, random band tails."""
    u8, h, tail, pi, pq = _case(seed, c, n_out, decim)
    p = rx.make_params(MODES[0], device="cpu")
    kb = p.bank_coeff.shape[-1]
    rng = np.random.default_rng(seed + 1)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * 0.1).astype(np.float32))
    return (u8, h, p.bank_coeff, p.rds_carrier_coeff, tail, pi, pq,
            f(c, kb - 1), f(c, kb // 2), f(c, kb - 1), f(c, kb // 2))


def _held_tc(outs, ins, decim, rds):
    """B1 at bf16 against the plain version at "default": ``_check``'s
    bars on fm, the RF tail and prev (the card's), fm within 1e-5 where
    the power is above 0.1 (the host's MMA sums in k order, so only
    float32 rounding stays), the band stage on its own fm
    (``_held_band_stage``), no output left unwritten."""
    from dy4tpu_torch.ops import precision
    kb = ins[2].shape[-1]
    dly = kb // 2
    plain = fc.fused_frontend_full_plain(*ins, decim, rds=rds,
                                         precision="default")
    fm = torch.cat([outs[0][:, dly:], outs[9]], -1)
    fm_p = torch.cat([plain[0][:, dly:], plain[9]], -1)
    rt = precision.taps(ins[1], "default")
    _check((fm, *outs[5:8]), (fm_p, *plain[5:8]), (ins[0], rt, ins[4]),
           decim)
    i_ds, q_ds, _ = fc.rf_lpf_plain(ins[0], rt, ins[4], decim)
    strong = i_ds * i_ds + q_ds * q_ds > 0.1
    assert float((fm - fm_p).abs()[strong].max()) <= 1e-5
    sel = [0, 1, 2, 3, 4, 8, 9, 10, 11] if rds else [0, 1, 2, 8, 9]
    for k in sel:
        assert not bool(outs[k].isnan().any()), k
    if rds:
        _held_band_stage([outs[k] for k in sel], (ins[2], ins[3], *ins[7:]),
                         fm, kb, rds)
    else:
        got = [outs[0], outs[1], outs[2], None, None, outs[8], outs[9], None,
               None]
        _held_band_stage(got, (ins[2], None, ins[7], ins[8], None, None), fm,
                         kb, rds)
    return plain


TC_CASES = [("mode0", 2, MODES[0].if_per_block, 10),
            ("mode1", 2, MODES[1].if_per_block, 5),
            ("C=1", 1, 700, 10), ("C=37", 37, 256, 5),
            # D = 5 and an odd sample count a row: every other row starts
            # 2 bytes off a word (the funnel shift)
            ("last tile short", 2, 2 * fc.TILE + 37, 5),
            ("one tile", 3, 150, 10)]


@pytest.mark.parametrize("rds", [True, False], ids=["rds", "no rds"])
@pytest.mark.parametrize("label,c,n_out,decim", TC_CASES,
                         ids=[t[0] for t in TC_CASES])
def test_host_b1_tensor_cores(host_b1, label, c, n_out, decim, rds):
    """B1 at "default" on the tensor-core design (the shim's mma.sync,
    ldmatrix and cp.async) against the plain version (``_held_tc``); at
    modes 0 and 1 also bit for bit under a second plan (tiles of 1024,
    RF passes of 256: a recomputed halo sample is its own tile's)."""
    ins = _tc_ins(n_out + decim, c, n_out, decim)
    outs = _tc_full(host_b1, ins, decim, rds)
    _held_tc(outs, ins, decim, rds)
    if label in ("mode0", "mode1"):
        own = fc._tile_plan(n_out, decim, 101, 101, rds, bf16=True)
        other = own._replace(tile=1024, n_tiles=-(-n_out // 1024), sub=256)
        again = _tc_full(host_b1, ins, decim, rds, other)
        for k, (a, b) in enumerate(zip(outs, again)):
            assert torch.equal(a, b) or not rds and k in (3, 4, 10, 11)


@pytest.mark.parametrize("mode", [0, 1])
def test_host_b1_corr_tensor_cores(host_b1, mode):
    """B1-corr at "default": the 14 moments of the I/Q before the
    correction within MOM_TOL of E[|i|^p |q|^r] (``chip_smoke.py``'s bar)
    of the plain version's, and the corrected stream's fm and band stage
    as ``_held_tc`` holds B1's."""
    from dy4tpu_torch.ops import precision
    cfg = MODES[mode]
    rds = cfg.supports_rds
    n_out, decim = 2 * fc.TILE + 60, cfg.rf_decim
    ins = _tc_ins(mode + 70, 2, n_out, decim)
    g = np.random.default_rng(mode)
    corr = torch.from_numpy(np.stack(
        [g.uniform(-0.05, 0.05, 2), g.uniform(-0.05, 0.05, 2),
         g.uniform(-0.2, 0.2, 2), g.uniform(0.8, 1.2, 2)],
        axis=-1).astype(np.float32))
    outs = _tc_full(host_b1, ins, decim, rds, corr=corr)
    i_ds, q_ds, _ = fc.rf_lpf_plain(ins[0], precision.taps(ins[1], "default"),
                                    ins[4], decim)
    want = fc.fused_frontend_full_plain(*ins, decim, rds=rds, corr=corr,
                                        precision="default")
    scale = torch.stack([(i_ds.double().abs() ** p
                          * q_ds.double().abs() ** r).mean(-1)
                         for p, r in iqcorr._POWERS], -1)
    rel = ((outs[12].double() - want[12].double()).abs() / scale).max()
    assert float(rel) <= MOM_TOL
    kb = ins[2].shape[-1]
    dly = kb // 2
    fm = torch.cat([outs[0][:, dly:], outs[9]], -1)
    fm_p = torch.cat([want[0][:, dly:], want[9]], -1)
    i_c = i_ds - corr[:, :1]
    q_c = (q_ds - corr[:, 1:2] - corr[:, 2:3] * i_c) * corr[:, 3:]
    live = i_c * i_c + q_c * q_c > AB_POWER
    assert float((fm - fm_p).abs()[live].max()) <= AB_TOL
    assert torch.equal(outs[5], want[5])
    for a, b in zip(outs[6:8], want[6:8]):
        assert float((a - b).abs().max()) <= PREV_TOL


B6_CASES = [("mode0", 2, MODES[0].if_per_block, True),
            ("mode1", 2, MODES[1].if_per_block, False),
            ("ragged", 3, 2 * fc.TILE + 60, True), ("C=1", 1, 700, False)]


@pytest.mark.parametrize("label,c,n,rds", B6_CASES,
                         ids=[t[0] for t in B6_CASES])
def test_host_b6_tensor_cores(host_b1, label, c, n, rds):
    """B6 at "default" on the tensor-core band stage (the taps unrounded,
    as the wrapper passes them): prev_i / prev_q exact, fm (its demod)
    within AB_TOL where live, the band stage on its own fm
    (``_held_band_stage``), nothing left unwritten."""
    from dy4tpu_torch.ops import demod
    ins = _tc_ins(c + n, c, n, 10)
    i_if, q_if, _ = fc.rf_lpf_plain(ins[0], ins[1], ins[4], 10)
    i_if, q_if = i_if.contiguous(), q_if.contiguous()
    kb = ins[2].shape[-1]
    nan = lambda *s: torch.full(s, float("nan"))  # noqa: E731
    outs = [nan(c, n) for _ in range(5)] + [
        nan(c), nan(c), nan(c, kb - 1), nan(c, kb // 2), nan(c, kb - 1),
        nan(c, kb // 2)]
    assert host_b1.dy4_frontend_if(
        *(a.data_ptr() for a in (i_if, q_if, *ins[2:4], ins[5], ins[6],
                                  *ins[7:])),
        *(o.data_ptr() for o in outs), c, n, kb, int(rds), 1,
        fc._tile_plan(n, 1, 0, kb, rds, bf16=True).tile, None) == 0
    fm_p, pi, pq = demod.fm_demod_diff(i_if, q_if, ins[5], ins[6])
    assert torch.equal(outs[5], pi) and torch.equal(outs[6], pq)
    dly = kb // 2
    fm = torch.cat([outs[0][:, dly:], outs[8]], -1)
    live = i_if * i_if + q_if * q_if > AB_POWER
    assert float((fm - fm_p).abs()[live].max()) <= AB_TOL
    sel = (0, 1, 2, 3, 4, 7, 8, 9, 10) if rds else (0, 1, 2, 7, 8)
    for k in sel:
        assert not bool(outs[k].isnan().any()), k
    got = [outs[k] for k in (0, 1, 2, 3, 4, 7, 8, 9, 10)]
    band = (ins[2], ins[3], *ins[7:]) if rds else (
        ins[2], None, ins[7], ins[8], None, None)
    _held_band_stage(got, band, fm, kb, rds)


def test_host_b1_tensor_cores_refuses_what_it_cannot_run(host_b1):
    """RF passes that are not whole MMA units, a tile not in rows of 8:
    refused (cudaErrorInvalidValue), nothing written."""
    ins = _tc_ins(1, 2, 700, 10)
    plan = fc._tile_plan(700, 10, 101, 101, True, bf16=True)
    for bad in (plan._replace(sub=100), plan._replace(tile=plan.tile - 4)):
        outs = _tc_full(host_b1, ins, 10, True, bad, status=1)
        assert all(bool(o.isnan().all()) for o in outs[:5])

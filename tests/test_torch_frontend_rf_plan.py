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
   delay), with and without RDS.
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
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.runtime import kernels  # noqa: E402

AB_TOL, AB_POWER, PREV_TOL = 1e-3, 1e-3, 1e-5
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


def _header() -> str:
    return cuda_host.rewrite((kernels.CSRC / "rf_stage.cuh").read_text(),
                             "csrc/rf_stage.cuh", _COMMON)


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
                         {"rf_stage.cuh": _header(),
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

# the corr epilogue's device calls, compiled but not run here
_CORR_STUBS = """
inline float __shfl_down_sync(unsigned, float v, int) { return v; }
inline int atomicAdd(int* p, int v) { const int o = *p; *p += v; return o; }
inline void __threadfence() {}
inline float __ldcg(const float* p) { return *p; }
inline cudaError_t cudaMemsetAsync(void*, int, size_t, cudaStream_t) {
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_b1(tmp_path_factory):
    """``csrc/frontend.cu`` built for the host: B1's entry point."""
    launch = (r"frontend_full_kernel<kRds, kCorr, kBf16><<<grid, kThreads, "
              r"smem, stream>>>\((.*?)\);",
              r"emulate(frontend_full_kernel<kRds, kCorr, kBf16>, grid, "
              r"kThreads, smem, \1);")
    launch_if = (r"frontend_if_kernel<kRds, kBf16><<<grid, kThreads, smem, "
                 r"stream>>>\((.*?)\);",
                 r"emulate(frontend_if_kernel<kRds, kBf16>, grid, kThreads, "
                 r"smem, \1);")
    src = cuda_host.rewrite(
        (kernels.CSRC / "frontend.cu").read_text(), "csrc/frontend.cu",
        ((r'#include "rf_stage\.cuh"', '#include "rf_stage.cuh"\n'
          + _CORR_STUBS), _SMEM, launch, launch_if) + _COMMON)
    so = cuda_host.build(tmp_path_factory.mktemp("b1_host"), "libb1_host.so",
                         {"rf_stage.cuh": _header(), "frontend.cpp": src})
    for name, args in (("dy4_frontend_full", fc._ARGS),
                       ("dy4_frontend_if", fc._IF_ARGS)):
        getattr(so, name).argtypes = args
        getattr(so, name).restype = ctypes.c_int
    return so


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
    plan = fc._tile_plan(n_out, decim, 101, kb, rds)
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
        fc._tile_plan(n_out, 1, 0, kb, rds).tile, None) == 0
    fm_p, pi, pq = demod.fm_demod_diff(i_if, q_if, ins[5], ins[6])
    assert torch.equal(iouts[5], pi) and torch.equal(iouts[6], pq)
    fm = torch.cat([iouts[0][:, dly:], iouts[8]], -1)
    live = i_if * i_if + q_if * q_if > AB_POWER
    assert float((fm - fm_p).abs()[live].max()) <= AB_TOL
    _held_band_stage([iouts[k] for k in (0, 1, 2, 3, 4, 7, 8, 9, 10)],
                     band_ins, fm, kb, rds)

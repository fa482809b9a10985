"""B3 / B4 / B5's tensor-core design (``csrc/rational_tc.cuh``, precision
"default" / "high") on the CPU.

At dy4tpu's ``mm_dtype=bf16`` the polyphase resampler is one banded matrix
of a phase cycle's taps, H[j][p], applied to every cycle of every stream
as bf16 ``mma.sync`` products with float32 sums (B4's RRC a decim-1
Toeplitz product after it); at U = 1 a cycle is 8 consecutive outputs.
The kernels run only on the card, where ``chip_smoke.py`` phase 12 holds
them to their plain versions.  Here:

1. the cycle matrix's fragments (``resample_cuda._tc_groups``'s geometry,
   the PTX m16n8k16 B layout, the kernel's scatter of each tap) at 19/120,
   171/640, 147/800, 147/1280 and U = 1 with D = 5 and 8: every tap of
   every position exactly once, at its place, zeros elsewhere, and every
   group's window aligned for ldmatrix;
2. ``csrc/rds_backend.cu`` and ``csrc/audio_rational.cu`` with
   ``rational_tc.cuh`` built for the host through ``cuda_host.py``'s shim
   (``MMA_REWRITES``: the warp's ``mma.sync`` and ``ldmatrix`` exchanged
   through a barrier of its 32 threads), at 3 rows: against the plain
   version at "default" (B3 / B5 within 1e-5, their tails exact; B4 at
   most 0.5% of its baseband past 1e-5, each within 1e-5 + 2^-8 max|y|
   sum|h_rrc|, its LPF tails exact, its RRC tails within 1e-5), the same
   bits under a second plan (row groups of 2, other tiles, three compute
   warps) and with inputs and taps off 16-byte alignment (the 4-byte
   paths), plans it cannot run refused, and against dy4tpu's own bf16
   Pallas kernels in interpret mode at ``tests/test_torch_precision.py``'s
   bars and flip bound.
"""

import ctypes
import math
from types import SimpleNamespace

import cuda_host
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.ops import backend_pallas, resample_pallas  # noqa: E402
from dy4tpu_torch.config import MODES  # noqa: E402
from dy4tpu_torch.ops import fir, firdes, precision  # noqa: E402
from dy4tpu_torch.ops import resample_cuda as rc  # noqa: E402

ROWS = 3
BAR = 1e-5            # float32 noise: the sums run in other orders
SHARE = 0.005         # of an output's samples allowed past BAR (flips)
STEP = 2.0 ** -8      # a bf16 rounding step, relative

# (label, U, D, K): the cycle matrices of every rate the port runs
RATES = [("19/120", 19, 120, 1919), ("171/640", 171, 640, 17271),
         ("147/800", 147, 800, 14847), ("147/1280", 147, 1280, 14847),
         ("U=1 D=5", 1, 5, 101), ("U=1 D=8", 1, 8, 101)]
# (kernel, mode): B4 at modes 0 and 2, B3 at modes 0 and 1, B5 at 2 and 3
CASES = [("B4", 0), ("B4", 2), ("B3", 0), ("B3", 1), ("B5", 2), ("B5", 3)]
IDS = [f"{w}-mode{m}" for w, m in CASES]


# ---- 1. the cycle matrix's fragments ----

def _defined(up, down, k, g, kk, lane, half, geo):
    """The tap index fragment (group g, k-step kk) of lane ``lane`` holds
    in its ``half``-th bf16 (b0 low, b0 high, b1 low, b1 high: k 2t, 2t+1,
    2t+8, 2t+9 of column lane >> 2, t = lane & 3) by the definition
    H[j][p] = h[r_p + (b_p + S - j)*U]; -1 where H is 0."""
    span, step, starts, _, _, _, _ = geo
    s = (k - 1) // up
    p = 8 * g + (lane >> 2)
    kin = 16 * kk + 2 * (lane & 3) + (8 if half >= 2 else 0) + (half & 1)
    t = p * step // span + s - (starts[g] + kin)
    tap = (p * down) % up + t * up
    return tap if p < span and 0 <= t <= s and tap < k else -1


@pytest.mark.parametrize("label,up,down,k", RATES,
                         ids=[r[0] for r in RATES])
def test_fragments_hold_every_tap_once(label, up, down, k):
    geo = rc._tc_groups(up, down, (k - 1) // up)
    span, step, starts, ks, lead, reach, pad = geo
    s = (k - 1) // up
    groups = len(starts)
    # the kernel's scatter: tap i into its slot (group, k-step, lane, half)
    # of each position that takes it
    filled = np.full((groups, ks, 32, 4), -1, np.int64)
    taken = np.zeros((span, s + 1), np.int64)
    dinv = pow(down, -1, up) if up > 1 else 0
    for i in range(k):
        t, r = divmod(i, up)
        for p in range((r * dinv) % up if up > 1 else 0, span, up):
            g = p >> 3
            kin = p * step // span + s - t - starts[g]
            assert 0 <= kin < 16 * ks, (label, i, p)
            slot = (g, kin >> 4, 4 * (p & 7) + ((kin & 7) >> 1),
                    ((kin & 8) >> 2) + (kin & 1))
            assert filled[slot] == -1, (label, i, p)
            filled[slot] = i
            taken[p, t] += 1
    want = np.array([[[[_defined(up, down, k, g, kk, lane, half, geo)
                        for half in range(4)] for lane in range(32)]
                      for kk in range(ks)] for g in range(groups)])
    assert (filled == want).all(), label
    # every tap of every position exactly once (the taps past K none)
    for p in range(span):
        r = (p * down) % up
        for t in range(s + 1):
            assert taken[p, t] == (1 if r + t * up < k else 0), (p, t)
    # each group's window covers its positions' bands, and starts an A row
    # on a 16-byte boundary; the cycle rows' stride spreads ldmatrix's rows
    assert lead == -s % 8
    for g, j0 in enumerate(starts):
        last = min(8 * g + 7, span - 1)
        assert j0 <= 8 * g * step // span
        assert last * step // span + s < j0 + 16 * ks
        assert (j0 + lead) % 8 == 0 and j0 + lead >= 0
        assert j0 + lead + 16 * ks <= reach
    # an ldmatrix row (8 bf16 from a multiple of 8) never straddles a skew,
    # and the 8 rows of one, a cycle apart, fall on distinct banks
    assert step % 8 == 0 and pad == (0 if step % 16 else 8)
    assert (step + pad) % 16 == 8


# ---- 2. the kernels built for the host ----

@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """``rds_backend.cu`` and ``audio_rational.cu`` with ``rational.cuh``,
    ``rational_tc.cuh`` and ``mma_bf16.cuh`` built for the host: the
    tensor-core entry points."""
    so = cuda_host.build_rational(tmp_path_factory.mktemp("rational_tc"),
                                  "librational_tc_host.so",
                                  ("rds_backend", "audio_rational"))
    b4, b5 = so.dy4_rds_backend_tc, so.dy4_audio_rational_tc
    b4.argtypes, b5.argtypes = rc._TC_ARGS, rc._AUDIO_TC_ARGS
    b4.restype = b5.restype = ctypes.c_int
    return SimpleNamespace(B4=b4, B5=b5)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _case(which, mode, seed, c=ROWS):
    """Seeded numpy inputs of B3 / B4 / B5 at ``mode`` (the mode's taps),
    as numpy arrays, and the rate."""
    cfg = MODES[mode]
    rng = np.random.default_rng(seed)
    n = cfg.if_per_block
    if which == "B4":
        up, down = cfg.rds_up, cfg.rds_down
        h = firdes.lpf(cfg.if_fs * up, cfg.rds_fc, cfg.rds_taps,
                       up_factor=up)
        h2 = firdes.rrc(cfg.rds_fs, cfg.rds_rrc_taps, cfg.rds_symbol_rate)
        s, s2 = (cfg.rds_taps - 1) // up, cfg.rds_rrc_taps - 1
        args = [_f32(rng, c, n), _f32(rng, c, n), _f32(rng, c, n), h, h2,
                _f32(rng, c, s), _f32(rng, c, s), _f32(rng, c, s2),
                _f32(rng, c, s2)]
    else:
        up, down = cfg.audio_up, cfg.audio_down
        h = firdes.lpf(cfg.if_fs * up, cfg.audio_fc, cfg.audio_taps,
                       up_factor=up)
        s = (cfg.audio_taps - 1) // up
        args = [_f32(rng, c, n), _f32(rng, c, n), _f32(rng, c, n), h,
                _f32(rng, c, s), _f32(rng, c, s)]
    return [np.ascontiguousarray(a, np.float32) for a in args], up, down


def _plan(which, args, up, down, **pin):
    c, n = args[0].shape
    k2 = args[4].shape[0] if which == "B4" else 0
    return rc._tc_plan(c, n, up, down, args[3].shape[0], k2, **pin)


def _run(host, which, args, up, down, plan, compute_threads=64):
    """One launch of the host build under ``plan`` with ``compute_threads``
    and one copy warp (a thread of the block is a host thread here): the
    outputs the wrapper would return, filled."""
    plan = plan._replace(compute_threads=compute_threads,
                         threads=compute_threads + 32)
    targs = [torch.from_numpy(a) for a in args]
    c, n = targs[0].shape
    k = targs[3].shape[0]
    s, m = (k - 1) // up, n * up // down
    if which == "B4":
        k2 = targs[4].shape[0]
        shapes = ((c, m),) * 2 + ((c, s),) * 2 + ((c, k2 - 1),) * 2
        fn, geom = host.B4, (c, n, up, down, k, k2)
    else:
        shapes = ((c, m),) * 3 + ((c, s),) * 2
        fn, geom = host.B5, (c, n, up, down, k)
    outs = [torch.full(sh, math.nan) for sh in shapes]
    status = fn(*(t.data_ptr() for t in targs),
                *(t.data_ptr() for t in outs), *geom,
                *rc._tc_plan_args(plan, up, down), None)
    assert status == 0
    return outs


def _plain(which, args, up, down):
    targs = [torch.from_numpy(a) for a in args]
    if which == "B4":
        return rc.fused_rds_backend_plain(*targs, up, down, "default")
    return rc.fused_audio_backend_rational_plain(*targs, up, down,
                                                 "default")


def _rds_stream(args, up, down):
    """B4's resampled stream at "default" (both legs): the scale of the
    RRC's bf16 input."""
    t = [torch.from_numpy(a) for a in args]
    y, _ = fir.block_fir_resample(
        precision.bf16(torch.stack([t[1] * t[0], t[2] * t[0]])),
        precision.taps(t[3], "default"), precision.bf16(torch.stack(t[5:7])),
        up=up, down=down)
    return y


def _hold(which, got, want, args, up, down):
    """B3 / B5: within BAR, the tails exact.  B4: at most SHARE of the
    baseband past BAR, each within the RRC's flip bound; the LPF tails
    exact, the RRC tails within BAR."""
    if which != "B4":
        for i, (g, w) in enumerate(zip(got, want)):
            if i >= 3:
                assert torch.equal(g, w), i
            else:
                assert float((g.double() - w.double()).abs().max()) <= BAR, i
        return
    bound = BAR + STEP * float(_rds_stream(args, up, down).abs().max()) * \
        float(np.abs(args[4]).sum())
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g.double() - w.double()).abs()
        if i in (2, 3):
            assert torch.equal(g, w), i
        elif i < 2:
            assert float((err > BAR).double().mean()) <= SHARE, i
            assert float(err.max()) <= bound, (i, float(err.max()), bound)
        else:
            assert float(err.max()) <= BAR, i


@pytest.mark.parametrize("which,mode", CASES, ids=IDS)
def test_host_kernel_matches_rounded_plain(host, which, mode):
    args, up, down = _case(which, mode, 10 + mode)
    got = _run(host, which, args, up, down, _plan(which, args, up, down))
    _hold(which, got, _plain(which, args, up, down), args, up, down)


@pytest.mark.parametrize("which,mode", CASES, ids=IDS)
def test_host_kernel_two_plans_bitwise(host, which, mode):
    """The rule's plan and row groups of 2 (the last one short) with other
    tiles (B4: a recomputed halo) on three compute warps: the same bits,
    every output's k-steps fixed by its position group alone."""
    args, up, down = _case(which, mode, 30 + mode)
    own = _plan(which, args, up, down)
    other = _plan(which, args, up, down, rows=2, cycles=own.cycles - 2)
    assert other.rows != own.rows and other.cycles != own.cycles
    assert other.n_tiles > 1
    a = _run(host, which, args, up, down, own)
    b = _run(host, which, args, up, down, other, compute_threads=96)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _misaligned(a):
    """A contiguous copy of ``a`` 4 bytes off 16-byte alignment."""
    buf = np.empty(a.size + 4, np.float32)
    out = buf[1:1 + a.size].reshape(a.shape)
    out[...] = a
    return out


@pytest.mark.parametrize("which,mode", [("B4", 2), ("B5", 3)])
def test_host_kernel_misaligned_inputs(host, which, mode):
    """Inputs and taps off 16-byte alignment: the copy warps' 4-byte path
    and the taps' 4-byte scatter give the bits of the 16-byte ones."""
    args, up, down = _case(which, mode, 70 + mode, c=2)
    plan = _plan(which, args, up, down)
    want = _run(host, which, args, up, down, plan)
    moved = [_misaligned(a) for a in args]
    assert all(torch.from_numpy(a).data_ptr() % 16 for a in moved)
    got = _run(host, which, moved, up, down, plan)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["smem", "ks", "lead", "pad", "halo"])
def test_host_kernel_refuses_a_plan_it_cannot_run(host, bad):
    which, mode = ("B4", 2) if bad == "halo" else ("B5", 3)
    args, up, down = _case(which, mode, 0, c=2)
    plan = _plan(which, args, up, down, cycles=5 if which == "B4" else None)
    plan = {"smem": plan._replace(smem=plan.smem + 16),
            "ks": plan._replace(ks=plan.ks - 1),
            "lead": plan._replace(lead=(plan.lead + 1) % 8),
            "pad": plan._replace(pad=8 - plan.pad),
            "halo": plan._replace(halo=0)}[bad]
    targs = [torch.from_numpy(a) for a in args]
    c, n = targs[0].shape
    k = targs[3].shape[0]
    m, s = n * up // down, (k - 1) // up
    if which == "B4":
        k2 = targs[4].shape[0]
        outs = [torch.empty(sh) for sh in ((c, m),) * 2 + ((c, s),) * 2
                + ((c, k2 - 1),) * 2]
        geom, fn = (c, n, up, down, k, k2), host.B4
    else:
        outs = [torch.empty(sh) for sh in ((c, m),) * 3 + ((c, s),) * 2]
        geom, fn = (c, n, up, down, k), host.B5
    status = fn(*(t.data_ptr() for t in targs),
                *(t.data_ptr() for t in outs), *geom,
                *rc._tc_plan_args(plan, up, down), None)
    assert status == 1               # cudaErrorInvalidValue, no launch


def test_plan_refuses_rows_of_part_cycles():
    """A row at U = 1 must hold whole cycles of 8 outputs (8D inputs); a
    rate must be in lowest terms."""
    with pytest.raises(ValueError, match="whole cycles"):
        rc._tc_plan(2, 7680 - 20, 1, 5, 101, 0)
    with pytest.raises(ValueError):
        rc._tc_plan(2, 9600, 342, 1280, 17271, 101)


# ---- 3. against dy4tpu's bf16 Pallas kernels in interpret mode ----

def _dy4tpu(which, args, up, down):
    j = [jnp.asarray(a) for a in args]
    if which == "B4":
        return resample_pallas.fused_rds_backend(
            *j, up, down, mm_dtype=jnp.bfloat16, interpret=True)
    if up == 1:
        return backend_pallas.fused_audio_backend(
            *j, down, mm_dtype=jnp.bfloat16, interpret=True)
    return resample_pallas.fused_audio_backend_rational(
        *j, up, down, mm_dtype=jnp.bfloat16, interpret=True)


@pytest.mark.parametrize("which,mode", CASES, ids=IDS)
def test_host_kernel_matches_dy4tpu_bf16_kernel(host, which, mode):
    """The tails that copy an input exact; every other output within 1e-5
    on all but at most 0.5% of its samples, each of those within the flip
    bound 1e-5 + 2^-8 max|x| sum|h| of the kernel's rounded stages (B4:
    the mixed legs through h_lpf, the resampled stream through h_rrc)."""
    args, up, down = _case(which, mode, 50 + mode)
    ours = _run(host, which, args, up, down, _plan(which, args, up, down))
    theirs = _dy4tpu(which, args, up, down)
    h = np.abs(args[3]).sum()
    if which == "B4":
        mixed = max(np.abs(args[1] * args[0]).max(),
                    np.abs(args[2] * args[0]).max())
        bound = BAR + STEP * max(
            mixed * h, float(_rds_stream(args, up, down).abs().max())
            * np.abs(args[4]).sum())
        exact = (2, 3)
    else:
        mixed = np.abs(2.0 * args[1] * args[2]).max()
        bound = BAR + STEP * max(np.abs(args[0]).max(), mixed) * h
        exact = (3, 4)
    assert len(ours) == len(theirs)
    for i, (o, r) in enumerate(zip(ours, theirs)):
        err = np.abs(o.numpy().astype(np.float64) - np.asarray(r))
        assert err.shape == o.shape, i
        if i in exact:
            assert err.max() == 0.0, f"output {i}: not exact"
            continue
        beyond = float(np.mean(err > BAR))
        assert beyond <= SHARE, f"output {i}: {beyond:.4f} past {BAR:g}"
        assert err.max() <= bound, (i, err.max(), bound)

"""The PLL scans at the edges of ``csrc/pll.cu``'s tile loop, on the CPU.

B2, B8, B9 and B9-expand scan 128-step tiles from shared memory while data
warps copy the next tile in and store the last one; B8 cuts the tile that
holds ``split_at`` into two runs; a block of fewer than 32 rows masks the
rest.  The kernels run only on the card, where ``chip_smoke.py`` holds them
bitwise to their plain versions (phase 2: B2 and B9, phase 5: B8, phase 7:
B9-expand, each also at a ragged geometry).  Here:

1. the plain versions the card is held to, at the tile loop's edges,
   against dy4tpu's Pallas kernel in interpret mode, as
   tests/test_pll_pallas.py runs it: B8 at n in {1, 127, 129, 1531},
   ``split_at`` in {0, 128, a step strictly inside a tile, n} (where at most
   n), 1 or 37 rows, an INVALID run over step 128; the span scan
   (``emit_integ``) and its ``expand`` variant at m in {1, 129}, NaN spans
   over step 128.  Bars: B8 within test_torch_sharded.py's 2e-4; the span
   scans' phases and carries within 2e-5 (phases up to about 30 rad, where
   that is 10 float32 ulps; XLA may contract the step's multiply-adds, as
   test_torch_span.py says; measured 7.6e-6) and the pre-update integrator
   within 1e-6 (measured 6e-8).  At ``split_at = n`` dy4tpu's kernel hands
   back the input carry as the mid carry (its snapshot fires only at a
   chunk boundary below n), where dy4tpu's scan gives the carry after n
   samples, the end carry; the port keeps the scan's semantics, so the mid
   carry there is held to dy4tpu's end carry.
2. inside the port, bitwise: B8's plain version equals the per-sample scan
   on the samples its codes came from (the carry held across the INVALID
   run, its phase emitted), and the span scans split at step 128 and
   chained equal the whole scan.
3. ``csrc/pll.cu`` itself, built for the host by g++ through a shim (one
   ``std::thread`` per CUDA thread, a ``std::barrier`` for the named
   barrier, ``memcpy`` for ``cp.async``), bitwise against the plain
   versions at the same edges and at 37 rows (a block of 32 and one of 5):
   the tile loop's index arithmetic, the split runs, the masked lanes and
   both copy paths, without the card.
"""

import ctypes

import cuda_host
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.ops import pll as jpll  # noqa: E402
from dy4tpu.ops import pll_pallas  # noqa: E402
from dy4tpu_torch.ops import pll, pll_cuda  # noqa: E402
from dy4tpu_torch.runtime import kernels  # noqa: E402

FS = 240e3
SPAN = 8
F32 = np.dtype(np.float32)
INVALID_RUN = (100, 300)     # over the tile boundaries at 128 and 256
NAN_RUN = (120, 136)         # over the tile boundary at 128
INSIDE = {127: 70, 129: 70, 1531: 1000}   # strictly inside a tile


def _lanes(rows):
    """Per-row loop configurations, so no two rows are equal."""
    return (np.linspace(18.5e3, 19.5e3, rows).astype(np.float32),
            np.full(rows, 0.01, np.float32))


def _carry(rng, rows):
    return tuple(rng.uniform(lo, hi, rows).astype(np.float32)
                 for lo, hi in ((-1e-3, 1e-3), (0, 4 * np.pi),
                                (0, 4 * np.pi)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _coded_case(rows, n, seed=0):
    """Float samples with exact zeros, their codes with an INVALID run
    over step 128 in every third row from row 1 (all rows when there is
    one), per-row constants and a carry."""
    rng = np.random.default_rng(seed + n + rows)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    x[:, 40:45] = 0.0
    codes = np.array(jpll.encode_sign(jnp.asarray(x)))
    run = np.arange(rows) % 3 == 1 if rows > 1 else np.ones(1, bool)
    codes[run, INVALID_RUN[0]:INVALID_RUN[1]] = jpll.CODE_INVALID
    return x, codes, run, _lanes(rows), _carry(rng, rows)


def _coded_cases():
    for n in (1, 127, 129, 1531):
        for split in sorted({0, 128, INSIDE.get(n, 0), n}):
            if split <= n:
                for rows in (1, 37):
                    yield pytest.param(n, split, rows,
                                       id=f"n{n}-split{split}-rows{rows}")


@pytest.mark.parametrize("n,split,rows", list(_coded_cases()))
def test_coded_plain_matches_dy4tpu_and_the_sample_scan(n, split, rows):
    x, codes, run, (freq, bw), carry = _coded_case(rows, n)
    kp, ki, dth = jpll._loop_consts(freq, FS, bw, F32)
    jc = tuple(jnp.asarray(c) for c in carry)
    ref = pll_pallas.phase_scan_coded(
        jnp.asarray(codes), kp, ki, dth, jc,
        lambda a, b, c: jpll._make_step(a, b, c, F32), split_at=split,
        interpret=True)
    consts = tuple(_t(v) for v in pll._loop_consts(freq, FS, bw))
    tc = tuple(_t(c) for c in carry)
    phis, mid, end = pll_cuda.phase_scan_coded_plain(
        _t(codes), *consts, tc, split_at=split)
    np.testing.assert_allclose(phis.numpy(), np.asarray(ref[0]), atol=2e-4)
    for a, b in zip(end, ref[2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)
    # dy4tpu's kernel snapshots below n only; at n its scan's mid carry is
    # the end carry
    for a, b in zip(mid, ref[1] if split < n else ref[2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)

    # bitwise inside the port: the per-sample scan on the float samples,
    # the carry held over the INVALID run
    lo, hi = min(INVALID_RUN[0], n), min(INVALID_RUN[1], n)
    xt = _t(x)

    def scan(t0, t1, c):
        return pll_cuda.phase_scan_plain(xt[:, t0:t1], *consts, c)

    def at(t, c, t0=0):        # the carry after step t, from c at t0
        return c if t == t0 else scan(t0, t, c)[1]

    p_lo, c_lo = scan(0, lo, tc)
    p_hi, c_end = scan(hi, n, c_lo)
    held = (c_lo[2] + c_lo[1])[:, None].expand(-1, hi - lo)
    run_phis = torch.cat([p_lo, held, p_hi], -1)
    run_mid = (at(split, tc) if split <= lo else c_lo if split <= hi
               else at(split, c_lo, hi))
    clean_phis, clean_end = scan(0, n, tc)
    clean_mid = at(split, tc)
    r = torch.from_numpy(run)
    assert torch.equal(phis[r], run_phis[r])
    assert torch.equal(phis[~r], clean_phis[~r])
    for got, want_run, want_clean in zip(mid + end, run_mid + c_end,
                                         clean_mid + clean_end):
        assert torch.equal(got[r], want_run[r])
        assert torch.equal(got[~r], want_clean[~r])


def _span_case(rows, m, seed=0):
    rng = np.random.default_rng(seed + m + rows)
    t = rng.uniform(-np.pi, np.pi, (rows, m)).astype(np.float32)
    t[1::3, NAN_RUN[0]:NAN_RUN[1]] = np.nan
    t[0, m // 2] = np.nan                       # a dead span in row 0
    return t, _lanes(rows), _carry(rng, rows)


@pytest.mark.parametrize("rows", [1, 37])
@pytest.mark.parametrize("m", [1, 129])
@pytest.mark.parametrize("expand", [False, True], ids=["integ", "expand"])
def test_span_plain_matches_dy4tpu_and_chains(expand, m, rows):
    t, (freq, bw), carry = _span_case(rows, m)
    kp, ki, dth = jpll._loop_consts(freq, FS, bw, F32)
    jc = tuple(jnp.asarray(c) for c in carry)
    emit = dict(expand=SPAN) if expand else dict(emit_integ=True)
    ref = pll_pallas.phase_scan(
        jnp.asarray(t), kp, ki, dth, jc,
        lambda a, b, c: jpll._make_span_step(a, b, c, SPAN, F32),
        mode="target", interpret=True, **emit)
    per_sample = tuple(_t(v) for v in pll._loop_consts(freq, FS, bw))
    _, *eff = pll._span_consts(*per_sample, SPAN)
    eff = tuple(_t(v) for v in eff)
    tc = tuple(_t(c) for c in carry)
    kw = dict(span=SPAN, expand=per_sample if expand else None)
    got = pll_cuda.phase_scan_target_plain(_t(t), *eff, tc, **kw)
    *rows_out, end = got
    np.testing.assert_allclose(rows_out[0].numpy(), np.asarray(ref[0]),
                               atol=2e-5)
    if not expand:
        np.testing.assert_allclose(rows_out[1].numpy(), np.asarray(ref[1]),
                                   atol=1e-6)
    for a, b in zip(end, ref[-1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)

    # bitwise inside the port: split at step 128 and chained
    cut = min(128, m)
    *first, c_cut = pll_cuda.phase_scan_target_plain(_t(t[:, :cut]), *eff,
                                                     tc, **kw)
    *second, c_end = pll_cuda.phase_scan_target_plain(_t(t[:, cut:]), *eff,
                                                      c_cut, **kw)
    for whole, a, b in zip(rows_out, first, second):
        assert torch.equal(whole, torch.cat([a, b], -1))
    for a, b in zip(end, c_end):
        assert torch.equal(a, b)


# ---- csrc/pll.cu on the host ----

# (pattern, replacement) applied to csrc/pll.cu, each of which must match
_REWRITES = (
    (r"#include <cuda_runtime\.h>", '#include "shim.h"'),
    (r'asm volatile\("bar\.sync.*?\);', "g_bar->arrive_and_wait();"),
    (r"extern __shared__ __align__\(16\) unsigned char smem\[\];",
     "unsigned char* smem = g_smem;"),
    (r"kernel<<<(.*?), (.*?), (.*?),\s*static_cast<cudaStream_t>\(stream\)"
     r">>>\(a\);", r"emulate(kernel, \1, \2, \3, a);"),
)


@pytest.fixture(scope="module")
def host_pll(tmp_path_factory):
    """``csrc/pll.cu`` built for the host through the shim
    (``cuda_host.py``): the library with its four C entry points (their
    argument types set)."""
    src = cuda_host.rewrite((kernels.CSRC / "pll.cu").read_text(),
                            "csrc/pll.cu", _REWRITES)
    so = cuda_host.build(tmp_path_factory.mktemp("pll_host"),
                         "libpll_host.so",
                         {"cp_async.cuh": cuda_host.cp_async_header(),
                          "pll.cpp": src})
    fns = {}
    for name, args in (("dy4_pll_phase_scan", pll_cuda._ARGS),
                       ("dy4_pll_span_scan", pll_cuda._TARGET_ARGS),
                       ("dy4_pll_span_expand", pll_cuda._EXPAND_ARGS),
                       ("dy4_pll_phase_scan_coded", pll_cuda._CODED_ARGS)):
        fn = getattr(so, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


_K4 = (pll.PI, pll.TWO_PI, pll.INV_TWO_PI, pll.WRAP)


def _ptr(*tensors):
    return [t.data_ptr() for t in tensors]


def _empties(rows, k=3):
    return [torch.empty(rows) for _ in range(k)]


@pytest.mark.parametrize("rows,n", [(37, 1531), (37, 1536), (5, 0), (3, 1)])
def test_host_b2_equals_plain(host_pll, rows, n):
    """B2 (4-byte copies at N = 1531, 16-byte ones at 1536)."""
    x, _, _, (freq, bw), carry = _coded_case(rows, n)
    consts = tuple(_t(v) for v in pll._loop_consts(freq, FS, bw))
    tc, xt = tuple(_t(c) for c in carry), _t(x)
    phi, c_out = torch.empty_like(xt), _empties(rows)
    assert host_pll["dy4_pll_phase_scan"](
        *_ptr(xt, *consts, *tc, phi, *c_out), rows, n, *_K4, None) == 0
    want, want_c = pll_cuda.phase_scan_plain(xt, *consts, tc)
    assert torch.equal(phi, want)
    assert all(torch.equal(a, b) for a, b in zip(c_out, want_c))


@pytest.mark.parametrize("rows,n,splits", [
    (37, 1531, (0, 128, 1000, 1531)),   # byte copies through registers
    (37, 1552, (0, 128, 700, 1552)),    # 16-byte copies, a tail tile
    (37, 127, (0, 70, 127)), (37, 129, (0, 128, 129)), (3, 1, (0, 1)),
    (4, 0, (0,))])
def test_host_b8_equals_plain(host_pll, rows, n, splits):
    """B8 at every ``split_at``: the run cut in two inside a tile, at a
    tile boundary, at 0 and at n; an INVALID run over two tile boundaries
    and a row INVALID throughout."""
    _, codes, _, (freq, bw), carry = _coded_case(rows, n)
    if rows > 2:
        codes[2] = jpll.CODE_INVALID
    consts = tuple(_t(v) for v in pll._loop_consts(freq, FS, bw))
    tc, ct = tuple(_t(c) for c in carry), _t(codes)
    for split in splits:
        phi, mid, end = torch.empty(rows, n), _empties(rows), _empties(rows)
        assert host_pll["dy4_pll_phase_scan_coded"](
            *_ptr(ct, *consts, *tc, phi, *mid, *end), rows, n, split, *_K4,
            None) == 0
        want = pll_cuda.phase_scan_coded_plain(ct, *consts, tc,
                                               split_at=split)
        assert torch.equal(phi, want[0]), split
        for a, b in zip(mid + end, want[1] + want[2]):
            assert torch.equal(a, b), split


@pytest.mark.parametrize("span", [8, 12])
@pytest.mark.parametrize("rows,m", [(37, 383), (37, 384), (3, 1), (4, 0)])
def test_host_span_scans_equal_plain(host_pll, rows, m, span):
    """B9 and B9-expand: NaN spans over a tile boundary; 4-byte copies at
    m = 383, 16-byte ones at 384; the expansion 16 bytes a lane at span 8,
    element by element at span 12."""
    t, (freq, bw), carry = _span_case(rows, max(m, 1))
    t = t[:, :m]
    per_sample = tuple(_t(v) for v in pll._loop_consts(freq, FS, bw))
    _, *eff = pll._span_consts(*per_sample, span)
    eff = tuple(_t(v) for v in eff)
    tc, tt = tuple(_t(c) for c in carry), _t(t)
    phi0, i0, c_out = torch.empty(rows, m), torch.empty(rows, m), \
        _empties(rows)
    assert host_pll["dy4_pll_span_scan"](
        *_ptr(tt, *eff, *tc, phi0, i0, *c_out), rows, m, float(span), *_K4,
        None) == 0
    want = pll_cuda.phase_scan_target_plain(tt, *eff, tc, span=span)
    assert torch.equal(phi0, want[0]) and torch.equal(i0, want[1])
    assert all(torch.equal(a, b) for a, b in zip(c_out, want[2]))
    phis, c_out = torch.empty(rows, m * span), _empties(rows)
    assert host_pll["dy4_pll_span_expand"](
        *_ptr(tt, *eff, *tc, *per_sample, phis, *c_out), rows, m, span,
        float(span), *_K4, None) == 0
    want_phis, want_c = pll_cuda.phase_scan_target_plain(
        tt, *eff, tc, span=span, expand=per_sample)
    assert torch.equal(phis, want_phis)
    assert all(torch.equal(a, b) for a, b in zip(c_out, want_c))

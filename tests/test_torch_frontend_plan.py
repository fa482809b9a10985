"""B1 / B6's time tiling (``csrc/frontend.cu``) on the CPU.

The kernels run on a grid of (row, tile): a thread block owns the IF
outputs [m0, m1) of one row and recomputes a halo of samples before m0;
tile 0 takes its history from the carried state and the last tile writes
every new tail.  The CUDA code cannot run here, so this file holds

  * the wrapper's plan (``frontend_cuda._tile_plan``, ``_smem_bytes``):
    a tile is at least the halo, the tiles cover [0, n_out) exactly, and
    a B1 / B6 block's shared memory lets at least 3 blocks share an SM
    (at most 60 KB) in all four modes;
  * the tensor-core design's plan (``bf16=True``, precision below
    "highest"): its walk (tiles, the RF MMA units and passes, the bank's
    and carrier's units) makes every output once and reads inside its
    buffers, at the modes, ragged rows, one tile, other filters and RF
    passes that shrink to fit; 4 blocks an SM by shared memory at every
    mode; and ``_smem_bytes`` is ``dy4_frontend_smem`` (``csrc/frontend.cu``
    built for the host) at both designs;
  * ``_tiled_model``: the plain ops run per tile over the tile's halo, in
    the kernel's index arithmetic (b0, f_base, q_base, g0), then
    concatenated, with the corr moments summed per tile in the kernel's
    order (per-thread strides from the tile's first sample, a warp shuffle
    tree, warps, tiles).  It
    must equal ``fused_frontend_full_plain`` within 1e-6 (the RF LPF and
    the bank run over other slices of the same rows), with every tail
    within 1e-6 and ``iq_tail`` exact, at modes 0-3, with and without RDS,
    with corr, and at a ragged n_out whose last tile is shorter than
    kb - 1; and once against dy4tpu's Pallas ``fused_frontend_full`` in
    interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from dy4tpu.ops import frontend_pallas  # noqa: E402
from dy4tpu_torch.config import MODES  # noqa: E402
from dy4tpu_torch.ops import demod, fir, iqcorr, mix  # noqa: E402
from dy4tpu_torch.ops import frontend_cuda as fc  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.runtime import kernels  # noqa: E402

KB = 101                     # band / carrier taps (every mode)
K_RF = 101                   # RF LPF taps
SM_BYTES = 233472            # shared memory of one H100 SM (228 KB)
BLOCK_RESERVED = 1024        # the card's own shared memory per block
RAGGED = 2 * fc.TILE + 60    # n_out: 3 tiles, the last 60 < kb - 1
TOL = 1e-6


def _signal(rng, c: int, n_in: int) -> np.ndarray:
    """u8 [c, 2 n_in]: an FM carrier with a slow tone and noise, a random
    phase and level per row, so no two rows are equal."""
    t = np.arange(n_in)[None] + rng.integers(0, 10**6, (c, 1))
    ph = (0.3 * np.sin(2 * np.pi * t / 4000.0) + 0.05 * t
          + rng.uniform(0, 6, (c, 1)))
    amp = 90 + 20 * rng.random((c, 1))
    iq = (np.stack([128 + amp * np.cos(ph), 128 + amp * np.sin(ph)], -1)
          + rng.normal(0, 3, (c, n_in, 2)))
    return np.clip(np.rint(iq), 0, 255).astype(np.uint8).reshape(c, -1)


def _case(seed: int, c: int, n_out: int, decim: int):
    """The eleven tensors of ``fused_frontend_full``: the mode-0 taps of
    ``make_params``, a signal, and random carried state."""
    rng = np.random.default_rng(seed)
    p = rx.make_params(MODES[0], device="cpu")
    f = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * 0.1).astype(np.float32))
    u8 = torch.from_numpy(_signal(rng, c, n_out * decim))
    return (u8, p.rf_coeff, p.bank_coeff, p.rds_carrier_coeff,
            f(c, 2, K_RF - 1), f(c) + 0.5, f(c) + 0.5, f(c, KB - 1),
            f(c, KB // 2), f(c, KB - 1), f(c, KB // 2))


def _corr(seed: int, c: int):
    g = np.random.default_rng(seed)
    return torch.from_numpy(np.stack(
        [g.uniform(-0.05, 0.05, c), g.uniform(-0.05, 0.05, c),
         g.uniform(-0.2, 0.2, c), g.uniform(0.8, 1.2, c)],
        axis=-1).astype(np.float32))


def _tile_moments(i: torch.Tensor, q: torch.Tensor,
                  skip: int) -> torch.Tensor:
    """[C, n] I/Q of a tile from g0 -> [C, 14] moment sums over its own
    outputs (from sample ``skip`` = m0 - g0 on) in the kernel's order:
    thread t takes samples t, t + 256, ... in turn and sums those that are
    the tile's own, each warp's 32 sums meet in a shuffle tree (lane l
    adds lane l + off, off = 16 .. 1), and the warps' sums are added in
    warp order."""
    c, n = i.shape
    i2, q2 = i * i, q * q
    i3, q3 = i2 * i, q2 * q
    terms = torch.stack([i2 * i2, i3 * q, i2 * q2, i * q3, q2 * q2, i3,
                         i2 * q, i * q2, q3, i2, i * q, q2, i, q], dim=1)
    terms[..., :skip] = 0.0                 # the halo: not summed
    pad = -n % fc.THREADS
    terms = torch.nn.functional.pad(terms, (0, pad))
    strided = terms.reshape(c, fc.MOMENTS, -1, fc.THREADS)
    acc = torch.zeros(c, fc.MOMENTS, fc.THREADS)
    for k in range(strided.shape[2]):
        acc = acc + strided[:, :, k]
    v = acc.reshape(c, fc.MOMENTS, fc.THREADS // 32, 32)
    off = 16
    while off:
        v = v[..., :off] + v[..., off:2 * off]
        off //= 2
    total = torch.zeros(c, fc.MOMENTS)
    for w in range(fc.THREADS // 32):
        total = total + v[:, :, w, 0]
    return total


def _fir(ext: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """[..., S + n] -> [..., n]: y[m] = sum_j h[j] ext[m + S - j], S =
    len(h) - 1 (``fir.block_fir`` without its block-length check: a
    ragged last tile can be shorter than the history)."""
    lead = ext.shape[:-1]
    y = torch.nn.functional.conv1d(ext.reshape(-1, 1, ext.shape[-1]),
                                   h.flip(0)[None, None])
    return y.reshape(*lead, -1)


def _tiled_model(args, decim: int, rds: bool, corr=None):
    """B1 tile by tile: the plain ops of each tile over its halo, in the
    kernel's index arithmetic, concatenated.  Returns the outputs of
    ``fused_frontend_full_plain`` (``mom`` last with ``corr``)."""
    (u8, h_rf, h_bank, h_car, iq_tail, prev_i, prev_q, bank_tail,
     mono_delay, carrier_tail, rds_delay) = args
    c, bs = u8.shape
    s, s_b, dly = K_RF - 1, KB - 1, KB // 2
    n_out = bs // 2 // decim
    plan = fc._tile_plan(n_out, decim, K_RF, KB, rds)
    x = ((u8.to(torch.float32) - 128.0) / 128.0).reshape(c, -1, 2)
    ext = torch.cat([iq_tail, x.movedim(-1, -2)], -1)    # [C, 2, s + n_in]
    parts = {n: [] for n in ("fmd", "pilot", "stereo", "carrier", "rdsdel")}
    mom_sums = []
    for tile in range(plan.n_tiles):
        m0 = tile * plan.tile
        m1 = min(m0 + plan.tile, n_out)
        first, last = tile == 0, tile == plan.n_tiles - 1
        b0 = 0 if first else m0 - (s_b if rds else 0)
        f_base = b0 - s_b
        q_base = f_base - 1
        g0 = 0 if first else q_base
        # ---- RF outputs [g0, m1) from their own window of ext
        iq, _ = fir.block_fir_decim(ext[..., g0 * decim + s:m1 * decim + s],
                                    h_rf, ext[..., g0 * decim:g0 * decim + s],
                                    decim)
        i_t, q_t = iq[:, 0], iq[:, 1]
        if corr is not None:
            mom_sums.append(_tile_moments(i_t, q_t, m0 - g0))
            i_t, q_t = iqcorr.apply(i_t, q_t,
                                    iqcorr.IQCorrCoeffs(*corr.unbind(-1)))
        # ---- demod: fm over [0, m1) in tile 0, else [f_base, m1)
        if first:
            fm, pi_new, pq_new = demod.fm_demod_diff(i_t, q_t, prev_i, prev_q)
            fm_ext = torch.cat([bank_tail, fm], -1)
        else:
            fm_ext, pi_new, pq_new = demod.fm_demod_diff(
                i_t[:, 1:], q_t[:, 1:], i_t[:, 0], q_t[:, 0])
        # fm_ext holds fm at f_base + l; the bank makes [b0, m1)
        bands = torch.stack([_fir(fm_ext, h) for h in h_bank[:3 if rds
                                                              else 2]], 1)
        parts["pilot"].append(bands[:, 0, m0 - b0:])
        parts["stereo"].append(bands[:, 1, m0 - b0:])
        if first:
            parts["fmd"].append(
                mix.delay_block(fm_ext[:, s_b:], mono_delay)[0])
        else:
            parts["fmd"].append(fm_ext[:, m0 - dly - f_base:m1 - dly - f_base])
        if rds:
            rb = bands[:, 2]                          # [b0, m1)
            sq = mix.squaring_nonlinearity(rb)
            sq_ext = torch.cat([carrier_tail, sq], -1) if first else sq
            parts["carrier"].append(_fir(sq_ext, h_car))
            parts["rdsdel"].append(mix.delay_block(rb, rds_delay)[0] if first
                                   else rb[:, m0 - dly - b0:m1 - dly - b0])
        if last:
            tails = (ext[..., -s:], pi_new, pq_new,
                     fm_ext[:, n_out - s_b - f_base:],
                     fm_ext[:, n_out - dly - f_base:],
                     sq_ext[:, n_out - m0:] if rds else None,
                     rb[:, n_out - dly - b0:] if rds else None)
    cat = lambda n: torch.cat(parts[n], -1) if parts[n] else None  # noqa: E731
    outs = (cat("fmd"), cat("pilot"), cat("stereo"), cat("carrier"),
            cat("rdsdel"), *tails)
    if corr is None:
        return outs
    mom = torch.zeros(c, fc.MOMENTS)
    for part in mom_sums:
        mom = mom + part
    return (*outs, mom / n_out)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tile_plan_covers_and_fits(mode):
    cfg = MODES[mode]
    rds = cfg.supports_rds
    n_out, decim = cfg.if_per_block, cfg.rf_decim
    for k_rf, d in ((K_RF, decim), (0, 1)):          # B1, B6
        plan = fc._tile_plan(n_out, d, k_rf, KB, rds)
        assert plan.halo == (2 * (KB - 1) + 1 if rds else KB)
        assert plan.tile >= plan.halo and plan.tile % 4 == 0
        assert ((plan.n_tiles - 1) * plan.tile < n_out
                <= plan.n_tiles * plan.tile)
        starts = [t * plan.tile for t in range(plan.n_tiles)]
        ends = [min(a + plan.tile, n_out) for a in starts]
        assert starts[0] == 0 and ends[-1] == n_out
        assert all(a == b for a, b in zip(starts[1:], ends[:-1]))
        for corr in ((False, True) if k_rf else (False,)):
            smem = fc._smem_bytes(plan, d, k_rf, KB, rds, corr)
            assert smem <= 60 * 1024, (mode, k_rf, corr, smem)
            assert 3 * (smem + BLOCK_RESERVED) <= SM_BYTES
        if k_rf:
            # the RF passes: 4 outputs a thread, the window in the
            # threads' prefetch registers
            nq = fc._phase_taps(d, k_rf)
            assert plan.sub % 4 == 0 and plan.sub >= 4
            assert d * (plan.sub + nq) <= fc.PASS_SAMPLES
            assert plan.sub * -(-(min(n_out, plan.tile) + plan.halo)
                                // plan.sub) >= min(n_out, plan.tile)


def test_tile_plan_ragged_last_tile_is_short():
    for decim in (10, 5):
        for rds in (True, False):
            plan = fc._tile_plan(RAGGED, decim, K_RF, KB, rds)
            last = RAGGED - (plan.n_tiles - 1) * plan.tile
            assert RAGGED % plan.tile and 0 < last < KB - 1


def _check(model, plain, rds):
    for k, (a, b) in enumerate(zip(model, plain)):
        if b is None:
            assert a is None or not rds, k
            continue
        assert a.shape == b.shape, k
        if k == 5:                                   # iq_tail
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, atol=TOL, rtol=0.0,
                                       msg=f"output {k}")


CASES = [(f"mode{m}", MODES[m].if_per_block, MODES[m].rf_decim,
          MODES[m].supports_rds) for m in sorted(MODES)] + [
    ("mode0 no RDS", MODES[0].if_per_block, 10, False),
    ("mode1 RDS", MODES[1].if_per_block, 5, True),
    ("ragged D10", RAGGED, 10, True), ("ragged D10 no RDS", RAGGED, 10, False),
    ("ragged D5", RAGGED, 5, True), ("ragged D5 no RDS", RAGGED, 5, False),
    ("one tile", 150, 10, True)]


@pytest.mark.parametrize("label,n_out,decim,rds", CASES,
                         ids=[c[0] for c in CASES])
def test_tiled_model_equals_plain(label, n_out, decim, rds):
    args = _case(n_out + decim, 2, n_out, decim)
    _check(_tiled_model(args, decim, rds),
           fc.fused_frontend_full_plain(*args, decim, rds=rds), rds)


@pytest.mark.parametrize("label,n_out,decim,rds",
                         [CASES[0], CASES[1], CASES[6], CASES[9]],
                         ids=["mode0", "mode1", "ragged D10",
                              "ragged D5 no RDS"])
def test_tiled_model_with_corr_equals_plain(label, n_out, decim, rds):
    args = _case(n_out + 7, 2, n_out, decim)
    corr = _corr(n_out, 2)
    model = _tiled_model(args, decim, rds, corr)
    plain = fc.fused_frontend_full_plain(*args, decim, rds=rds, corr=corr)
    _check(model[:12], plain[:12], rds)
    # the moments against E[|i|^p |q|^r], the scale of their rounding
    i_ds, q_ds, _ = fc.rf_lpf_plain(args[0], args[1], args[4], decim)
    scale = torch.stack([(i_ds.double().abs() ** p
                          * q_ds.double().abs() ** r).mean(-1)
                         for p, r in iqcorr._POWERS], -1)
    rel = ((model[12].double() - plain[12].double()).abs() / scale).max()
    assert float(rel) <= 1e-6


def test_tiled_model_matches_pallas_interpret():
    """One case against dy4tpu's fused Pallas front end in interpret mode
    (mode 0 with RDS, 2 rows): the streams and tails to atol and rtol 2e-3,
    tests/test_torch_frontend.py's bar for input whose envelope is not
    constant (the /power demod amplifies float32 noise), iq_tail exact."""
    cfg = MODES[0]
    args = _case(3, 2, cfg.if_per_block, cfg.rf_decim)
    model = _tiled_model(args, cfg.rf_decim, True)
    ref = frontend_pallas.fused_frontend_full(
        *(jnp.asarray(a.numpy()) for a in args), cfg.rf_decim, rds=True,
        mm_dtype=jnp.float32, interpret=True)
    for k, (a, b) in enumerate(zip(model, ref[:12])):
        b = np.asarray(b)
        if k == 5:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, atol=2e-3, rtol=2e-3,
                                       err_msg=f"output {k}")


# ---- the tensor-core design's plan (precision below "highest") ----

TC_BLOCKS = 4        # B1 / B6 blocks an SM at "default" (PERF.md's bar)


def _check_tc_plan(plan, n_out: int, decim: int, k_rf: int, kb: int,
                   rds: bool) -> None:
    """The tensor-core kernels' walk (``csrc/frontend.cu``, kBf16) over
    one row: tiles [m0, m1) own every output once; a tile's bank starts
    at b0 (m0 - (kb-1) with RDS, rounded down to a multiple of 8), its
    halo covers what the carrier, the bank and the demod read before m0;
    the RF MMA units from g0 rounded down to 8, in passes of ``sub``,
    make every I/Q sample [g0, m1) once, each into its own slot, every
    pass's window inside a ring buffer; the bank's and the carrier's
    units cover their outputs and read inside their buffers."""
    lay = fc._tc_layout(plan, decim, k_rf, kb, rds)
    s_b = kb - 1
    assert plan.halo == fc._tc_halo(kb, rds)
    assert plan.tile >= plan.halo and plan.tile % 8 == 0
    assert plan.n_tiles == -(-n_out // plan.tile)
    owned = np.zeros(n_out, np.int32)
    for tile in range(plan.n_tiles):
        m0, m1 = tile * plan.tile, min((tile + 1) * plan.tile, n_out)
        owned[m0:m1] += 1
        b0 = 0 if tile == 0 else (m0 - (s_b if rds else 0)) & ~7
        assert b0 % 8 == 0
        q_base = b0 - s_b - 1
        g0 = 0 if tile == 0 else q_base
        assert tile == 0 or m0 - q_base <= plan.halo
        assert m1 - q_base <= lay.l_iq
        if k_rf:
            g0a = g0 & ~7
            units = -(-(m1 - g0a) // fc.TC_UNIT)
            per = plan.sub // fc.TC_UNIT
            made = np.zeros(m1 - g0a, np.int32)
            for p in range(-(-units // per)):
                here = min(per, units - p * per)
                lo = p * plan.sub
                made[lo:lo + here * fc.TC_UNIT] += 1
                # the window read (rows of the last unit, all k-steps)
                # and its staged words from up to a sample before
                samp = (here * fc.TC_UNIT - 8) * decim + fc.TC_K * lay.ks_rf
                assert 4 * ((1 + samp + 1) // 2) <= lay.win_bytes
            assert (made[g0 - g0a:] == 1).all()
        n_bank = m1 - b0
        n_ub = -(-n_bank // fc.TC_UNIT)
        # the bank's rows read fm_ext up to row 15 of the last unit, all
        # k-steps; the demod fills n_bank + s_b of it
        assert n_ub * fc.TC_UNIT - 8 + fc.TC_K * lay.ks_b <= lay.l_fmb
        assert n_bank + s_b <= n_ub * fc.TC_UNIT - 8 + fc.TC_K * lay.ks_b
        assert 7 + kb <= fc.TC_K * lay.ks_b
        if rds:
            n_c = m1 - m0
            n_uc = -(-n_c // fc.TC_UNIT)
            assert n_uc * fc.TC_UNIT - 8 + fc.TC_K * lay.ks_b <= lay.l_sq
            assert 2 * lay.l_sq <= 4 * lay.l_q and n_bank <= lay.l_iq
            # sq[i] (the square at m0 - s_b + i) comes from bank output
            # i + (m0 - b0) - s_b, which the bank makes
            assert tile == 0 or m0 - b0 - s_b >= 0
    assert (owned == 1).all()


TC_PLAN_CASES = [(f"mode{m} {what}", MODES[m].if_per_block, d, k,
                  MODES[m].supports_rds)
                 for m in sorted(MODES)
                 for what, d, k in (("B1", MODES[m].rf_decim, K_RF),
                                    ("B6", 1, 0))] + [
    ("ragged D10", RAGGED, 10, K_RF, True),
    ("ragged D5", RAGGED, 5, K_RF, False), ("one tile", 150, 10, K_RF, True),
    ("C=1 row", 700, 10, K_RF, True), ("ragged B6", RAGGED, 1, 0, True)]


@pytest.mark.parametrize("label,n_out,decim,k_rf,rds", TC_PLAN_CASES,
                         ids=[c[0] for c in TC_PLAN_CASES])
def test_tc_plan_makes_every_output_once(label, n_out, decim, k_rf, rds):
    plan = fc._tile_plan(n_out, decim, k_rf, KB, rds, bf16=True)
    _check_tc_plan(plan, n_out, decim, k_rf, KB, rds)
    if k_rf:
        assert plan.sub == fc.TC_UNITS * fc.TC_UNIT
    for corr in ((False, True) if k_rf else (False,)):
        smem = fc._smem_bytes(plan, decim, k_rf, KB, rds, corr, True)
        assert smem <= kernels.SMEM_MAX
        if label.startswith("mode"):
            assert TC_BLOCKS * (smem + BLOCK_RESERVED) <= SM_BYTES, smem


@pytest.mark.parametrize("decim,k_rf,kb,rds", [(4, 51, 33, True),
                                                (3, 75, 11, False),
                                                (8, 129, 101, True)])
def test_tc_plan_other_geometries(decim, k_rf, kb, rds):
    """Filters other than the modes' (the fuzz (K, D) of the RF tests,
    short and long band filters): the walk as above."""
    for n_out in (kb + 3, 2 * fc.TILE + 37):
        plan = fc._tile_plan(n_out, decim, k_rf, kb, rds, bf16=True)
        _check_tc_plan(plan, n_out, decim, k_rf, kb, rds)


def test_tc_plan_passes_shrink_to_fit():
    """A long RF filter at a high decimation: RF passes of fewer MMA
    units, within the card's shared memory."""
    plan = fc._tile_plan(2000, 64, 4001, KB, True, bf16=True)
    assert plan.sub < fc.TC_UNITS * fc.TC_UNIT
    assert fc._smem_bytes(plan, 64, 4001, KB, True, True,
                          True) <= kernels.SMEM_MAX
    _check_tc_plan(plan, 2000, 64, 4001, KB, True)


@pytest.fixture(scope="module")
def host_smem(tmp_path_factory):
    """``dy4_frontend_smem`` of ``csrc/frontend.cu`` built for the host."""
    import cuda_host
    return cuda_host.build_frontend(
        tmp_path_factory.mktemp("frontend_host")).dy4_frontend_smem


@pytest.mark.parametrize("bf16", [False, True], ids=["highest", "default"])
def test_smem_formula_is_the_kernels(host_smem, bf16):
    """``_smem_bytes`` is ``dy4_frontend_smem``'s own formula at every
    plan above, for B1, B1-corr and B6, at both designs."""
    cases = [(c[1], c[2], c[3], c[4]) for c in TC_PLAN_CASES] + (
        [(2000, 64, 4001, True)] if bf16 else [])
    for n_out, d, k, rds in cases:
        plan = fc._tile_plan(n_out, d, k, KB, rds, bf16)
        for corr in ((0, 1) if k else (0,)):
            assert host_smem(plan.tile, plan.sub, d, k, KB, int(rds), corr,
                             int(bf16)) == fc._smem_bytes(
                plan, d, k, KB, rds, bool(corr), bf16), (n_out, d, k, rds)

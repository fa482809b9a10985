"""The rational-resampler back ends: two CUDA kernels and their plain
torch versions.

``fused_rds_backend`` (``csrc/rds_backend.cu``) replaces
``dy4tpu/ops/resample_pallas.py :: fused_rds_backend``: the quadrature mix
of the delayed RDS band with the RDS NCO pair, the rational U/D resampler
with its 3 kHz LPF (19/120 with 1919 taps at mode 0, 171/640 with 17271
taps at mode 2), and the RRC matched filter, for the I and Q legs with
four tails carried.

``fused_audio_backend_rational`` (``csrc/audio_rational.cu``) replaces
``resample_pallas.fused_audio_backend_rational``: the audio back end of
the U>1 modes 2 and 3 (147/800 and 147/1280 with 14847 taps), the
``2 * nco * stereo_band`` mix, the mono and stereo rational resamplers and
the L/R matrix.

B3, the audio back end of the U=1 modes 0 and 1
(``backend_cuda.fused_audio_backend``), is B5's kernel at U = 1: it
launches through ``_audio_launch`` with ``up=1``.

The kernels are one polyphase tile resampler (``csrc/rational.cuh``):
persistent blocks stage the taps once in polyphase order and walk work
items of (row group, tile of whole cycles), copy warps prefetching the
next item's mixed input windows; B4 runs its RRC on the tile in shared
memory over a recomputed halo.  ``_tile_plan`` sizes it.  An output's sum
runs in one order whatever the plan, so every plan gives the same bits.
All match their plain versions to float32 tolerance; the carried
resampler tails are exact.

Every wrapper and plain version takes dy4tpu's ``precision=``
(``ops/precision.py``), "highest" by default, the receiver's default (dy4tpu's
direct Pallas entries default to ``mm_dtype=bf16``; the port's wrappers do
not).  "highest" runs the float32 walk above.  Below it the kernels run the
tensor-core design (``csrc/rational_tc.cuh``), dy4tpu's ``mm_dtype=bf16``
dots as bf16 ``mma.sync`` products with float32 sums: the copy warps round
the mixed input legs to bf16 as they stage them, one banded matrix of a
phase cycle's taps (rounded by the kernel itself) serves every cycle,
and B4 rounds its resampled stream before the RRC, a Toeplitz product;
``_tc_plan`` sizes it, a rule.  The carried tails stay float32.
"""

from __future__ import annotations

import ctypes
import functools
import math
import typing

import torch

from dy4tpu_torch.ops import fir, mix
from dy4tpu_torch.ops.precision import rounding, rounds, taps
from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

# csrc/rational.cuh's constants: threads a block may hold (one block an
# SM, 128 registers a thread), outputs of one thread's RRC register window,
# the 16-byte loads of an input a copy thread keeps in flight, the
# (positions a thread, cycles a thread) shapes it is instantiated for,
# and the fewest copy warps a block keeps
MAX_THREADS = 512
RRC_GROUP = 9
VEC_UNROLL = 4
SHAPES = ((1, 1), (1, 2), (1, 3), (1, 4), (2, 1), (2, 2), (2, 3), (3, 1),
          (3, 2), (4, 1), (4, 2))
MIN_COPY_WARPS = 4
# the most tuples a cycle takes at U = 1 (a power of two): a half-warp's
# worth, whose window reads the tuples' leads spread over the 16 bank pairs
U1_TUPLES = 16
# the H100's SMs (the default; the wrappers ask the device)
SMS = 132
# The plan's cost model, in SM clocks (``chip_smoke.py`` phase 2 times
# every plan of B3, B4 and B5 at modes 0-3 on the card and fits these to
# it).  A block takes its items in turn, each in the longer of two times:
# its compute warps' (_WF_CLK a shared-memory wavefront of its resampler,
# _wavefronts, where a turn with fewer than _FULL_WARPS warps at work
# counts as if it had that many; _RRC_CLK an RRC FMA; _ITEM_CLK besides:
# its barriers, its epilogue's stores) and its copy warps' loading of the
# next item's windows (_COPY_CLK a round of loads a copy thread waits on,
# _copy_rounds); the first item's windows load before any compute.
_WF_CLK, _FULL_WARPS, _RRC_CLK, _ITEM_CLK, _COPY_CLK = (0.4, 8, 0.097, 4560,
                                                        2640)


class TilePlan(typing.NamedTuple):
    """The polyphase tile resampler's launch (``csrc/rational.cuh``).

    A cycle of the walk is ``span`` outputs: one phase cycle of U where
    U > 1, ``span`` consecutive outputs at U = 1.  A work item is ``rows``
    rows times one tile of ``cycles`` whole cycles (``tile`` = cycles *
    span outputs; the last tile of a row may be shorter), ``items`` of
    them in all, walked by ``ctas`` persistent blocks.  B4 recomputes
    ``halo`` outputs (whole cycles, at least k2 - 1) before every tile but
    the first; its resampled tile sits at ``yhead`` in a stream's
    ``ystride`` floats of shared memory.  A stream's input window holds
    ``window`` samples behind ``guard`` zero ones.  A compute thread owns
    a tuple of ``phases`` consecutive positions, whose tap rows are
    shifted onto the tuple's anchor (``lx`` steps a loop), and accumulates
    ``chunk`` cycles of a row's two streams at once; lane l takes tuple
    (l * ``tmul``) mod tuples, tuple k reads (k // ``lead_group``) %
    ``lead_mod`` steps ahead of its newest input (U = 1 only), and
    ``groups`` threads share a tuple.  ``compute_threads`` of the block's
    ``threads`` compute, the rest copy.  ``smem``: bytes of dynamic shared
    memory a block takes."""
    rows: int
    cycles: int
    span: int
    tile: int
    n_tiles: int
    halo: int
    window: int
    ystride: int
    yhead: int
    phases: int
    tmul: int
    lead_group: int
    lead_mod: int
    lx: int
    guard: int
    chunk: int
    groups: int
    compute_threads: int
    threads: int
    ctas: int
    items: int
    smem: int


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def _tap_stride(n: int) -> int:
    """Floats a shifted tap row of ``n`` steps takes: padded to 4 x an
    odd number (``rational.cuh`` tap_stride)."""
    q = -(-n // 4)
    return 4 * (q if q % 2 else q + 1)


def _anchors(up: int, down: int, span: int, phases: int,
             lead: tuple[int, int] = (1, 1)) -> list[int]:
    """Each tuple's anchor, the input its loop starts from: b_p of its
    last position, plus its lead (k // lead_group) % lead_mod."""
    step = span // up * down
    group, mod = lead
    return [(min((k + 1) * phases, span) - 1) * step // span
            + k // group % mod for k in range(-(-span // phases))]


def _tuples(up: int, down: int, s: int, span: int, phases: int,
            lead: tuple[int, int] = (1, 1)) -> tuple[int, int, int]:
    """``(tuples, lx, guard)``: the tuples of ``phases`` positions, the
    steps of a tuple's loop (S + 1 + its widest shift) and the zero float2
    a window row needs before it (the widest shift, made even)."""
    step = span // up * down
    anchors = _anchors(up, down, span, phases, lead)
    shift = max(a - k * phases * step // span for k, a in enumerate(anchors))
    return len(anchors), s + 1 + shift, shift + shift % 2


def _spans(up: int, down: int, n_in: int, phases: int) -> list[int]:
    """Outputs a cycle of the walk may take: U where U > 1; at U = 1 one
    tuple of ``phases`` outputs (at P = 1 the first design's one output a
    thread) and the most tuples, a power of two up to U1_TUPLES, whose
    cycle divides the row (none where ``phases`` does not divide it)."""
    if up > 1:
        return [up]
    m_out = n_in // down
    if m_out % phases:
        return []
    t = U1_TUPLES
    while m_out % (t * phases):
        t //= 2
    return sorted({phases, t * phases})


def _half_warp_wavefronts(slots: list[int]) -> int:
    """Shared-memory wavefronts of one warp's 8-byte reads of these float2
    slots: the two half-warps go apart, each as many as its most loaded
    bank pair holds distinct slots."""
    n = 0
    for half in (slots[:16], slots[16:]):
        if half:
            pairs: dict[int, set] = {}
            for a in half:
                pairs.setdefault(a % 16, set()).add(a)
            n += max(len(v) for v in pairs.values())
    return n


@functools.lru_cache(maxsize=64)
def _tuple_order(up: int, down: int, span: int, phases: int,
                 chunk: int) -> tuple[int, tuple[int, int]]:
    """``(tmul, (lead_group, lead_mod))``: lane l takes tuple (l * tmul)
    mod tuples, tuple k leads by (k // lead_group) % lead_mod.  U > 1: of
    the multipliers prime to the tuples, the one whose warps read the
    window in the fewest wavefronts (``_half_warp_wavefronts``), no lead.
    U = 1: tmul 1, and of the leads (lead_mod at most D), the one whose
    first warp (its tuples, then its units ``chunk`` cycles apart) reads
    in the fewest wavefronts, then the one with the shortest loop."""
    n = -(-span // phases)
    if up == 1:
        step = span * down
        best = (math.inf, math.inf, (1, 1))
        for group in (1, 2, 4, 8, 16):
            for mod in range(1, down + 1):
                anchors = _anchors(up, down, span, phases, (group, mod))
                wf = _half_warp_wavefronts(
                    [anchors[lane % n] + lane // n * chunk * step
                     for lane in range(32)])
                lx = _tuples(up, down, 0, span, phases, (group, mod))[1]
                best = min(best, (wf, lx, (group, mod)))
        return (1 if n > 1 else 0), best[2]
    bases = _anchors(up, down, span, phases)
    best = (math.inf, 0 if n == 1 else 1)
    for m in range(1, n):
        if math.gcd(m, n) == 1:
            wf = sum(_half_warp_wavefronts([bases[lane * m % n] for lane in
                                            range(w, min(w + 32, n))])
                     for w in range(0, n, 32))
            best = min(best, (wf, m))
    return best[1], (1, 1)


def _layout(up: int, down: int, s: int, k2: int, rows: int, cycles: int,
            halo_cycles: int, span: int, phases: int,
            lead: tuple[int, int] = (1, 1)) -> tuple[int, int, int, int]:
    """``(window, ystride, yhead, smem)``: csrc/rational.cuh's shared
    memory, in this order: the shifted tap rows [phases][hrows] (hrows:
    the tuples, at U = 1 the leads, whose tuples share their rows), the
    RRC taps, two input windows of ``rows`` rows x (guard + ``window``)
    float2, ``2 * rows`` resampled streams of ``ystride`` floats, and (B4)
    ``2 * rows`` RRC output rows of a tile for each half of the RRC sum;
    each region padded to 16 bytes."""
    tuples, lx, guard = _tuples(up, down, s, span, phases, lead)
    tile = cycles * span
    window = _r4(s + (cycles + halo_cycles) * span // up * down)
    yhead = max(halo_cycles * span, k2 - 1) if k2 else 0
    ystride = _r4(yhead + tile + (RRC_GROUP if k2 else 0))
    hrows = tuples if up > 1 else lead[1]
    floats = (phases * hrows * _tap_stride(lx) + _r4(k2)
              + 2 * rows * (guard + window) * 2 + 2 * rows * ystride
              + (4 * rows * _r4(tile) if k2 else 0))
    return window, ystride, yhead, 4 * floats


def _wavefronts(up: int, down: int, s: int, span: int, rows: int, nci: int,
                phases: int, chunk: int, groups: int, window: int) -> float:
    """Shared-memory wavefronts of one item's resampler over its
    occupancy: in each turn of the threads, per step, each warp with a
    thread at work takes its ``phases`` 16-byte tap reads (four steps a
    read; a wavefront a read for every 8 distinct tap rows its lanes read,
    which are up to 32 at U > 1 and at most one a lead at U = 1) and its
    ``chunk`` 8-byte window reads (at least two wavefronts a warp, more
    where its lanes' slots share a bank); a turn with fewer than
    _FULL_WARPS warps at work counts as if it had that many."""
    tmul, lead = _tuple_order(up, down, span, phases, chunk)
    tuples, lx, guard = _tuples(up, down, s, span, phases, lead)
    bases = _anchors(up, down, span, phases, lead)
    step = span // up * down
    nch = -(-nci // chunk)
    units = rows * nch
    total = 0.0
    for turn in range(-(-units // groups)):
        busy = min(groups, units - turn * groups)
        slots, taps = [], []
        for ctid in range(tuples * busy):
            lane, j = ctid % tuples, ctid // tuples
            row, c0 = divmod(j + turn * groups, nch)
            k = lane * tmul % tuples
            slots.append(row * (guard + window) + s + bases[k]
                         + c0 * chunk * step)
            taps.append(lane if up > 1 else k // lead[0] % lead[1])
        per_step, warps = 0.0, 0
        for w0 in range(0, len(slots), 32):
            warp = slots[w0:w0 + 32]
            warps += 1
            per_step += phases / 4 * -(-len(set(taps[w0:w0 + 32])) // 8)
            per_step += sum(max(2, _half_warp_wavefronts(
                [x + q * step for x in warp])) for q in range(chunk))
        total += lx * per_step / min(1.0, warps / _FULL_WARPS)
    return total


def _copy_rounds(rows: int, window: int, copy_threads: int) -> int:
    """Rounds of loads a copy thread waits on for an item: each row's
    window in turn, ``copy_threads`` x VEC_UNROLL 16-byte loads of each
    input at a time."""
    return rows * -(-window // (4 * copy_threads * VEC_UNROLL))


class _Cost(typing.NamedTuple):
    """A plan's terms in the cost model: the rounds of items a block
    takes, an item's resampler wavefronts over its occupancy
    (_wavefronts), its RRC FMAs, and its copy warps' rounds of loads
    (_copy_rounds)."""
    rounds: int
    wavefronts: float
    rrc_fmas: int
    copy_rounds: int

    def clocks(self) -> float:
        compute = (_WF_CLK * self.wavefronts + _RRC_CLK * self.rrc_fmas
                   + _ITEM_CLK)
        copy = _COPY_CLK * self.copy_rounds
        return self.rounds * max(compute, copy) + copy


def _candidates(c: int, n_in: int, up: int, down: int, k: int, k2: int,
                sms: int, rows: typing.Optional[int] = None,
                cycles: typing.Optional[int] = None,
                shape: typing.Optional[tuple[int, int]] = None):
    """Every plan ``_tile_plan`` weighs, with its cost terms: row groups
    of 1, 2 or 4 rows, each shape in SHAPES (at U = 1 with each of its
    spans, ``_spans``), the smallest tile of each tile count (a tile of B4 at
    least its halo), the threads a tuple as many as the item's units
    allow; those that fit ``kernels.SMEM_MAX``."""
    if c < 1 or up < 1 or math.gcd(up, down) != 1 or (n_in * up) % down:
        raise ValueError(f"{c} rows of {n_in} do not resample by "
                         f"{up}/{down} in whole phase cycles")
    s = fir.state_len(k, up)
    for r in ([rows] if rows else [v for v in (1, 2, 4) if v <= c] or [1]):
        for (phases, chunk), span in [
                (sh, span) for sh in ([shape] if shape else SHAPES)
                for span in _spans(up, down, n_in, sh[0])]:
            nc = n_in // (span // up * down)    # cycles a row holds
            tmul, lead = _tuple_order(up, down, span, phases, chunk)
            tuples, lx, guard = _tuples(up, down, s, span, phases, lead)
            jmax = max(1, (MAX_THREADS - 32 * MIN_COPY_WARPS) // tuples)
            for q in [cycles] if cycles else sorted({-(-nc // n) for n in
                                                     range(1, nc + 1)}):
                n_tiles = -(-nc // q)
                hc = -(-(k2 - 1) // span) if k2 and n_tiles > 1 else 0
                if q < hc or q > nc:
                    continue
                window, ystride, yhead, smem = _layout(
                    up, down, s, k2, r, q, hc, span, phases, lead)
                if smem > kernels.SMEM_MAX:
                    continue
                items = -(-c // r) * n_tiles
                ctas = min(items, sms)
                groups = min(r * -(-(q + hc) // chunk), jmax)
                compute_threads = -(-tuples * groups // 32) * 32
                cost = _Cost(-(-items // ctas), _wavefronts(
                    up, down, s, span, r, q + hc, phases, chunk, groups,
                    window), 2 * r * q * span * k2, _copy_rounds(
                        r, window, MAX_THREADS - compute_threads))
                yield cost, TilePlan(
                    r, q, span, q * span, n_tiles, hc * span, window,
                    ystride, yhead, phases, tmul, *lead, lx, guard, chunk,
                    groups, compute_threads, MAX_THREADS, ctas, items, smem)


@functools.lru_cache(maxsize=256)
def _tile_plan(c: int, n_in: int, up: int, down: int, k: int, k2: int, *,
               sms: int = SMS, rows: typing.Optional[int] = None,
               cycles: typing.Optional[int] = None,
               shape: typing.Optional[tuple[int, int]] = None) -> TilePlan:
    """The plan for ``c`` rows of ``n_in`` inputs resampled by up/down
    with ``k`` taps, then (``k2`` > 0, B4) an RRC of ``k2`` taps, on a
    card of ``sms`` SMs, one block an SM: of ``_candidates``, the one the
    cost model finishes first.  ``rows``, ``cycles`` and ``shape``
    (positions, cycles a thread) pin the row group, the tile and the
    thread's outputs.  Raises ``ValueError`` when nothing fits the
    block's shared memory (``kernels.SMEM_MAX``)."""
    best = min(_candidates(c, n_in, up, down, k, k2, sms, rows, cycles,
                           shape), key=lambda cp: cp[0].clocks(),
               default=None)
    if best is None:
        raise ValueError(f"no tile of {up}/{down} with {k} taps fits "
                         f"{kernels.SMEM_MAX} bytes of shared memory a "
                         f"block (rows={rows}, cycles={cycles}, "
                         f"shape={shape})")
    return best[1]


@functools.lru_cache(maxsize=8)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _plan_args(plan: TilePlan, up: int, down: int) -> tuple[int, ...]:
    """The plan as the C entry points take it after the geometry."""
    tuples = -(-plan.span // plan.phases)
    return (plan.span, pow(down, -1, up) if up > 1 else 0, plan.phases,
            plan.tmul, pow(plan.tmul, -1, tuples) if tuples > 1 else 0,
            plan.lead_group, plan.lead_mod, plan.lx, plan.guard, plan.rows,
            plan.cycles, plan.n_tiles, plan.halo // plan.span, plan.window,
            plan.ystride, plan.yhead, plan.chunk, plan.groups,
            plan.compute_threads, plan.threads, plan.ctas, plan.items,
            plan.smem)


_PLAN_INTS = [ctypes.c_int] * 23
_ARGS = ([ctypes.c_void_p] * 15 + [ctypes.c_longlong] + [ctypes.c_int] * 5
         + _PLAN_INTS + [ctypes.c_void_p])


# ---- the tensor-core design below "highest" (csrc/rational_tc.cuh) ----

# positions a column group, window samples a k-step, outputs of one RRC
# MMA (rows of 8); ints of the kernel's table; (threads, compute threads)
# of a block, one an SM, of B4 and of B3 / B5 (RdsIo / AudioIo::kThreads);
# the fewest cycles a tile where a row splits to fill the card
TC_N, TC_K, TC_UNIT = 8, 16, 128
TC_TABLE = 3 * 256
TC_B4_BLOCK, TC_AUDIO_BLOCK = (1024, 512), (512, 256)
TC_MIN_CYCLES = 4
# the most windows in the kernel's ring (rational_tc.cuh kMaxBufs); the
# plan takes as many as fit beside the largest tile, at least 2
TC_MAX_BUFS = 3


class TcPlan(typing.NamedTuple):
    """The tensor-core design's launch (``csrc/rational_tc.cuh``).

    A cycle is ``span`` outputs (U, or 8 at U = 1) of ``step`` inputs.
    Column group g of 8 positions reads a cycle's window from ``j0_g``
    (``_tc_groups``) in ``ks`` k-steps; B4's RRC takes ``ks2``.  A
    stream's window holds ``slen`` bf16: ``lead`` zeros, then the slots,
    skewed by ``pad`` every step; a cycle row's reads ``reach`` bf16 from
    its start.  B4's RRC input takes ``rlen`` bf16 a stream, B3 / B5's
    staged outputs ``ystride`` floats; the copy warps fill a ring of
    ``bufs`` windows.  Items, tiles and the halo as ``TilePlan``'s;
    ``compute_threads`` of the block's ``threads`` compute, the rest
    copy."""
    rows: int
    cycles: int
    span: int
    tile: int
    n_tiles: int
    halo: int
    ks: int
    ks2: int
    lead: int
    pad: int
    reach: int
    slen: int
    rlen: int
    ystride: int
    bufs: int
    compute_threads: int
    threads: int
    ctas: int
    items: int
    smem: int


def _round_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _tc_ksteps(decim: int, taps: int) -> int:
    """k-steps of a Toeplitz product over rows of 8 outputs
    (``tc::ksteps``)."""
    return -(-(7 * decim + taps) // TC_K)


def _tc_groups(up: int, down: int, s: int):
    """``(span, step, starts, ks, lead, reach, pad)`` of the design at U/D
    with tails of ``s``: the cycle, each column group's first window
    sample j0_g (b of its first position rounded down to S mod 8), the
    k-steps of the widest group, the zeros before slot 0, the bf16 a cycle
    row's reads reach from its start, and the window's skew every step
    (8 where step is a multiple of 16, whose rows would share banks)."""
    span = up if up > 1 else TC_N
    step = span // up * down

    def newest(p):
        return p * step // span

    starts = [newest(8 * g) - (newest(8 * g) - s) % 8
              for g in range(-(-span // TC_N))]
    ks = max(-(-(newest(min(8 * g + 7, span - 1)) + s + 1 - j0) // TC_K)
             for g, j0 in enumerate(starts))
    lead = -s % 8
    reach = max(starts) + lead + TC_K * ks
    return span, step, starts, ks, lead, reach, 0 if step % 16 else 8


def _tc_place(v: int, step: int, pad: int) -> int:
    """Where window position ``v`` sits (``rational_tc.cuh`` place)."""
    return v + pad * (v // step)


def _tc_layout(up: int, down: int, s: int, k2: int, rows: int, cycles: int,
               halo_cycles: int, bufs: int) -> tuple[int, int, int, int]:
    """``(slen, rlen, ystride, smem)``: csrc/rational_tc.cuh's shared
    memory, in this order: the B fragments (256 bytes a group and k-step,
    B4's RRC's too), a table of TC_TABLE ints, a ring of ``bufs`` windows
    of ``2 * rows`` streams x ``slen`` bf16, and ``2 * rows`` of B4's RRC
    inputs of ``rlen`` bf16 or of B3 / B5's staged outputs of ``ystride``
    floats."""
    span, step, starts, ks, lead, reach, pad = _tc_groups(up, down, s)
    ncyc = cycles + halo_cycles
    vend = max(lead + s + ncyc * step, (ncyc - 1) * step + reach)
    slen = _round_to(_tc_place(vend - 1, step, pad) + 1, 8)
    ks2 = _tc_ksteps(1, k2) if k2 else 0
    rlen = (_round_to(cycles * span + 7, TC_UNIT) - 8 + TC_K * ks2
            if k2 else 0)
    ystride = 0 if k2 else _r4(cycles * span)
    smem = (256 * (len(starts) * ks + ks2) + 4 * TC_TABLE
            + 4 * bufs * rows * slen + 4 * rows * rlen + 8 * rows * ystride)
    return slen, rlen, ystride, smem


@functools.lru_cache(maxsize=256)
def _tc_plan(c: int, n_in: int, up: int, down: int, k: int, k2: int, *,
             sms: int = SMS, rows: typing.Optional[int] = None,
             cycles: typing.Optional[int] = None) -> TcPlan:
    """The tensor-core design's plan for ``c`` rows of ``n_in`` inputs
    (``k2`` > 0: B4 and its RRC), a rule: blocks of TC_B4_BLOCK /
    TC_AUDIO_BLOCK threads; items of one row (``rows`` pins it); a row in
    as many tiles as fill the card's ``sms`` where the
    rows alone do not (a tile at least TC_MIN_CYCLES cycles and twice B4's
    halo), in more where its item would not fit the block's shared memory
    (``kernels.SMEM_MAX``); ``cycles`` pins the tile.  B4's tiles after
    the first recompute a halo of whole cycles, at least K2 - 1 + 7
    outputs (its RRC rows start at multiples of 8).  Raises ``ValueError``
    for rows that do not hold whole cycles, or where nothing fits."""
    if c < 1 or up < 1 or math.gcd(up, down) != 1 or (n_in * up) % down:
        raise ValueError(f"{c} rows of {n_in} do not resample by "
                         f"{up}/{down} in whole phase cycles")
    s = fir.state_len(k, up)
    span, step = _tc_groups(up, down, s)[:2]
    if n_in % step or n_in < s:
        raise ValueError(f"rows of {n_in} inputs do not hold whole cycles "
                         f"of {step} inputs ({span} outputs) and the "
                         f"{s}-sample tail")
    nc = n_in // step
    rows = rows or 1
    halo_tiled = -(-(k2 - 1 + TC_N - 1) // span) if k2 else 0
    if cycles:
        options = [cycles]
    else:
        fill = min(-(-sms // -(-c // rows)),
                   max(1, nc // max(TC_MIN_CYCLES, 2 * halo_tiled)))
        options = sorted({-(-nc // n) for n in range(fill, nc + 1)},
                         reverse=True)
    for q in options:
        n_tiles = -(-nc // q)
        hc = halo_tiled if n_tiles > 1 else 0
        if q < hc or q > nc:
            continue
        for bufs in range(TC_MAX_BUFS, 1, -1):
            slen, rlen, ystride, smem = _tc_layout(up, down, s, k2, rows, q,
                                                   hc, bufs)
            if smem <= kernels.SMEM_MAX:
                break
        else:
            continue
        items = -(-c // rows) * n_tiles
        _, _, _, ks, lead, reach, pad = _tc_groups(up, down, s)
        threads, compute_threads = TC_B4_BLOCK if k2 else TC_AUDIO_BLOCK
        return TcPlan(rows, q, span, q * span, n_tiles, hc * span, ks,
                      _tc_ksteps(1, k2) if k2 else 0, lead, pad, reach, slen,
                      rlen, ystride, bufs, compute_threads, threads,
                      min(items, sms), items, smem)
    raise ValueError(f"no tile of {up}/{down} with {k} taps fits "
                     f"{kernels.SMEM_MAX} bytes of shared memory a block "
                     f"on the tensor cores (rows={rows}, cycles={cycles})")


def _tc_plan_args(plan: TcPlan, up: int, down: int) -> tuple[int, ...]:
    """The tensor-core plan as the ``_tc`` entry points take it after the
    geometry."""
    return (plan.span, pow(down, -1, up) if up > 1 else 0, plan.ks,
            plan.lead, plan.pad, plan.reach, plan.slen, plan.rows,
            plan.cycles,
            plan.n_tiles, plan.halo // plan.span, plan.rlen, plan.ystride,
            plan.bufs, plan.compute_threads, plan.threads, plan.ctas,
            plan.items, plan.smem)


_TC_INTS = [ctypes.c_int] * 19
_TC_ARGS = ([ctypes.c_void_p] * 15 + [ctypes.c_longlong] + [ctypes.c_int] * 5
            + _TC_INTS + [ctypes.c_void_p])
_AUDIO_TC_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 4 + _TC_INTS + [ctypes.c_void_p])
_BLOCKS_ARGS = [ctypes.c_int] * 4 + [ctypes.c_longlong]


def _plan_for(c: int, n: int, up: int, down: int, k: int, k2: int,
              plan, precision: str, dev: torch.device):
    """The plan of the design ``precision`` runs (the tensor-core one
    below "highest"): ``plan`` where given, which must be of that
    design, else the rule's (``_tc_plan``) or the cost model's
    (``_tile_plan``)."""
    tc = rounds(precision)
    if plan is None:
        return (_tc_plan if tc else _tile_plan)(max(c, 1), n, up, down, k,
                                                 k2, sms=_sms(dev))
    if isinstance(plan, TcPlan) != tc:
        raise ValueError(f"a {type(plan).__name__} does not run at "
                         f"precision {precision!r}")
    return plan


def fused_rds_backend_plain(rds_delayed, nco_i, nco_q, h_lpf, h_rrc,
                            lpf_tail_i, lpf_tail_q, rrc_tail_i, rrc_tail_q,
                            up: int, down: int, precision: str = "highest"):
    """Plain torch version of ``fused_rds_backend`` (any leading batch
    dims, any device): the I and Q legs ride a stacked lane through one
    resampler call and one RRC call, their inputs, histories and taps
    rounded below "highest"."""
    rnd = rounding(precision)
    mixed = torch.stack([mix.mix(nco_i, rds_delayed, gain=1.0),
                         mix.mix(nco_q, rds_delayed, gain=1.0)], dim=-2)
    lpf_tails = torch.stack([lpf_tail_i, lpf_tail_q], dim=-2)
    lp, _ = fir.block_fir_resample(rnd(mixed), taps(h_lpf, precision),
                                   rnd(lpf_tails), up=up, down=down)
    lpf_tails = fir.tail(mixed, lpf_tails.shape[-1])
    rrc_tails = torch.stack([rrc_tail_i, rrc_tail_q], dim=-2)
    bb, _ = fir.block_fir(rnd(lp), taps(h_rrc, precision), rnd(rrc_tails))
    rrc_tails = fir.tail(lp, rrc_tails.shape[-1])
    return (bb[..., 0, :], bb[..., 1, :], lpf_tails[..., 0, :],
            lpf_tails[..., 1, :], rrc_tails[..., 0, :], rrc_tails[..., 1, :])


def fused_rds_backend(rds_delayed, nco_i, nco_q, h_lpf, h_rrc, lpf_tail_i,
                      lpf_tail_q, rrc_tail_i, rrc_tail_q, up: int,
                      down: int, precision: str = "highest"):
    """Returns ``(bb_i, bb_q, new_lpf_tail_i, new_lpf_tail_q,
    new_rrc_tail_i, new_rrc_tail_q)``: the kernel for CUDA tensors, the
    plain version for CPU ones.

    ``rds_delayed``, ``nco_i``, ``nco_q``: [C, N]; ``h_lpf`` [K];
    ``h_rrc`` [K2]; LPF tails [C, (K-1)//up]; RRC tails [C, K2-1]; all
    float32 and contiguous.  ``bb_i``/``bb_q``: [C, N*up/down].
    ``precision``: "highest" (default), "high" or "default" (the module
    docstring says what it rounds).
    """
    args = (rds_delayed, nco_i, nco_q, h_lpf, h_rrc, lpf_tail_i, lpf_tail_q,
            rrc_tail_i, rrc_tail_q)
    if rds_delayed.device.type == "cpu":
        return fused_rds_backend_plain(*args, up, down, precision)
    return _rds_launch(args, up, down, precision=precision)


def _rds_launch(args, up: int, down: int,
                plan: typing.Union[TilePlan, TcPlan, None] = None,
                precision: str = "highest"):
    """B4 on CUDA tensors ``args`` (``fused_rds_backend``'s first nine)
    at ``precision`` under ``plan`` (``_plan_for``: the tensor-core
    design's ``TcPlan`` below "highest", else a ``TilePlan``; the rule's
    or the cost model's by default): one launch."""
    rds_delayed, _, _, h_lpf, h_rrc = args[:5]
    c, n = rds_delayed.shape
    k, k2 = h_lpf.shape[0], h_rrc.shape[0]
    s = fir.state_len(k, up)
    m = n * up // down
    if (n * up) % down or n < s or m < k2 - 1 or k2 < 1:
        raise ValueError(f"block of {n} samples does not resample by "
                         f"{up}/{down} into at least {k2 - 1} outputs")
    dev = rds_delayed.device
    for t, name, shape in zip(args, ("rds_delayed", "nco_i", "nco_q",
                                     "h_lpf", "h_rrc", "lpf_tail_i",
                                     "lpf_tail_q", "rrc_tail_i",
                                     "rrc_tail_q"),
                              ((c, n),) * 3 + ((k,), (k2,)) + ((c, s),) * 2
                              + ((c, k2 - 1),) * 2):
        kernels.require(t, name, shape, device=dev)
    plan = _plan_for(c, n, up, down, k, k2, plan, precision, dev)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=dev)
    outs = [new(c, m), new(c, m), new(c, s), new(c, s), new(c, k2 - 1),
            new(c, k2 - 1)]
    if isinstance(plan, TcPlan):
        fn = kernels.entry("rds_backend", "dy4_rds_backend_tc", _TC_ARGS)
        plan_args = _tc_plan_args(plan, up, down)
    else:
        fn = kernels.entry("rds_backend", "dy4_rds_backend", _ARGS)
        plan_args = _plan_args(plan, up, down)
    with torch.cuda.device(dev):
        status = fn(*(t.data_ptr() for t in args),
                    *(t.data_ptr() for t in outs), c, n, up, down, k, k2,
                    *plan_args, kernels.stream_of(rds_delayed))
    kernels.check_launch(status, "rds_backend fused_rds_backend")
    fused_rds_backend.launches += 1
    return tuple(outs)


fused_rds_backend.launches = 0

_AUDIO_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong]
               + [ctypes.c_int] * 4 + _PLAN_INTS + [ctypes.c_void_p])


def fused_audio_backend_rational_plain(fm_delayed, stereo_band, nco,
                                       h_audio, mono_tail, stereo_tail,
                                       up: int, down: int,
                                       precision: str = "highest"):
    """Plain torch version of ``fused_audio_backend_rational`` (any
    leading batch dims, any device), and at ``up`` = 1 of
    ``backend_cuda.fused_audio_backend``: mix, one stacked rational
    resampler call over the mono and stereo legs (their inputs, histories
    and taps rounded below "highest"), stereo matrix."""
    rnd = rounding(precision)
    stereo_mixed = mix.mix(nco, stereo_band, gain=2.0)
    audio_in = torch.stack([fm_delayed, stereo_mixed], dim=-2)
    tails = torch.stack([mono_tail, stereo_tail], dim=-2)
    out, _ = fir.block_fir_resample(rnd(audio_in), taps(h_audio, precision),
                                    rnd(tails), up=up, down=down)
    tails = fir.tail(audio_in, tails.shape[-1])
    mono, stereo_lp = out[..., 0, :], out[..., 1, :]
    left, right = mix.stereo_matrix(mono, stereo_lp)
    return mono, left, right, tails[..., 0, :], tails[..., 1, :]


def fused_audio_backend_rational(fm_delayed, stereo_band, nco, h_audio,
                                 mono_tail, stereo_tail, up: int,
                                 down: int, precision: str = "highest"):
    """Returns ``(mono, left, right, new_mono_tail, new_stereo_tail)``:
    the kernel for CUDA tensors, the plain version for CPU ones.

    ``fm_delayed``, ``stereo_band``, ``nco``: [C, N]; ``h_audio`` [K];
    tails [C, (K-1)//up]; all float32 and contiguous.  Outputs
    [C, N*up/down].  ``precision`` as for ``fused_rds_backend``.
    """
    args = (fm_delayed, stereo_band, nco, h_audio, mono_tail, stereo_tail)
    if fm_delayed.device.type == "cpu":
        return fused_audio_backend_rational_plain(*args, up, down, precision)
    outs = _audio_launch(args, up, down, precision=precision)
    fused_audio_backend_rational.launches += 1
    return outs


def _audio_launch(args, up: int, down: int,
                  plan: typing.Union[TilePlan, TcPlan, None] = None,
                  precision: str = "highest"):
    """B5, or B3 at ``up`` = 1, on CUDA tensors ``args``
    (``fused_audio_backend_rational``'s first six) at ``precision`` under
    ``plan`` (as ``_rds_launch``'s): one launch, which the calling wrapper
    counts."""
    fm_delayed, h_audio = args[0], args[3]
    c, n = fm_delayed.shape
    k = h_audio.shape[0]
    s = fir.state_len(k, up)
    if (n * up) % down or n < s:
        raise ValueError(f"block of {n} samples does not resample by "
                         f"{up}/{down} or is shorter than the {s}-sample "
                         f"tail")
    dev = fm_delayed.device
    for t, name, shape in zip(args, ("fm_delayed", "stereo_band", "nco",
                                     "h_audio", "mono_tail", "stereo_tail"),
                              ((c, n),) * 3 + ((k,),) + ((c, s),) * 2):
        kernels.require(t, name, shape, device=dev)
    plan = _plan_for(c, n, up, down, k, 0, plan, precision, dev)
    m = n * up // down
    outs = ([torch.empty(c, m, dtype=torch.float32, device=dev)
             for _ in range(3)]
            + [torch.empty(c, s, dtype=torch.float32, device=dev)
               for _ in range(2)])
    if isinstance(plan, TcPlan):
        fn = kernels.entry("audio_rational", "dy4_audio_rational_tc",
                           _AUDIO_TC_ARGS)
        plan_args = _tc_plan_args(plan, up, down)
    else:
        fn = kernels.entry("audio_rational", "dy4_audio_rational",
                           _AUDIO_ARGS)
        plan_args = _plan_args(plan, up, down)
    with torch.cuda.device(dev):
        status = fn(*(t.data_ptr() for t in args),
                    *(t.data_ptr() for t in outs), c, n, up, down, k,
                    *plan_args, kernels.stream_of(fm_delayed))
    kernels.check_launch(status, f"audio_rational at {up}/{down}")
    return tuple(outs)


fused_audio_backend_rational.launches = 0

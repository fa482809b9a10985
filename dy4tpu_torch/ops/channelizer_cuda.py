"""The wideband channelizer's polyphase branch FIRs: the CUDA kernel B7
(``csrc/channelizer.cu``) and its plain torch version.

Replaces the Pallas kernel of ``dy4tpu/ops/channelizer.py ::
channelize_block_u8``: raw interleaved u8 -> normalize onto the carried
tail -> C branch FIRs of T taps, giving ``w [bands, M, 2C]`` with the I/Q
pair axis riding through (column ``2r' + leg`` holds branch ``C-1-r'``).
The length-C DFT across the branches is not the kernel's business: the
caller contracts ``w`` with the widened ``[C, 2C]`` DFT matrices
(``channelizer.channelize_block_u8``).

The kernel is a register-blocked column FIR over staged u8 tiles: blocks
walk (band, tile of rows) items, copying the next item's raw u8 window
into shared memory while they compute this one; a thread takes units of
R rows of one column of ``w``, holds that column's taps in registers and
slides over the unit's window.  ``_tile_plan`` sizes it.  Every output
is one chain of FMAs in the plain version's order of taps, so every plan
gives the same bits.

``channelize_branches`` takes CUDA tensors only and raises on any other:
the choice of route is ``channelize_block_u8``'s (``impl="auto"``: this
kernel for a CUDA tensor, the plain route for a CPU one).

Both take dy4tpu's ``precision=`` (``ops/precision.py``), "highest" by
default, the receiver's default (dy4tpu's ``channelize_block_u8`` defaults
to HIGHEST too).  Below "highest" the branch taps are rounded to bf16, as
dy4tpu's kernel rounds ``p / 128`` with the u8 normalisation folded in;
the u8 window and the carried tail are exact in bf16, so the kernel is
unchanged.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import typing

import torch

from dy4tpu_torch.ops.precision import taps
from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

# csrc/channelizer.cu's bounds: threads a block (launch bounds 512 x 2
# blocks an SM, so 64 registers a thread) and the rows a unit may take
# (its instantiations)
MAX_THREADS = 512
ROWS = (4, 8, 12, 16)
# the plan's block: 256 threads, four an SM at 64 registers a thread
THREADS = 256
# threads an SM holds at 64 registers a thread; shared memory of an SM
# and what the card keeps of it for each block; the H100's SMs (the
# default; the wrapper asks the device)
SM_THREADS = 1024
SM_SMEM, BLOCK_SMEM = 233472, 1024
SMS = 132

_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
         + [ctypes.c_void_p])


class TilePlan(typing.NamedTuple):
    """B7's launch (``csrc/channelizer.cu``): ``ctas`` blocks of
    ``threads`` walk ``items`` = bands x ``n_tiles`` items, each ``tile``
    rows of one band (a band's last tile may be shorter); a thread takes
    units of ``rows`` consecutive rows of one column.  ``smem``: bytes of
    dynamic shared memory a block takes."""
    rows: int
    tile: int
    n_tiles: int
    items: int
    threads: int
    ctas: int
    smem: int


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _tap_group(t: int) -> int:
    """G, the taps the kernel holds in registers at once: T rounded up to
    4, or 16 above 16 taps."""
    return -(-t // 4) * 4 if t <= 16 else 16


def _tap_bound(t: int) -> int:
    """TM, the taps the kernel runs: T rounded up to G, the first TM - T
    of them zero."""
    g = _tap_group(t)
    return -(-t // g) * g


def _head_bytes(c: int, t: int) -> int:
    """``head_bytes`` of csrc/channelizer.cu: a stage's head, the carried
    tail interleaved as float32 (2(K-1) floats, padded to 16 bytes),
    staged where the two heads take at most a quarter of a block's shared
    memory; else 0 (a unit then reads the tail from device memory)."""
    head = _r16(4 * (2 * c * t - 2))
    return head if 2 * head <= kernels.SMEM_MAX // 4 else 0


def _smem_bytes(c: int, t: int, rows: int, tile: int) -> int:
    """``smem_bytes`` of csrc/channelizer.cu: two stages, each a head and
    a u8 window of (tile + rows + TM - 2) rows of 2C bytes and 15 bytes of
    alignment, padded to 16 bytes."""
    return 2 * (_head_bytes(c, t)
                + _r16(15 + (tile + rows + _tap_bound(t) - 2) * 2 * c))


def _fits(smem: int, per_sm: int) -> bool:
    """``per_sm`` blocks of ``smem`` bytes fit an SM and the card's
    block limit."""
    return smem <= kernels.SMEM_MAX and per_sm * (smem + BLOCK_SMEM) <= SM_SMEM


@functools.lru_cache(maxsize=256)
def _tile_plan(bands: int, m: int, c: int, t: int, sms: int = SMS, *,
               rows: typing.Optional[int] = None,
               tile: typing.Optional[int] = None,
               threads: typing.Optional[int] = None,
               ctas: typing.Optional[int] = None) -> TilePlan:
    """The plan for ``bands`` rows of ``m`` rows of w through C branches
    of T taps on a card of ``sms`` SMs.  Blocks of ``THREADS``, as many
    an SM as its threads and shared memory allow, one round of them at
    once (the blocks walk the items, prefetching, where there are more).
    R: the largest of ``ROWS`` whose units fill at least half of such a
    round's threads, else 4 (and smaller where the stages would not fit
    the card).  Tiles of whole passes of the block (each thread a unit):
    the count of passes p that finishes first, rounds x (p + 1), the one
    for an item's copy wait and barriers; of equals, the fewest items.
    ``rows``, ``tile``, ``threads`` and ``ctas`` pin those.  Raises
    ``ValueError`` on a geometry the kernel does not take and when
    nothing fits the shared memory."""
    c2 = 2 * c
    nt = threads or THREADS
    if bands < 1 or not 1 <= m <= 2 ** 30 or c < 1 or t < 1 \
            or not (32 <= nt <= MAX_THREADS and nt % 32 == 0) \
            or rows not in (None, *ROWS):
        raise ValueError(f"B7 takes at least one band, row and tap, under "
                         f"2^30 rows a band, blocks of 32 to {MAX_THREADS} "
                         f"threads in whole warps and units of {ROWS} rows, "
                         f"not {bands} x {m} rows of 2C = {c2} at T = {t} "
                         f"in blocks of {nt}, units of {rows}")
    first = rows or next((r for r in reversed(ROWS) if bands * -(-m // r)
                          * c2 * 2 >= sms * SM_THREADS), ROWS[0])
    best, need = None, None
    for r in [first] + [r for r in reversed(ROWS) if r < first] * (not rows):
        for passes in itertools.count(1):
            tl = tile or min(m, r * -(-passes * nt // c2))
            smem = _smem_bytes(c, t, r, tl)
            per_sm = next((k for k in range(SM_THREADS // nt, 0, -1)
                           if _fits(smem, k)), 0)
            if not per_sm:
                need = (tl, smem)
                break
            items = bands * -(-m // tl)
            cost = (-(-items // (sms * per_sm))
                    * (-(-(-(-tl // r) * c2) // nt) + 1), items)
            if best is None or cost < best[0]:
                best = (cost, TilePlan(r, tl, -(-m // tl), items, nt,
                                       min(items, sms * per_sm), smem))
            if tile or tl >= m:
                break
        if best:
            break
    if best is None or not 1 <= best[1].tile <= m:
        tl, smem = need or (tile, 0)
        raise ValueError(f"B7: no plan for {bands} x {m} rows at C = {c}, "
                         f"T = {t}: a block of tiles of {tl} rows needs "
                         f"{smem} bytes of shared memory, the card allows "
                         f"{kernels.SMEM_MAX}")
    plan = best[1]
    if ctas and not 1 <= ctas <= plan.items:
        raise ValueError(f"B7: {ctas} blocks for {plan.items} items")
    return plan._replace(ctas=ctas) if ctas else plan


@functools.lru_cache(maxsize=8)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=1)
def _entry():
    """The C entry point, its argument types set once."""
    return kernels.entry("channelizer", "dy4_channelizer", _ARGS)


def _launch_array(bands: int, n2: int, c: int, t: int,
                  plan: TilePlan) -> ctypes.Array:
    """The C entry point's `launch`: the geometry, then the plan's fields
    in their order."""
    return (ctypes.c_longlong * 11)(bands, n2, c, t, *plan)


@functools.lru_cache(maxsize=256)
def _launch_args(bands: int, n2: int, c: int, t: int,
                 sms: int) -> ctypes.Array:
    """The launch array of the wrapper's call under ``_tile_plan``'s plan,
    made once a geometry, after ``kernels.check_smem`` (which raises, and
    so caches nothing, where a block needs more shared memory than the
    card has)."""
    plan = _tile_plan(max(bands, 1), n2 // (2 * c), c, t, sms)
    kernels.check_smem("channelizer", "dy4_channelizer_smem",
                       "channelize_branches", c, t, plan.rows, plan.tile)
    return _launch_array(bands, n2, c, t, plan)


def branch_fir_interleaved(p: Tensor, tail_i: Tensor, tail_q: Tensor,
                           x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The branch FIRs over interleaved float32 IQ, the math of dy4tpu's
    ``channelize_block_interleaved`` before its DFT.

    ``p`` [C, T] (``p[r, q] = h[qC + r]``); ``tail_i``/``tail_q``
    [..., C*T-1] planar; ``x`` [..., 2 n_w] normalized, I even / Q odd,
    ``C | n_w``.  Returns ``(w [..., n_w/C, 2C], tail_i, tail_q)``, the new
    tails being the last C*T-1 complex samples of ``[tail || x]``."""
    c, t = p.shape
    k = c * t
    n2 = x.shape[-1]
    if n2 % (2 * c):
        raise ValueError(f"{n2} interleaved samples are not a multiple of "
                         f"2C = {2 * c}")
    m = n2 // (2 * c)
    tail = torch.stack([tail_i, tail_q], dim=-1)
    tail = tail.reshape(*tail.shape[:-2], 2 * (k - 1))
    ext = torch.cat([tail, x], dim=-1)                  # [..., 2(n_w+K-1)]
    seg = ext[..., : (m + t - 1) * 2 * c]
    seg = seg.reshape(*seg.shape[:-1], m + t - 1, 2 * c)
    # column j = 2r' + leg holds branch r = C-1-r': tap vector p[C-1-r', :]
    pcol = torch.repeat_interleave(p.flip(0), 2, dim=0)  # [2C, T]
    w = torch.zeros((*seg.shape[:-2], m, 2 * c), dtype=seg.dtype,
                    device=seg.device)
    for q in range(t):                                   # T multiply-adds
        w = w + pcol[:, q] * seg[..., t - 1 - q: t - 1 - q + m, :]
    new_tail = ext[..., -2 * (k - 1):]
    new_tail = new_tail.reshape(*new_tail.shape[:-1], k - 1, 2)
    return w, new_tail[..., 0], new_tail[..., 1]


def channelize_branches_plain(x_u8: Tensor, p: Tensor, tail_i: Tensor,
                              tail_q: Tensor, precision: str = "highest"
                              ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain torch version of ``channelize_branches`` (any leading batch
    dims, any device): ``(x - 128) / 128``, then
    ``branch_fir_interleaved`` (its taps rounded below "highest")."""
    x = (x_u8.to(torch.float32) - 128.0) / 128.0
    return branch_fir_interleaved(taps(p, precision), tail_i, tail_q, x)


def _takes(t: Tensor, shape: tuple, dtype: torch.dtype,
           dev: torch.device) -> bool:
    """``t`` is what the kernel takes: a contiguous tensor of ``shape`` and
    ``dtype`` on ``dev`` (the cheap test; ``kernels.require`` says what
    is wrong)."""
    return (t.dtype == dtype and t.shape == shape and t.device == dev
            and t.is_contiguous())


def channelize_branches(x_u8: Tensor, p: Tensor, tail_i: Tensor,
                        tail_q: Tensor, precision: str = "highest"
                        ) -> tuple[Tensor, Tensor, Tensor]:
    """The branch FIRs of one wideband block through the kernel.

    ``x_u8`` [bands, 2 n_w] uint8 with ``C | n_w`` and ``n_w >= C``;
    ``p`` [C, T]; ``tail_i``/``tail_q`` [bands, C*T-1] float32, all
    contiguous CUDA tensors on one device.  Returns ``(w [bands, n_w/C,
    2C], tail_i, tail_q)`` as ``channelize_branches_plain`` does, under
    ``_tile_plan``'s plan, its taps rounded below "highest".  Raises on a
    tensor that is not on a CUDA device, on a geometry the kernel does not
    take, and when a block would need more shared memory than the card
    has.
    """
    if x_u8.dim() != 2 or p.dim() != 2:
        raise ValueError(f"expected x_u8 [bands, 2 n_w] and p [C, T], got "
                         f"{tuple(x_u8.shape)} and {tuple(p.shape)}")
    bands, n2 = x_u8.shape
    c, t = p.shape
    k = c * t
    if n2 % (2 * c) or n2 < 2 * c:
        raise ValueError(f"band rows of {n2} bytes: the kernel takes a "
                         f"positive multiple of 2C = {2 * c}")
    m = n2 // (2 * c)
    dev = x_u8.device
    f32 = torch.float32
    if not (x_u8.is_cuda and _takes(x_u8, (bands, n2), torch.uint8, dev)
            and _takes(p, (c, t), f32, dev)
            and _takes(tail_i, (bands, k - 1), f32, dev)
            and _takes(tail_q, (bands, k - 1), f32, dev)):
        kernels.require(x_u8, "x_u8", (bands, n2), torch.uint8, dev)
        kernels.require(p, "p", (c, t), device=dev)
        kernels.require(tail_i, "tail_i", (bands, k - 1), device=dev)
        kernels.require(tail_q, "tail_q", (bands, k - 1), device=dev)
    launch = _launch_args(bands, n2, c, t, _sms(dev))
    p = taps(p, precision)
    w = torch.empty(bands, m, 2 * c, dtype=f32, device=dev)
    new_i = torch.empty(bands, k - 1, dtype=f32, device=dev)
    new_q = torch.empty(bands, k - 1, dtype=f32, device=dev)
    # a device switch costs more host time than the kernel takes at small
    # geometries: only where the tensors are not on the current device
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        status = _entry()(x_u8.data_ptr(), p.data_ptr(), tail_i.data_ptr(),
                          tail_q.data_ptr(), w.data_ptr(), new_i.data_ptr(),
                          new_q.data_ptr(), launch, kernels.stream_of(x_u8))
    kernels.check_launch(status, "channelizer channelize_branches")
    channelize_branches.launches += 1
    return w, new_i, new_q


channelize_branches.launches = 0

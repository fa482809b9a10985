"""B14, the decimating block FIR as a CUDA kernel (``csrc/fir.cu``), and
its plain torch version.

``block_fir_decim`` replaces ``dy4tpu/ops/fir_pallas.py ::
block_fir_decim_pallas``: ``x [..., N]`` float32 with ``N % D == 0``,
``h [K]``, ``state [..., K-1]`` -> ``y [..., N/D]`` and the last K-1
inputs as the new state, exactly.  Its plain version is ``fir.py``'s
conv1d (``fir.block_fir_decim(impl="plain")``), which is also the one
PyTorch call computing the same function.  dy4tpu's ``K/D <= 128`` limit
is a TPU window margin and is not copied.  No receiver route runs it, in
dy4tpu or here: ``fir.block_fir_decim(..., impl="kernel")`` does.

The kernel runs on a (row, tile) grid from ``_fir_plan``: a block owns a
tile of one row's outputs, fills its passes' polyphase windows by
asynchronous copies through a ring of ``stages`` while it multiplies, and
sums each output in ``csrc/rf_stage.cuh``'s order, so every plan gives the
same bits (see the note in ``csrc/fir.cu``).
"""

from __future__ import annotations

import ctypes
import functools
import typing

import torch

from dy4tpu_torch.ops import fir
# rf_stage.cuh's window layout, which B14 shares with B1 and B11-B13
from dy4tpu_torch.ops.frontend_cuda import _phase_taps, _round4, _window_row
from dy4tpu_torch.runtime import kernels

Tensor = torch.Tensor

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]

# csrc/fir.cu's block: threads; the most outputs a tile owns, the fewest it
# is cut to where the grid is short, the most a pass takes (4 a thread);
# the ring's most stages
FIR_THREADS, FIR_TILE, FIR_MIN_TILE = 128, 1024, 128
FIR_SUB, FIR_MAX_STAGES = 4 * FIR_THREADS, 3
MAX_TILES = 65535                    # grid.y
# an H100: SMs, shared memory and threads of one SM, the shared memory the
# card keeps for itself a block
SMS, SM_BYTES, SM_THREADS, BLOCK_RESERVED = 132, 233472, 2048, 1024


class FirPlan(typing.NamedTuple):
    """B14's grid: ``n_tiles`` tiles of ``tile`` outputs a row (the last
    one ragged), a block each, in passes of ``sub`` outputs through a ring
    of ``stages`` pass windows."""
    tile: int
    n_tiles: int
    sub: int
    stages: int


def _fir_smem_bytes(decim: int, k: int, sub: int, stages: int) -> int:
    """Shared memory one B14 block takes: ``dy4_fir_decim_smem``'s formula
    (``csrc/fir.cu``): the taps by phase and the ring of windows."""
    nq = _phase_taps(decim, k)
    return 4 * (decim * nq + stages * decim * _window_row(sub + nq))


def _blocks_an_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes that share one SM."""
    return min(SM_THREADS // FIR_THREADS,
               SM_BYTES // (smem + BLOCK_RESERVED))


@functools.lru_cache(maxsize=256)    # a call's plan costs the host ~5 us
def _fir_plan(n_out: int, decim: int, k: int, *, rows: int = 1,
              sms: int = SMS, tile: int | None = None,
              sub: int | None = None,
              stages: int | None = None) -> FirPlan:
    """B14's plan for ``rows`` rows of ``n_out`` outputs through ``k`` taps
    decimating by ``decim`` on a card of ``sms`` SMs (``tile`` / ``sub`` /
    ``stages`` pin it).  A rule:

      * tiles: the row splits evenly into the fewest tiles of at most
        ``FIR_TILE`` outputs, or, where that grid holds fewer than two
        blocks an SM, into more, down to ``FIR_MIN_TILE`` outputs;
      * passes: a tile splits evenly into the fewest of at most
        ``FIR_SUB`` outputs (4 a thread);
      * the ring: two stages where every block of the grid fits on the
        card at once with two, else one, so that the most blocks share an
        SM (on the H100 blocks an SM outweigh the ring: chip_smoke.py's
        sweep);
      * where the block overflows the shared memory, the pass halves down
        to 4 outputs, then the ring drops to one stage.

    Never raises: a geometry whose block cannot fit even so is the
    wrapper's ``check_smem``'s to refuse, and no geometry the first port's
    block fitted is one."""
    def even(total: int, parts: int) -> int:   # `total` in `parts` parts
        return -(-total // max(1, parts))

    if tile is None:
        parts = -(-n_out // FIR_TILE)
        if rows * parts < 2 * sms:
            parts = max(parts, min(-(-2 * sms // max(1, rows)),
                                   -(-n_out // FIR_MIN_TILE)))
        tile = max(1, even(n_out, parts), -(-n_out // MAX_TILES))
    n_tiles = -(-n_out // tile)
    s0 = sub or _round4(even(tile, -(-tile // FIR_SUB)))
    if stages is None:
        grid = rows * n_tiles
        stages = 2 if grid <= sms * _blocks_an_sm(
            _fir_smem_bytes(decim, k, s0, 2)) else 1
    plan = None
    for st in range(stages, 0, -1):
        s = s0
        while (sub is None and s > 4
               and _fir_smem_bytes(decim, k, s, st) > kernels.SMEM_MAX):
            s = max(4, _round4(s // 2))
        plan = FirPlan(tile, n_tiles, s, st)
        if _fir_smem_bytes(decim, k, s, st) <= kernels.SMEM_MAX:
            break
    return plan


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def block_fir_decim_plain(x: Tensor, h: Tensor, state: Tensor,
                          decim: int) -> tuple[Tensor, Tensor]:
    """The plain version: ``fir.block_fir_decim``'s conv1d, any device."""
    return fir.block_fir_decim(x, h, state, decim, impl="plain")


def _launch(x: Tensor, h: Tensor, state: Tensor, decim: int,
            plan: FirPlan | None = None) -> tuple[Tensor, Tensor]:
    """Check the inputs and launch B14 under ``plan`` (``_fir_plan``'s by
    default).  Counts no launch.  Returns ``(y, new_state)``."""
    k = h.shape[0]
    n = x.shape[-1]
    batch = x.shape[:-1]
    if state.shape != (*batch, k - 1):
        raise ValueError(f"state: expected shape {(*batch, k - 1)}, got "
                         f"{tuple(state.shape)}")
    if n % decim:
        raise ValueError(f"block length {n} not divisible by {decim}")
    if n < k - 1:
        raise ValueError(f"block length {n} shorter than carried state "
                         f"{k - 1}; use a larger block")
    dev = x.device
    kernels.require(x, "x", x.shape, device=dev)
    kernels.require(h, "h", (k,), device=dev)
    kernels.require(state, "state", state.shape, device=dev)
    rows = x.numel() // n if n else 0
    if plan is None:
        plan = _fir_plan(n // decim, decim, k, rows=rows,
                         sms=_sms(dev.index or 0))
    kernels.check_smem("fir", "dy4_fir_decim_smem", "block_fir_decim", decim,
                       k, plan.sub, plan.stages)
    y = torch.empty((*batch, n // decim), dtype=torch.float32, device=dev)
    new_state = torch.empty_like(state)
    fn = kernels.entry("fir", "dy4_fir_decim", _ARGS)
    with torch.cuda.device(dev):
        status = fn(x.data_ptr(), h.data_ptr(), state.data_ptr(),
                    y.data_ptr(), new_state.data_ptr(), rows, n, decim, k,
                    plan.tile, plan.sub, plan.stages,
                    kernels.stream_of(x))
    kernels.check_launch(status, f"fir block_fir_decim {plan}")
    return y, new_state


def block_fir_decim(x: Tensor, h: Tensor, state: Tensor,
                    decim: int) -> tuple[Tensor, Tensor]:
    """B14 for CUDA tensors, ``block_fir_decim_plain`` for CPU ones; any
    leading batch dims on ``x`` and ``state`` (flattened to rows for the
    kernel).  Returns ``(y, new_state)``, both contiguous on the card."""
    if x.device.type == "cpu":
        return block_fir_decim_plain(x, h, state, decim)
    out = _launch(x, h, state, decim)
    block_fir_decim.launches += 1
    return out


block_fir_decim.launches = 0

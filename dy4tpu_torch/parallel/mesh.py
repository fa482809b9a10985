"""The ``(ch, time)`` device mesh: the counterpart of
``dy4tpu/parallel/mesh.py``.

A JAX mesh is one global object over all devices.  In torch every process
drives one device and holds only its own shard, so the port's ``Mesh`` is
this process's view: its coordinates on the two axes, its device, and the
``torch.distributed`` subgroup of each axis (the ranks that share its
channel slice and differ in time, and the reverse).  Ranks are laid out
time-minor, rank = c * T + t, as dy4tpu orders its devices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

CH_AXIS = "ch"
TIME_AXIS = "time"


class Mesh:
    """This process's slot in a ``(ch, time)`` mesh.

    ``shape`` maps each axis name to its size, as a JAX mesh's does;
    ``ch_index`` and ``time_index`` are this rank's coordinates, ``device``
    its device.  ``time_group`` / ``ch_group`` are the ``torch.distributed``
    subgroups along each axis (None on a mesh of one process), and
    ``time_ranks`` the global ranks of this rank's time row, in time order
    (the peers of the halo exchange)."""

    def __init__(self, ch: int, time: int, ch_index: int, time_index: int,
                 device: torch.device, time_group=None, ch_group=None,
                 time_ranks: Sequence[int] = (0,)):
        self.shape = {CH_AXIS: ch, TIME_AXIS: time}
        self.ch_index = ch_index
        self.time_index = time_index
        self.device = torch.device(device)
        self.time_group = time_group
        self.ch_group = ch_group
        self.time_ranks = tuple(time_ranks)


def _default_device(rank: int) -> torch.device:
    """The card of this rank (``rank`` modulo the cards of the host); raises
    without one: the port's entry points run on the card unless the caller
    asks for the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu', "
                           "...] to build a mesh on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(ch: int = 1, time: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build this process's view of a ``(ch, time)`` mesh over ``ch*time``
    processes.

    ``ch`` is the channel data-parallel axis; ``time`` the stream
    (sequence-parallel) axis, minor, so that the halo neighbours are
    consecutive ranks (on one host under torchrun).  A 1x1 mesh needs no
    process group.  A larger one needs ``torch.distributed`` initialized
    (NCCL for the card, gloo for the CPU; ``multihost.initialize``) with a
    world size of ``ch*time``; every rank must call ``make_mesh`` with the
    same arguments, in the same order as its other meshes, since each
    builds the axis subgroups collectively.

    ``devices``: one device per rank, indexed by global rank (default:
    rank ``r`` takes card ``r`` modulo the host's cards)."""
    n = ch * time
    if ch < 1 or time < 1:
        raise ValueError(f"mesh ({ch},{time}): both axes need >= 1 device")
    if devices is not None and len(devices) < n:
        raise ValueError(f"need {n} devices for mesh ({ch},{time}); "
                         f"have {len(devices)}")
    if n == 1:      # no collectives: this process alone
        dev = devices[0] if devices is not None else _default_device(
            dist.get_rank() if dist.is_initialized() else 0)
        return Mesh(1, 1, 0, 0, dev)
    if not dist.is_initialized():
        raise RuntimeError(f"mesh ({ch},{time}) spans {n} processes: "
                           f"initialize torch.distributed first "
                           f"(multihost.initialize)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh ({ch},{time}) needs a world of {n} "
                         f"processes; torch.distributed has {world}")
    rank = dist.get_rank()
    c_idx, t_idx = divmod(rank, time)
    # every rank creates every subgroup, in the same order
    time_group = ch_group = None
    for c in range(ch):
        g = dist.new_group([c * time + t for t in range(time)])
        if c == c_idx:
            time_group = g
    for t in range(time):
        g = dist.new_group([c * time + t for c in range(ch)])
        if t == t_idx:
            ch_group = g
    dev = devices[rank] if devices is not None else _default_device(rank)
    return Mesh(ch, time, c_idx, t_idx, dev, time_group=time_group,
                ch_group=ch_group,
                time_ranks=[c_idx * time + t for t in range(time)])

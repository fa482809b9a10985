"""Small host-made constants on the device, made once.

The receiver step needs a few tables it computes on the host (the PLL's
loop constants, the envelope CDR's cos / sin rows).  ``torch.as_tensor``
of a numpy array on the card is a pageable host-to-device copy, which
PyTorch finishes with a stream synchronize: on every block the host
would wait for the card to run everything queued before it, and inside
CUDA stream capture the same copy is an error.  A ``ConstCache`` makes
each table once, on its first (eager) use, and hands the same device
tensors out afterwards, so a warm step copies nothing from the host.

The caches are bounded (least recently used out first), and a tensor
handed out inside ``hold()`` is kept alive by the holder too: a CUDA
graph captured there reads it by address, so it must outlive the graph
even when the cache has let it go.  Nobody writes to a cached tensor.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Callable, Hashable

import torch

_holders: list[list] = []


class ConstCache:
    """A bounded map from a hashable key to a tuple of device tensors."""

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._items: OrderedDict = OrderedDict()

    def get(self, key: Hashable,
            make: Callable[[], tuple[torch.Tensor, ...]]
            ) -> tuple[torch.Tensor, ...]:
        """The tensors of ``key``, made by ``make()`` on a miss."""
        hit = self._items.get(key)
        if hit is None:
            hit = tuple(make())
            self._items[key] = hit
            if len(self._items) > self.maxsize:
                self._items.popitem(last=False)
        else:
            self._items.move_to_end(key)
        for h in _holders:
            h.append(hit)
        return hit

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._items


@contextlib.contextmanager
def hold():
    """Collect every tuple any ``ConstCache`` hands out inside the block
    into the list this yields (the holder keeps them alive)."""
    held: list = []
    _holders.append(held)
    try:
        yield held
    finally:
        _holders.remove(held)

"""Scale-out: the ``(ch, time)`` mesh, the sharded receiver and its
collectives, the counterpart of ``dy4tpu/parallel``.

* ``ch``: data parallelism over independent IQ channels.
* ``time``: sequence parallelism over the sample stream: consecutive
  chunks processed concurrently, made consistent by a halo exchange of
  trailing raw-IQ samples plus a warm-up region
  (``sharded.ShardedReceiver``).

Each process drives one device and holds its own shard; the collectives
are ``torch.distributed`` calls (NCCL on the card, gloo on the CPU).
"""

from dy4tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from dy4tpu_torch.parallel.sharded import (  # noqa: F401
    ExactCarry, ShardedCarry, ShardedOutputs, ShardedReceiver)

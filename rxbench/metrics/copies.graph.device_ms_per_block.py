"""Device milliseconds a block of the copies and memsets inside the chunk
graph's replay (the carry's assign, the torch ops' own copies).  Read
from ``spans.py``'s pass."""


def read(run):
    from rxbench import spans

    s = spans.of(run)
    return None if s is None else s.device_ms("copy", replayed=True)

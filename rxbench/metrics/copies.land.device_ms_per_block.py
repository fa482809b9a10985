"""Device milliseconds a block of the landing's copies: a chunk's audio
and RDS outputs copied into pinned host memory on the harness's side
stream (``harness._Lander``, span ``rxbench.land``).  Read from
``spans.py``'s pass."""


def read(run):
    from rxbench import spans

    s = spans.of(run)
    return None if s is None else s.device_ms("copy", ("rxbench.land",))

"""Device milliseconds a block of the copies and memsets of the chunk's
outputs copied out of the graph (``ChunkRunner.run_stream``, span
``graph.output``). Read from ``spans.py``'s pass."""


def read(run):
    from rxbench import spans

    s = spans.of(run)
    return None if s is None else s.device_ms("copy", ("graph.output",))

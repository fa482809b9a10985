"""Device milliseconds a block of the copies and memsets of the chunk
copied into the graph's static input (``ChunkRunner.run``, span
``graph.input``). Read from ``spans.py``'s pass."""


def read(run):
    from rxbench import spans

    s = spans.of(run)
    return None if s is None else s.device_ms("copy", ("graph.input",))

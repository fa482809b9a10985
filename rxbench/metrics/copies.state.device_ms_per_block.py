"""Device milliseconds a block of the copies and memsets of the state
copied into the runner and cloned out of it (``ChunkRunner.load`` and
``read``, spans ``graph.load`` and ``graph.read``). Read from
``spans.py``'s pass."""


def read(run):
    from rxbench import spans

    s = spans.of(run)
    return None if s is None else s.device_ms(
        "copy", ("graph.load", "graph.read"))

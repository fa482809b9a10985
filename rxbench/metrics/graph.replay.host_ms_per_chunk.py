"""Host milliseconds a chunk of the chunk graph's replay launched and
the launch counters updated (``ChunkRunner.run``): the program's span
durations in ``spans.py``'s pass, read under a profiler
of the host's activity alone."""


def read(run):
    from rxbench import spans

    s = spans.of(run)
    return None if s is None else s.host_ms("graph.replay")

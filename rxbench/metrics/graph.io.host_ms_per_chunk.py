"""Host milliseconds a chunk of the chunk's graph found by its key, the
chunk copied into its static input, and the outputs copied out
(``ChunkRunner.run``, ``run_stream``): the program's span durations in
``spans.py``'s pass, read under a profiler
of the host's activity alone."""


def read(run):
    from rxbench import spans

    s = spans.of(run)
    return None if s is None else s.host_ms("graph.input", "graph.output")

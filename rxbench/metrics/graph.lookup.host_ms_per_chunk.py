"""Host milliseconds a chunk of ``run_blocks``' runner found by its key
(``_signature(state)``, the options) in ``graph._cached``: the program's
span durations in ``spans.py``'s pass, read under a profiler
of the host's activity alone."""


def read(run):
    from rxbench import spans

    s = spans.of(run)
    return None if s is None else s.host_ms("graph.lookup")

"""Seconds from the harness's start to the window's: imports, the card,
the kernels' build or load, the inputs, the graph capture, the warm-up."""


def read(run):
    return run.setup_s

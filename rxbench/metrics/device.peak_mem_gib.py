"""GiB of device memory allocated at the window's peak
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(run):
    return run.window_peak_bytes / 2**30

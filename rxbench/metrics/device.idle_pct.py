"""The share of the measured window in which the compute stream waited
for the host, in percent: the gaps between one ``run_blocks`` call's end
and the next one's start, by the timing events the harness records on
the stream around each call, over the span of the window's calls.  No
tracer runs in the window, so it reads the system alone; gaps inside a
call (between a graph's kernels) are the kernels' and the traced
``busy_s`` / ``window_s`` carry them."""


def read(run):
    idle = run.stream_idle()
    return None if idle is None else 100.0 * idle[0] / idle[1]

"""Host milliseconds of a ``run_blocks`` call (the runner lookup, the
state's load, the replay, the outputs' copies, the state's read), mean
over the window's chunks."""

import numpy as np


def read(run):
    return 1e3 * float(np.mean([c.t_call - c.t_sent for c in run.counted()]))

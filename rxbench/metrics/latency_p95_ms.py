"""The 95th percentile, over every chunk of the window, of the host time
from handing the chunk to ``run_blocks`` until its outputs are in host
memory."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile(
        [c.t_land - c.t_sent for c in run.counted()], 95))

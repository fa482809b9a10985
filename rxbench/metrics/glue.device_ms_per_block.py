"""Device milliseconds a block of every traced kernel that no roofline
file names: the receiver step's plain torch ops (``pipeline/receiver.py``,
``ops/trig.py``, ``ops/pll.py``, ...), and any hand-written kernel whose
name no roofline file holds."""


def read(run):
    glue = run.glue_s()
    return None if glue is None else 1e3 * glue / run.trace.blocks

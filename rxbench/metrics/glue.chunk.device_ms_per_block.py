"""Device milliseconds a block of the glue (kernels no roofline file
names) of the chunk's own body in ``pipeline/graph.py``: the blocks'
outputs stacked (``graph.stack``) and the new carry copied into the
static carry (``graph.assign``).  Read from ``spans.py``'s pass."""


def read(run):
    from rxbench import spans

    s = spans.of(run)
    return None if s is None else s.device_ms(
        "glue", ("graph.stack", "graph.assign"))

"""Device milliseconds a block of the glue (kernels no roofline file
names) under the span ``rx.back``: the back end: ``back_step``'s copies
of the lane slices, B3 / B5 and B4. Read from ``spans.py``'s pass, a
replay's kernels named by the launches its capture recorded."""


def read(run):
    from rxbench import spans

    s = spans.of(run)
    return None if s is None else s.device_ms("glue", ("rx.back",))

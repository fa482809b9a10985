"""Device milliseconds a block of the glue (kernels no roofline file
names) under the span ``rx.pll_lanes``: the PLL's lanes: the pilot and
RDS-carrier inputs and states stacked on a lane axis, and split again
(``receiver._finish_step``). Read from ``spans.py``'s pass, a replay's
kernels named by the launches its capture recorded."""


def read(run):
    from rxbench import spans

    s = spans.of(run)
    return None if s is None else s.device_ms("glue", ("rx.pll_lanes",))

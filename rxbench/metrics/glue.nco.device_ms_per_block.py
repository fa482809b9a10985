"""Device milliseconds a block of the glue (kernels no roofline file
names) under the span ``rx.nco``: the NCO synthesis: ``trig.nco_sincos``
over the phases, the carried first sample's ``cat`` and the new carry
(``ops/pll.py`` ``pll``). Read from ``spans.py``'s pass, a replay's
kernels named by the launches its capture recorded."""


def read(run):
    from rxbench import spans

    s = spans.of(run)
    return None if s is None else s.device_ms("glue", ("rx.nco",))

"""Kernel B2, the per-sample PLL phase scan (``csrc/pll.cu``
``pll_phase_scan_kernel``): the pilot loop and, with RDS, the RDS
carrier loop stacked on a lane, over a block's IF samples.

Operations: 17 float operations a step (``chip_smoke.py``'s
``B2_STEP_OPS``, counted in the kernel's loop body).  Bytes: the input
and the emitted phases, the three loop constants and the three carried
values in and out, a float each a lane.
"""

from rxbench.rooflines._count import nbytes

KERNELS = ("pll_phase_scan_kernel",)


def work(cfg: dict, geo, stations: int, precision: str):
    lanes = stations * (2 if geo.rds else 1)
    stream = ((lanes, geo.n_if), 4)
    return nbytes(stream, stream, *[((lanes,), 4)] * 9), 17 * lanes * geo.n_if

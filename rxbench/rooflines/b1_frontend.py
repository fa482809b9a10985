"""Kernel B1, the RF entry's front end (``csrc/frontend.cu``
``frontend_full_kernel``, its float32 and tensor-core instantiations):
per block, u8 I/Q -> the RF low-pass decimated on both legs, the FM
demod, the band bank (pilot, stereo, RDS band), and with RDS the squared
RDS band through the carrier band-pass, with the delay lines and every
tail.

Operations a block, as ``chip_smoke.py``'s ``_front_flops``: per IF
sample about 9 for the demod, 2 a tap for each band filter and for the
carrier band-pass (1 more for the squaring), 2 a tap on each RF leg.
"""

from rxbench.rooflines._count import nbytes

KERNELS = ("frontend_full_kernel",)


def work(cfg: dict, geo, stations: int, precision: str):
    c, k, n = stations, int(cfg["num_taps"]), geo.n_if
    bands = 3 if geo.rds else 2
    per = 9 + bands * k * 2 + 2 * k * 2
    if geo.rds:
        per += 1 + k * 2
    f = 4
    ins = [((c, 2 * geo.iq), 1), ((k,), f), ((bands, k), f),
           ((c, 2, k - 1), f), ((c,), f), ((c,), f), ((c, k - 1), f),
           ((c, k // 2), f)]
    outs = [((c, n), f)] * 3 + [((c, 2, k - 1), f), ((c,), f), ((c,), f),
                                ((c, k - 1), f), ((c, k // 2), f)]
    if geo.rds:
        ins += [((k,), f), ((c, k - 1), f), ((c, k // 2), f)]
        outs += [((c, n), f)] * 2 + [((c, k - 1), f), ((c, k // 2), f)]
    return nbytes(*ins, *outs), c * n * per

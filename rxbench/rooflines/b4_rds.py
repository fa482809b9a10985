"""Kernel B4, the RDS back end (``csrc/rds_backend.cu``
``rds_backend_kernel``, its float32 and tensor-core instantiations): the
RDS band mixed with the carrier NCO's cos and sin, the polyphase 3 kHz
low-pass (up U, down D) and the root-raised-cosine matched filter on
both legs, with their tails.

Operations, as ``chip_smoke.py``'s ``_rational_flops`` for B4: the mix (2
an IF sample), 2 x ceil(K/U) multiply-adds an output of each leg, and
the RRC's 2 x K2 an output of each leg.
"""

from rxbench.rooflines._count import nbytes

KERNELS = ("rds_backend_kernel",)


def work(cfg: dict, geo, stations: int, precision: str):
    c, n, m = stations, geo.n_if, geo.n_rds
    up, k2 = geo.rds_up, int(cfg["num_taps"])
    k = k2 * up
    tail = (k - 1) // up
    f = 4
    byt = nbytes(*[((c, n), f)] * 3, ((k,), f), ((k2,), f),
                 *[((c, tail), f)] * 2, *[((c, k2 - 1), f)] * 2,
                 *[((c, m), f)] * 2, *[((c, tail), f)] * 2,
                 *[((c, k2 - 1), f)] * 2)
    per_out = -(-k // up)
    return byt, c * (2 * n + 2 * m * per_out * 2 + 2 * m * k2 * 2)

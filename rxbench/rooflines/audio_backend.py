"""Kernels B3 / B5, the audio back end (``csrc/audio_rational.cu``
``audio_rational_kernel``, its float32 and tensor-core instantiations;
B3 is its launch at U = 1): ``2 * nco * stereo band``, the polyphase
audio low-pass on the mono and stereo legs, L = M + S and R = M - S.

Operations, as ``chip_smoke.py``'s ``_rational_flops``: the mix (2 an IF
sample), 2 x ceil(K/U) multiply-adds an output of each leg, the matrix
(2 an output).
"""

from rxbench.rooflines._count import nbytes

KERNELS = ("audio_rational_kernel",)


def work(cfg: dict, geo, stations: int, precision: str):
    c, n, m = stations, geo.n_if, geo.n_audio
    up = geo.audio_up
    k = int(cfg["num_taps"]) * up
    tail = (k - 1) // up
    f = 4
    byt = nbytes(*[((c, n), f)] * 3, ((k,), f), *[((c, tail), f)] * 2,
                 *[((c, m), f)] * 3, *[((c, tail), f)] * 2)
    per_out = -(-k // up)
    return byt, c * (2 * n + 2 * m * per_out * 2 + 2 * m)

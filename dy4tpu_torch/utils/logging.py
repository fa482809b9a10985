"""Signal-level tracing: gnuplot-compatible vector dumps + PSD logging, the
counterpart of ``dy4tpu/utils/logging.py``.

Equivalent of the reference's ``logVector``/``genIndexVector``
(src/logfunc.cpp:14-43) whose ``.dat`` files feed
``data/example.gnuplot``.  Files written here are drop-in compatible:
one "x y" pair per line, same default directory convention, byte for
byte dy4tpu's format.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

DEFAULT_DIR = "data"


def gen_index_vector(n: int) -> np.ndarray:
    """0..n-1 as float (genIndexVector, logfunc.cpp:14-21)."""
    return np.arange(n, dtype=np.float32)


def log_vector(name: str, x: Optional[Sequence[float]],
               y: Sequence[float], directory: str = DEFAULT_DIR) -> str:
    """Write ``<directory>/<name>.dat`` with one ``x y`` pair per line
    (logVector, logfunc.cpp:23-43).  ``x=None`` -> sample index.
    Returns the path."""
    y = np.asarray(y, np.float64).ravel()
    x = gen_index_vector(len(y)) if x is None else np.asarray(x, np.float64)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.dat")
    with open(path, "w") as f:
        for xi, yi in zip(x, y):
            f.write(f"{xi:<10.6g}\t{yi:<10.6g}\n")
    return path


def log_psd(name: str, samples, fs: float, nfft: int = 512,
            directory: str = DEFAULT_DIR, device="cuda") -> str:
    """Bartlett PSD of ``samples`` -> ``<name>.dat`` (freq in kHz vs dB),
    mirroring the reference's PSD gnuplot convention
    (data/example.gnuplot:23-26).  The PSD runs on ``device`` (the card,
    through kernel B10, unless the caller asks for the CPU)."""
    import torch

    from dy4tpu_torch.ops import fft

    x = torch.as_tensor(np.asarray(samples, np.float32), device=device)
    freq, psd = fft.estimate_psd(x, nfft=nfft, fs=fs)
    return log_vector(name, freq / 1e3, psd.cpu().numpy(), directory)

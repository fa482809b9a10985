"""The traffic generator: a workload file's parameters and a seed ->
the stations' u8 I/Q, one loopable ring of blocks on the device.

A workload (``rxbench/workloads/<cell>.json``) names its configuration
and sets ``stations`` (the rows of every chunk), ``programs`` (distinct
broadcasts), ``ring_blocks`` (the length of the loop each row plays),
``tone_hz`` (the range the seed draws each program's left and right tone
from), ``tone_amp`` and ``iq_swap_odd_rows``.  The seed draws each
program's tones, PI code and 8-character PS name, and each row's start in
its program's loop.  Row r plays program ``r % programs`` from its own
even byte offset (whole I/Q pairs); with ``iq_swap_odd_rows`` the odd
rows carry I and Q swapped (the conjugate spectrum: every output
negated, which a receiver must take as well).  So every seed asks for the
same work (the same rows, blocks and programs), on other contents.

The ring is ``[ring_blocks + chunk - 1, stations, 2 * iq]`` u8: its first
``chunk - 1`` blocks repeated at its end, so the chunk of blocks that
starts at any block of the loop is one contiguous slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from rxbench.gen import coding, fm

_PS_CHARS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 "


@dataclass(frozen=True)
class Program:
    left_hz: float
    right_hz: float
    pi: int
    ps: str


@dataclass(frozen=True)
class Traffic:
    programs: tuple[Program, ...]
    offsets: np.ndarray        # [stations] even byte offsets into the loop
    swapped: np.ndarray        # [stations] bool: I and Q swapped


def draw(workload: dict, geo, seed: int) -> Traffic:
    """The seed's programs and row offsets for ``workload``."""
    rng = np.random.default_rng(int(seed))
    lo, hi = workload["tone_hz"]
    progs = tuple(
        Program(left_hz=float(rng.uniform(lo, hi)),
                right_hz=float(rng.uniform(lo, hi)),
                pi=int(rng.integers(0x1000, 0x10000)),
                ps="".join(rng.choice(list(_PS_CHARS), 8)))
        for _ in range(int(workload["programs"])))
    c = int(workload["stations"])
    pairs = int(workload["ring_blocks"]) * geo.iq
    offsets = 2 * rng.integers(0, pairs, c)
    swapped = (np.arange(c) % 2 == 1) & bool(workload["iq_swap_odd_rows"])
    return Traffic(progs, offsets, swapped)


def synthesize(traffic: Traffic, workload: dict, cfg: dict,
               geo) -> np.ndarray:
    """Each program's loop of ``ring_blocks`` blocks: u8 [programs,
    ring_blocks * 2 * iq]."""
    n = int(workload["ring_blocks"])
    n_audio = n * geo.n_audio
    amp = float(workload["tone_amp"])
    out = []
    for p in traffic.programs:
        bits = None
        if geo.rds:
            # 0A cycles of 416 bits, two symbols a bit, over the loop
            repeats = -(-n * geo.n_sym // 832) + 1
            bits = coding.ps_bitstream(p.pi, 10, p.ps, repeats)
        out.append(fm.synthesize(
            geo, cfg, n, fm.tone(p.left_hz, cfg["audio_fs"], n_audio, amp),
            fm.tone(p.right_hz, cfg["audio_fs"], n_audio, amp), bits))
    return np.stack(out)


def ring(loops: np.ndarray, traffic: Traffic, workload: dict, geo,
         device):
    """The stations' ring on ``device``: [ring_blocks + chunk - 1,
    stations, 2 * iq] u8 (the module docstring)."""
    import torch

    n, k = int(workload["ring_blocks"]), int(workload["chunk"])
    if not 1 <= k <= n:
        raise ValueError(f"chunk {k} outside 1..ring_blocks ({n})")
    bs = 2 * geo.iq
    c = len(traffic.offsets)
    length = (n + k - 1) * bs
    src = torch.from_numpy(loops).to(device)                   # [P, n*bs]
    swap = src.view(len(loops), -1, 2).flip(-1).reshape(len(loops), -1)
    # three loops end to end: every row's slice lies inside, unwrapped
    tiled = [torch.cat([s, s, s], -1) for s in (src, swap)]
    out = torch.empty((n + k - 1, c, bs), dtype=torch.uint8, device=device)
    for r in range(c):
        d = tiled[int(traffic.swapped[r])][r % len(loops)]
        o = int(traffic.offsets[r])
        out[:, r, :] = d[o:o + length].view(n + k - 1, bs)
    return out

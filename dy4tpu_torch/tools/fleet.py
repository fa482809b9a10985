"""Fleet serving CLI of the port: decode MANY stations through one batched
receiver.  The counterpart of ``dy4tpu/tools/fleet.py``, with the same
arguments and output, plus ``--device``.

The production shape of the framework: N capture files (or N repeats of
one) become a [N, block] channel batch; the whole mono+stereo+RDS chain
runs a chunk of blocks at a time (``receiver.receiver_step`` a block, the
kernels B1-B4 at mode 0, B1, B2, B4 and B5 at mode 2, B1's corr variant
with ``--iqcorr``), and the RDS bit/frame layers drain through the native
``FleetDecoder``.

Ingest is a double-buffered pipeline (replacing the reference's
synchronous ``readStdinBlockData`` loop, src/iofunc.cpp:113-120): while
the card computes chunk k, the host fills chunk k+1 into a pinned buffer
and starts its copy to the card on a copy stream, then decodes chunk
k-1's RDS symbols, so upload, compute and host decode overlap.  Two
pinned host chunk buffers and two device chunk buffers are allocated once
and reused, each reuse guarded by an event:

  * a pinned buffer is refilled only after its previous copy has landed;
  * the copy into a device buffer waits (on the copy stream) for the
    compute stream's "chunk consumed" event of the chunk that buffer held;
  * the compute stream waits for the copy's event before the chunk's
    first step;
  * the three RDS outputs go back into pinned buffers, non-blocking,
    behind an event that the drain waits on.

``--sync-ingest`` serialises the three phases (synchronise after the
upload, after the chunk's steps, and before the drain) for an A/B
measurement; the phase times print in the stats either way, the pinned
fill beside the upload that includes it.  On ``--device cpu`` nothing is
pinned and no stream is made: the same loop runs on the plain versions.

    python -m dy4tpu_torch.tools.fleet --mode 0 captures/*.raw
    python -m dy4tpu_torch.tools.fleet --mode 0 --repeat 64 one_capture.raw
    python -m dy4tpu_torch.tools.fleet --mode 0 cap.raw cap.raw --device cpu

``--device`` defaults to ``cuda`` and fails when the machine has no CUDA
device.  ``serve`` is the library entry: it returns every station's RDS
application-layer info, the phase times and, with ``record=True``, the
RDS outputs of every block.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np


class FleetRun(NamedTuple):
    """What ``serve`` returns.  Times are host seconds (``wall`` from the
    first upload to the last drain; ``t_put`` includes ``t_fill``, the
    copies into the pinned buffers).  The ``rds_*`` arrays are
    [n_blocks, stations, ...] with ``record=True``, else None."""
    paths: list
    n_blocks: int
    chunk: int
    sync_ingest: bool
    infos: list             # rds.app.StationInfo of every station
    wall: float
    t_put: float
    t_fill: float
    t_dispatch: float
    t_drain: float
    rds_symbols: Optional[np.ndarray] = None   # int8 hard symbols
    rds_resync: Optional[np.ndarray] = None    # bool
    rds_offset: Optional[np.ndarray] = None    # int32 CDR phase


def n_blocks_of(paths, cfg, max_blocks: Optional[int] = None) -> int:
    """Whole blocks every capture holds (at most ``max_blocks``; 0 or None
    for no limit), from the files' sizes."""
    n = min(os.path.getsize(p) for p in paths) // cfg.block_size
    return min(n, max_blocks) if max_blocks else n


def host_blocks(paths, cfg, n_blocks: int) -> np.ndarray:
    """The [n_blocks, stations, block_size] u8 host array, filled station
    by station, each distinct path read once (a repeated path is a
    repeated reference), so a chunk of blocks is one contiguous slice."""
    from dy4tpu_torch.utils import io as dio

    raws = {p: dio.read_raw_u8(p) for p in dict.fromkeys(paths)}
    bs = cfg.block_size
    out = np.empty((n_blocks, len(paths), bs), np.uint8)
    for ch, p in enumerate(paths):
        out[:, ch] = raws[p][:n_blocks * bs].reshape(n_blocks, bs)
    return out


def serve(paths, cfg, *, chunk: int = 8, sync_ingest: bool = False,
          iqcorr: bool = False, cdr: str = "peak",
          max_blocks: Optional[int] = None, device="cuda",
          record: bool = False) -> FleetRun:
    """Decode every capture in ``paths`` as one station of a batch on
    ``device`` (the card unless the caller asks for the CPU): ``chunk``
    blocks a dispatch, the ingest overlapped unless ``sync_ingest``, the IQ
    tracker with ``iqcorr``, RDS timing ``cdr`` ("peak" or "envelope").
    Raises ``ValueError`` when a capture holds no whole block."""
    import torch

    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.rds.app import ApplicationLayer
    from dy4tpu_torch.rds.fleet import FleetDecoder

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    n_blocks = n_blocks_of(paths, cfg, max_blocks)
    if n_blocks == 0:
        raise ValueError("captures shorter than one block")
    c = len(paths)
    k = max(1, chunk)
    n_chunks = -(-n_blocks // k)
    host = host_blocks(paths, cfg, n_blocks)

    params = rx.make_params(cfg, device=dev)
    state = rx.init_state(cfg, batch=(c,), with_iqcorr=iqcorr, device=dev)
    apps = [ApplicationLayer() for _ in range(c)]
    fleet = FleetDecoder(c, on_group=lambda ch, g: apps[ch].process(g))
    n_sym = cfg.rds_symbols_per_block

    def steps(state, blocks):
        """One step a block of ``blocks`` [nk, C, bs]; only the three RDS
        fields are kept, stacked [nk, C, ...]."""
        syms, resync, offsets = [], [], []
        for blk in blocks:
            state, out = rx.receiver_step(params, state, blk, cfg,
                                          cdr_timing=cdr)
            syms.append(out.rds_symbols)
            resync.append(out.rds_resync)
            offsets.append(out.rds_offset)
        return state, tuple(torch.stack(o) for o in (syms, resync, offsets))

    if on_card:
        kb = min(k, n_blocks)                # blocks a buffer holds
        pinned = [torch.empty((kb, c, cfg.block_size), dtype=torch.uint8,
                              pin_memory=True) for _ in range(2)]
        dev_in = [torch.empty((kb, c, cfg.block_size), dtype=torch.uint8,
                              device=dev) for _ in range(2)]
        out_pin = [(torch.empty((kb, c, n_sym), dtype=torch.int8,
                                pin_memory=True),
                    torch.empty((kb, c), dtype=torch.bool, pin_memory=True),
                    torch.empty((kb, c), dtype=torch.int32, pin_memory=True))
                   for _ in range(2)]
        landed = [torch.cuda.Event() for _ in range(2)]     # H2D copy done
        consumed = [torch.cuda.Event() for _ in range(2)]   # steps issued
        out_ready = [torch.cuda.Event() for _ in range(2)]  # D2H copy done
        copy_stream = torch.cuda.Stream(dev)
        compute = torch.cuda.current_stream(dev)
        # warm-up off the clock: one chunk of zeros through a throwaway
        # state builds the kernels at their first use (each kernel of the
        # path counts ``kb`` launches more than the stream's blocks)
        dev_in[0].zero_()
        steps(rx.init_state(cfg, batch=(c,), with_iqcorr=iqcorr,
                            device=dev), dev_in[0])
        torch.cuda.synchronize(dev)

    t = dict(put=0.0, fill=0.0, dispatch=0.0, drain=0.0)
    recorded = []

    def upload(ci):
        """Chunk ``ci`` to the device: returns its [nk, C, bs] blocks."""
        j, lo = ci % 2, ci * k
        hi = min(n_blocks, lo + k)
        t0 = time.perf_counter()
        if not on_card:
            blocks = torch.from_numpy(host[lo:hi])
        else:
            landed[j].synchronize()          # pinned[j]'s last copy is done
            t1 = time.perf_counter()
            pinned[j][:hi - lo].copy_(torch.from_numpy(host[lo:hi]))
            t["fill"] += time.perf_counter() - t1
            blocks = dev_in[j][:hi - lo]
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(consumed[j])   # dev_in[j] is free
                blocks.copy_(pinned[j][:hi - lo], non_blocking=True)
                landed[j].record(copy_stream)
            if sync_ingest:
                landed[j].synchronize()
        t["put"] += time.perf_counter() - t0
        return blocks

    def run_chunk(ci, blocks):
        """Issue chunk ``ci``'s steps; returns what its drain needs."""
        nonlocal state
        j = ci % 2
        t0 = time.perf_counter()
        if on_card:
            compute.wait_event(landed[j])
        state, outs = steps(state, blocks)
        if on_card:
            consumed[j].record(compute)
            for pin, o in zip(out_pin[j], outs):
                pin[:len(blocks)].copy_(o, non_blocking=True)
            out_ready[j].record(compute)
            outs = tuple(pin[:len(blocks)] for pin in out_pin[j])
        t["dispatch"] += time.perf_counter() - t0
        return j, outs

    def drain(pending):
        """Host RDS decode of a chunk's outputs."""
        j, outs = pending
        t0 = time.perf_counter()
        if on_card:
            out_ready[j].synchronize()
        symbols, resync, offsets = (o.numpy() for o in outs)
        for b in range(symbols.shape[0]):
            fleet.push_block(symbols[b], resync[b], offsets[b])
        if record:
            recorded.append(tuple(a.copy() for a in (symbols, resync,
                                                     offsets)))
        t["drain"] += time.perf_counter() - t0

    wall0 = time.perf_counter()
    nxt = upload(0)
    pending = None
    for ci in range(n_chunks):
        outs = run_chunk(ci, nxt)
        if sync_ingest and on_card:
            torch.cuda.synchronize(dev)
        if ci + 1 < n_chunks:
            nxt = upload(ci + 1)             # overlaps chunk ci's compute
        if pending is not None:
            drain(pending)                   # host decode overlaps compute
        pending = outs
    drain(pending)
    wall = time.perf_counter() - wall0

    rds = ((None,) * 3 if not record else
           tuple(np.concatenate(a) for a in zip(*recorded)))
    return FleetRun(list(paths), n_blocks, k, sync_ingest,
                    [app.info for app in apps], wall, t["put"], t["fill"],
                    t["dispatch"], t["drain"], *rds)


def report(run: FleetRun, cfg, device) -> list[str]:
    """dy4tpu's stderr lines for a run: the stats line, then one line a
    station.  On the card the upload's pinned fill prints beside it."""
    c = len(run.paths)
    iq_total = c * run.n_blocks * cfg.iq_per_block
    mode = "sync" if run.sync_ingest else "overlapped"
    fill = (f" (pinned fill {run.t_fill * 1e3:.0f} ms)"
            if str(device).startswith("cuda") else "")
    lines = [f"{c} stations x {run.n_blocks} blocks ({mode} ingest, "
             f"chunk={run.chunk}): wall {run.wall * 1e3:.0f} ms = "
             f"{iq_total / run.wall / 1e6:.0f} MS/s "
             f"({iq_total / run.wall / cfg.rf_fs:.0f}x real-time); "
             f"phases: put {run.t_put * 1e3:.0f} ms{fill}, dispatch "
             f"{run.t_dispatch * 1e3:.0f} ms, host decode "
             f"{run.t_drain * 1e3:.0f} ms"]
    for ch, (path, info) in enumerate(zip(run.paths, run.infos)):
        rt = f" RT={info.radiotext!r}" if info.radiotext else ""
        lines.append(f"[{ch:3d}] {path}: PI={info.pi_hex} "
                     f"PS={info.ps_name!r} PTY={info.pty_name!r} "
                     f"({info.groups_seen} groups){rt}")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="batched multi-station receiver + RDS fleet decode")
    p.add_argument("captures", nargs="+", help="u8 IQ capture files")
    p.add_argument("--mode", type=int, default=0, choices=[0, 2],
                   help="RDS-capable mode")
    p.add_argument("--repeat", type=int, default=1,
                   help="tile the capture list this many times")
    p.add_argument("--max-blocks", type=int, default=None)
    p.add_argument("--chunk", type=int, default=8,
                   help="blocks per device dispatch")
    p.add_argument("--sync-ingest", action="store_true",
                   help="serialise upload/compute/decode (A/B baseline "
                        "for the overlapped pipeline)")
    p.add_argument("--iqcorr", action="store_true",
                   help="per-station blind DC/IQ-imbalance tracker "
                        "(ops/iqcorr.py): each capture gets its own "
                        "correction state")
    p.add_argument("--cdr", choices=["peak", "envelope"], default=None,
                   help="RDS timing acquisition (see the receiver CLI)")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; the hand-written "
                        "kernels) or 'cpu' (the plain versions)")
    args = p.parse_args(argv)

    from dy4tpu_torch.app import _env_settings
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.runtime import kernels

    dev = kernels.cli_device(args.device)
    _, _, cdr = _env_settings(args.cdr)   # flag, else DY4TPU_CDR, else peak
    cfg = get_mode(args.mode)
    paths = args.captures * args.repeat
    if n_blocks_of(paths, cfg, args.max_blocks) == 0:
        print("captures shorter than one block", file=sys.stderr)
        return 1
    run = serve(paths, cfg, chunk=args.chunk, sync_ingest=args.sync_ingest,
                iqcorr=args.iqcorr, cdr=cdr, max_blocks=args.max_blocks,
                device=dev)
    for line in report(run, cfg, dev):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

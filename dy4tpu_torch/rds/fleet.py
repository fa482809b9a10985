"""Fleet-scale RDS decoding: many channels on one host core.

The pure-Python ``RDSDecoder`` walks one channel at ~0.04 Mbit/s — fine
for a station, useless for the receiver's multi-hundred-channel DSP
throughput.  Here BOTH host layers are batched:

* ``BatchManchester`` — the pairing vote + Manchester + differential
  decode of ``rds.decoder.ManchesterDecoder``, vectorised over a
  ``[channels, symbols]`` block with per-channel state held in numpy
  arrays (no Python per-channel loop; semantics pinned against the
  scalar decoder in tests/test_fleet.py).
* ``native.NativeFrameSyncBatch`` — the frame-sync state machines run in
  one C call per block (native/dy4_runtime.cpp FrameSyncBatch), emitting
  (channel, blocks, position) triples.

Measured ≥1024-channel throughput: benchmarks/fleet_host.py.  The whole
fleet state (numpy arrays + one native blob) is checkpointable via
``state()``/``load_state()``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from dy4tpu_torch.rds import coding
from dy4tpu_torch.rds.decoder import Group
from dy4tpu_torch.runtime import native


class BatchManchester:
    """Vectorised twin of ``decoder.ManchesterDecoder`` over channels.

    State per channel: last symbol, last bit, per-parity violation
    counts, blocks seen, absolute symbol index, chosen pairing parity
    (-1 while the vote is warming up).  Supports per-channel resets and
    odd symbols-per-block (mode 2's 95) exactly like the scalar decoder.
    """

    def __init__(self, channels: int, vote_blocks: int = 4):
        self.channels = channels
        self.vote_blocks = vote_blocks
        c = channels
        self.symbol_state = np.zeros(c, np.int8)
        self.bit_state = np.zeros(c, np.int8)
        self.errors = np.zeros((c, 2), np.int64)
        self.blocks_seen = np.zeros(c, np.int64)
        self.abs_idx = np.zeros(c, np.int64)
        self.phase = np.full(c, -1, np.int8)

    def reset(self, mask: np.ndarray) -> None:
        for arr in (self.symbol_state, self.bit_state, self.blocks_seen,
                    self.abs_idx):
            arr[mask] = 0
        self.errors[mask] = 0
        self.phase[mask] = -1

    def push(self, symbols: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``symbols``: [C, n] hard symbols -> ``(bits [C, ceil(n/2)] u8,
        lens [C] i32)``; channels still voting return len 0."""
        symbols = np.asarray(symbols, np.int8)
        c, n = symbols.shape
        s_prev = np.concatenate([self.symbol_state[:, None],
                                 symbols[:, :-1]], axis=1)
        eq = symbols == s_prev
        sums = (eq[:, 0::2].sum(1), eq[:, 1::2].sum(1))

        voting = self.phase < 0
        locked = ~voting
        ls0 = (-self.abs_idx) % 2                      # local start, p=0
        for p in (0, 1):
            ls = (ls0 + p) % 2
            s = np.where(ls == 0, sums[0], sums[1])
            self.errors[:, p] += np.where(voting, s, 0)
        self.blocks_seen += voting

        # decode both slicings, select per channel
        def dec(st):
            cur = symbols[:, st::2]
            prev = s_prev[:, st::2]
            return ((cur == 0) & (prev == 1)).astype(np.int8)

        b0, b1 = dec(0), dec(1)
        maxb = b0.shape[1]
        if b1.shape[1] < maxb:
            b1 = np.pad(b1, ((0, 0), (0, maxb - b1.shape[1])))
        start = np.where(locked, (self.phase - self.abs_idx) % 2, 0)
        bits = np.where((start == 0)[:, None], b0, b1)
        lens = np.where(start == 0, b0.shape[1],
                        n // 2 if n % 2 else maxb)
        lens = np.where(locked, lens, 0).astype(np.int32)

        prev_bits = np.concatenate([self.bit_state[:, None],
                                    bits[:, :-1]], axis=1)
        out = (bits ^ prev_bits).astype(np.uint8)

        has = lens > 0
        last = bits[np.arange(c), np.maximum(lens - 1, 0)]
        self.bit_state = np.where(has, last, self.bit_state).astype(np.int8)
        self.symbol_state = symbols[:, -1]
        self.abs_idx += n
        newly = voting & (self.blocks_seen >= self.vote_blocks)
        vote = (self.errors[:, 0] <= self.errors[:, 1]).astype(np.int8)
        self.phase = np.where(newly, np.where(vote == 1, 0, 1), self.phase)
        return out, lens

    def state(self) -> dict:
        return {k: getattr(self, k).copy()
                for k in ("symbol_state", "bit_state", "errors",
                          "blocks_seen", "abs_idx", "phase")}

    def load_state(self, st: dict) -> None:
        for k, v in st.items():
            getattr(self, k)[...] = v


class FleetDecoder:
    """symbols -> groups for a batch of channels; no per-channel Python."""

    def __init__(self, channels: int,
                 on_group: Optional[Callable[[int, Group], None]] = None,
                 collect: bool = True):
        if not native.available():
            raise RuntimeError("native runtime unavailable; use RDSDecoder")
        self.channels = channels
        self.on_group = on_group
        self.collect = collect
        rows = coding.syndrome_matrix()
        self.manchester = BatchManchester(channels)
        self.framer = native.NativeFrameSyncBatch(rows, coding.OFFSET_WORDS,
                                                  channels)
        self.groups: list[list[Group]] = [[] for _ in range(channels)]
        self._last_offset = np.full(channels, -1, np.int64)

    def push_block(self, symbols: np.ndarray,
                   resync: Optional[np.ndarray] = None,
                   offsets: Optional[np.ndarray] = None) -> int:
        """``symbols``: [channels, n] hard symbols; ``resync``: [channels]
        bool; ``offsets``: [channels] CDR phases (with offsets, reset
        happens only on an actual phase change — see RDSDecoder).
        Returns the number of groups completed this block."""
        reset = None
        if resync is not None:
            reset = np.asarray(resync, bool).copy()
            if offsets is not None:
                off = np.asarray(offsets, np.int64)
                reset &= (self._last_offset >= 0) & (off != self._last_offset)
                self._last_offset = off
            if reset.any():
                self.manchester.reset(reset)
        bits, lens = self.manchester.push(symbols)
        chans, blocks, positions = self.framer.push(bits, lens, reset)
        if self.collect or self.on_group:
            for ch, row, pos in zip(chans, blocks, positions):
                g = Group(blocks={"A": int(row[0]), "B": int(row[1]),
                                  "C": int(row[2]), "D": int(row[3])},
                          bit_position=int(pos))
                if self.collect:
                    self.groups[ch].append(g)
                if self.on_group:
                    self.on_group(int(ch), g)
        return len(chans)

    # ---- checkpointing ----

    def state(self) -> dict:
        return {"manchester": self.manchester.state(),
                "framesync": self.framer.export_state(),
                "last_offset": self._last_offset.copy()}

    def load_state(self, st: dict) -> None:
        self.manchester.load_state(st["manchester"])
        self.framer.import_state(st["framesync"])
        self._last_offset[...] = st["last_offset"]

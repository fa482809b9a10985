"""Sharded streaming receiver: channels x time over a ``(ch, time)`` mesh.
The counterpart of ``dy4tpu/parallel/sharded.py``.

* **ch axis**: independent IQ channels, pure data parallelism.
* **time axis**: consecutive chunks of the same stream processed
  concurrently.  Every FIR, delay and resampler state of the receiver is a
  trailing window of its stage's input stream, so it is rebuilt exactly by
  prepending an input halo, the tail of the left neighbour's raw IQ
  (one point-to-point exchange), and discarding the warm-up outputs.

``exact=True`` (default) is bit-exact against the sequential receiver
(``receiver.run_blocks``): the LTI front and back halves run time-parallel
with a sub-block warm-up (``exact_min_halo_if``), while the PLL, whose
input enters only through its sign, is replayed as one global recurrence
over the gathered int8 sign codes (``pll.phase_scan_coded``, kernel B8 on
the card), and the CDR over the gathered post-RRC baseband.  With
``channel_parallel_replay`` the replay is spread over the time ranks by
channel (one all-to-all each way) instead of run by every rank on every
channel.  ``exact=False`` (legacy) lets each shard's PLL and CDR re-lock
inside a whole-block warm-up, so its outputs converge to the sequential
ones rather than equal them.

In torch every process holds only its own shard: the carries and outputs
of ``step`` are this rank's pieces, laid out as dy4tpu's shard_map blocks
(``[C_l, S*n]`` outputs, ``[1, C_l, ...]`` front/back states), and
``input_sharding`` cuts this rank's piece out of a global chunk.  The
collectives run on the mesh's time subgroup (``torch.distributed``:
``batch_isend_irecv`` for the halo, ``all_to_all_single`` and
``all_gather`` for the replay, ``broadcast`` from the last time rank for
the carried tails); a 1x1 mesh runs with none.  The receiver's stages run
through the port's kernels on the card and their plain versions on the
CPU, as ``receiver_step`` does.  ``graph.sharded_runner`` runs ``step`` as
a captured CUDA graph (dy4tpu's jitted ``step_c`` with its donated carry),
its collectives captured with it on a mesh with a time axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from dy4tpu_torch.config import ModeConfig
from dy4tpu_torch.ops import mix, pll, trig
from dy4tpu_torch.ops.precision import rounds
from dy4tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS, Mesh
from dy4tpu_torch.pipeline import receiver
from dy4tpu_torch.pipeline.wideband import _map

Tensor = torch.Tensor


class ShardedOutputs(NamedTuple):
    mono: Tensor            # [C_l, S*audio_per_block]
    left: Tensor
    right: Tensor
    pcm: Tensor             # [C_l, out_len] int16 (interleaved if stereo)
    rds_symbols: Optional[Tensor]   # [C_l, S*symbols_per_block] int8
    rds_resync: Optional[Tensor]    # [C_l, S] bool, per block
    rds_offset: Optional[Tensor]    # [C_l, S] int32 CDR phase, per block


class ShardedCarry(NamedTuple):
    """Streaming carry across step() calls (legacy convergent mode)."""
    state: receiver.ReceiverState   # leaves [1, C_l, ...]: this shard's
    prev_tail: Tensor               # [C_l, H] u8: the global stream tail


class ExactCarry(NamedTuple):
    """Streaming carry of the exact time-sharded mode.

    ``front``/``back`` are this shard's warm-start tails (healed by the
    halo each step); the PLL/CDR fields are the global sequential carries.
    """
    front: receiver.FrontState      # leaves [1, C_l, ...]
    back: receiver.BackState        # leaves [1, C_l, ...]
    pll_integ: Tensor               # [C_l, L]  (L = 2 with RDS, else 1)
    pll_phase: Tensor               # [C_l, L]
    pll_angle: Tensor               # [C_l, L]
    cdr: Optional[receiver.CDRState]   # [C_l]
    prev_tail: Tensor               # [C_l, H] u8: the global raw-IQ tail
    prev_codes: Tensor              # [C_l, L, halo_if] i8 sign codes of the
    #                                 stream's last halo_if IF samples
    started: Tensor                 # [] bool: False only before the first
    #                                 step (the reference's nco_q=1 quirk)


def exact_min_halo_if(cfg: ModeConfig) -> int:
    """The shortest sub-block warm-up (IF samples) that heals every LTI
    state exactly, as dy4tpu's.

    Every carried LTI state is a trailing window of stream values, so the
    warm-up only has to cover the deepest chain of window dependencies:
    the RRC tail through the RDS resampler and the delay, the carrier
    chain's two cascaded band filters, the audio resampler, and the RF FIR
    and differentiator behind them all.  The result is rounded up to the
    per-mode alignment, so every stage yields a whole number of outputs
    over it; mode 0 takes 1920 IF samples, a quarter block.
    """
    d = cfg.rf_decim
    kb = cfg.num_taps
    delay = (kb - 1) // 2
    fm_depth = -(-(kb - 1) // d) + 2
    need = max((cfg.audio_taps - 1) // cfg.audio_up + delay,
               2 * (kb - 1))
    if cfg.supports_rds:
        rrc_if = -(-(cfg.rds_rrc_taps - 1) * cfg.rds_down // cfg.rds_up)
        need = max(need,
                   rrc_if + (cfg.rds_taps - 1) // cfg.rds_up + delay)
    need += fm_depth + 8      # stale prev_i/prev_q + slack
    lcm = 128
    if cfg.audio_up == 1:
        lcm = math.lcm(lcm, 128 * cfg.audio_down)
    else:
        lcm = math.lcm(lcm, cfg.audio_down
                       // math.gcd(cfg.audio_up, cfg.audio_down))
    if cfg.supports_rds:
        lcm = math.lcm(lcm, cfg.rds_down
                       // math.gcd(cfg.rds_up, cfg.rds_down))
    halo_if = -(-need // lcm) * lcm
    if halo_if >= cfg.if_per_block:     # degenerate geometry: block halo
        halo_if = -(-halo_if // cfg.if_per_block) * cfg.if_per_block
    return halo_if


def _as_bytes(x: Tensor) -> Tensor:
    """Bool rides the collectives as uint8 (same bytes)."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


class ShardedReceiver:
    """Receiver over a ``(ch, time)`` mesh.

    One ``step`` consumes ``chunk_len = T * shard_blocks * block_size``
    interleaved u8 IQ samples per channel (each rank its ``[C_l,
    shard_blocks * block_size]`` piece) and emits the matching audio and
    RDS symbol streams, sharded the same way.
    """

    def __init__(self, cfg: ModeConfig, mesh: Mesh, *,
                 shard_blocks: int = 4,
                 overlap_blocks: Optional[int] = None,
                 stereo: bool = True, exact: bool = True,
                 channel_parallel_replay: bool = True,
                 precision: str = "highest"):
        """``overlap_blocks``: the warm-up halo.  ``None`` (default) in
        exact mode takes the shortest sub-block halo
        (``exact_min_halo_if``); an int takes whole-block halos, and is
        the only choice of the legacy mode (default 1).  The halo may not
        be longer than one shard's chunk (``shard_blocks`` blocks): the
        halo exchange reads it from one neighbour, and the channel-parallel
        replay carries the chunk's last codes from the last time rank.
        ``precision``: the receiver's ("highest", "high" or "default",
        ``ops/precision.py``), kept as ``self.precision`` as dy4tpu keeps
        it."""
        if TIME_AXIS not in mesh.shape or CH_AXIS not in mesh.shape:
            raise ValueError(f"mesh must have axes ({CH_AXIS},{TIME_AXIS})")
        rounds(precision)       # raises on a name it does not know
        self.cfg = cfg
        self.mesh = mesh
        self.precision = precision
        self.t_shards = mesh.shape[TIME_AXIS]
        self.ch_shards = mesh.shape[CH_AXIS]
        self.shard_blocks = shard_blocks
        self.stereo = stereo
        self.exact = exact
        self.channel_parallel_replay = channel_parallel_replay
        if exact:
            self.halo_if = (exact_min_halo_if(cfg)
                            if overlap_blocks is None
                            else overlap_blocks * cfg.if_per_block)
            self.halo_len = self.halo_if * 2 * cfg.rf_decim
        else:
            if overlap_blocks is None:
                overlap_blocks = 1
            self.halo_if = overlap_blocks * cfg.if_per_block
            self.halo_len = overlap_blocks * cfg.block_size
        self.overlap_blocks = overlap_blocks
        self.chunk_len = self.t_shards * shard_blocks * cfg.block_size
        self.pll_lanes = 2 if cfg.supports_rds else 1
        # dy4tpu drops this guard on its channel-parallel replay
        # (sharded.py:492) and then clamps the carried codes (:531)
        if self.halo_if > shard_blocks * cfg.if_per_block:
            raise ValueError(
                f"halo of {self.halo_if} IF samples is longer than one "
                f"shard's chunk ({shard_blocks} x {cfg.if_per_block}): the "
                f"halo exchange and the channel-parallel replay need halo "
                f"<= shard_blocks * if_per_block")
        self.chan_par = (exact and channel_parallel_replay
                         and self.t_shards > 1)
        f32 = np.float32
        if cfg.supports_rds:
            self._lanes = dict(
                freq=np.array([cfg.pll_freq, cfg.rds_pll_freq], f32),
                norm_bandwidth=np.array([cfg.pll_bandwidth,
                                         cfg.rds_pll_bandwidth], f32))
            scale = [cfg.pll_nco_scale, cfg.rds_pll_nco_scale]
        else:
            self._lanes = dict(freq=np.array([cfg.pll_freq], f32),
                               norm_bandwidth=np.array([cfg.pll_bandwidth],
                                                       f32))
            scale = [cfg.pll_nco_scale]
        self._scale = torch.as_tensor(np.array(scale, f32),
                                      device=mesh.device)

    # ---- public API ----

    def init(self, channels: int):
        """This rank's carry for ``channels`` channels in all."""
        if channels % self.ch_shards:
            raise ValueError(f"channels {channels} not divisible by "
                             f"ch axis {self.ch_shards}")
        self.channels = channels
        c_l = channels // self.ch_shards
        cfg = self.cfg
        dev = self.mesh.device
        prev_tail = torch.full((c_l, self.halo_len), 128, dtype=torch.uint8,
                               device=dev)
        st = receiver.init_state(cfg, batch=(1, c_l), device=dev)
        if not self.exact:
            return ShardedCarry(state=st, prev_tail=prev_tail)
        z = lambda: torch.zeros(c_l, self.pll_lanes,  # noqa: E731
                                device=dev)
        cdr = None
        if cfg.supports_rds:
            cdr = receiver.CDRState(
                offset=torch.zeros(c_l, dtype=torch.int32, device=dev),
                found=torch.zeros(c_l, dtype=torch.bool, device=dev))
        return ExactCarry(
            front=receiver.front_state_of(st),
            back=receiver.back_state_of(st),
            pll_integ=z(), pll_phase=z(), pll_angle=z(), cdr=cdr,
            prev_tail=prev_tail,
            prev_codes=torch.full((c_l, self.pll_lanes, self.halo_if),
                                  pll.CODE_INVALID, dtype=torch.int8,
                                  device=dev),
            started=torch.zeros((), dtype=torch.bool, device=dev))

    def step(self, params: receiver.ReceiverParams, carry,
             iq_u8: Tensor) -> tuple["ShardedCarry | ExactCarry",
                                     ShardedOutputs]:
        """``iq_u8``: this rank's [C_l, shard_blocks * block_size] uint8
        piece of the chunk (``input_sharding``), on the mesh's device."""
        want = (carry.prev_tail.shape[0],
                self.shard_blocks * self.cfg.block_size)
        if (tuple(iq_u8.shape) != want or iq_u8.dtype != torch.uint8
                or iq_u8.device != self.mesh.device):
            raise ValueError(f"iq_u8: expected {want} uint8 on "
                             f"{self.mesh.device}, got "
                             f"{tuple(iq_u8.shape)} {iq_u8.dtype} on "
                             f"{iq_u8.device}")
        if self.exact:
            return self._step_exact(params, carry, iq_u8)
        return self._step_legacy(params, carry, iq_u8)

    def input_sharding(self, iq_u8) -> Tensor:
        """This rank's [C_l, shard_blocks * block_size] piece of a global
        [C, chunk_len] u8 chunk, on the mesh's device: the channel slice of
        its ch index and the time slice of its time index."""
        iq_u8 = torch.as_tensor(iq_u8)
        c, n = iq_u8.shape
        if n != self.chunk_len or c % self.ch_shards:
            raise ValueError(f"chunk of {tuple(iq_u8.shape)}: expected "
                             f"[C, {self.chunk_len}] with C divisible by "
                             f"{self.ch_shards}")
        c_l = c // self.ch_shards
        w = self.shard_blocks * self.cfg.block_size
        ci, ti = self.mesh.ch_index, self.mesh.time_index
        return iq_u8[ci * c_l:(ci + 1) * c_l,
                     ti * w:(ti + 1) * w].to(self.mesh.device).contiguous()

    # ---- collectives on the time axis ----

    def _from_left(self, x: Tensor) -> Optional[Tensor]:
        """Send ``x`` to the right time neighbour and return what the left
        one sent (None on time rank 0)."""
        t, ranks, grp = (self.mesh.time_index, self.mesh.time_ranks,
                         self.mesh.time_group)
        x = x.contiguous()
        ops, got = [], None
        if t + 1 < self.t_shards:
            ops.append(dist.P2POp(dist.isend, x, ranks[t + 1], group=grp))
        if t > 0:
            got = torch.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, got, ranks[t - 1], group=grp))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got

    def _from_last(self, x: Tensor) -> Tensor:
        """The last time rank's ``x``, on every time rank."""
        x = x.contiguous().clone()
        dist.broadcast(_as_bytes(x), self.mesh.time_ranks[-1],
                       group=self.mesh.time_group)
        return x

    def _gather(self, x: Tensor, dim: int) -> Tensor:
        """``x`` of every time rank, concatenated on ``dim`` in time
        order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.t_shards)]
        dist.all_gather([_as_bytes(p) for p in parts], _as_bytes(x),
                        group=self.mesh.time_group)
        return torch.cat(parts, dim)

    def _all_to_all(self, x: Tensor) -> Tensor:
        """``x`` [T, ...]: row j goes to time rank j; row j of the result
        came from time rank j."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(_as_bytes(out), _as_bytes(x),
                               group=self.mesh.time_group)
        return out

    def _tail(self, iq: Tensor) -> Tensor:
        """The global chunk's last ``halo_len`` bytes: the next step's
        halo for time rank 0."""
        tail = iq[:, -self.halo_len:]
        return self._from_last(tail) if self.t_shards > 1 else tail.clone()

    def _left(self, carry, iq: Tensor) -> Tensor:
        """The halo before this shard's piece: the carried global tail on
        time rank 0, the left neighbour's last bytes elsewhere."""
        if self.t_shards == 1:
            return carry.prev_tail
        nbr = self._from_left(iq[:, -self.halo_len:])
        return carry.prev_tail if nbr is None else nbr

    # ---- the two disciplines ----

    def _outputs(self, mono, left, right, syms=None, resync=None,
                 offset=None) -> ShardedOutputs:
        if self.stereo:
            pcm = mix.quantize_s16(mix.interleave(left, right))
        else:
            pcm = mix.quantize_s16(mono)
        return ShardedOutputs(mono=mono, left=left, right=right, pcm=pcm,
                              rds_symbols=syms, rds_resync=resync,
                              rds_offset=offset)

    def _step_legacy(self, params, carry: ShardedCarry, iq: Tensor):
        cfg = self.cfg
        bs = cfg.block_size
        o_blocks = self.overlap_blocks
        ext = torch.cat([self._left(carry, iq), iq], dim=-1)
        state = _map(lambda a: a[0], carry.state)
        outs = []
        for i in range(o_blocks + self.shard_blocks):
            state, out = receiver.receiver_step(
                params, state, ext[:, i * bs:(i + 1) * bs], cfg,
                precision=self.precision)
            outs.append(out)
        keep = outs[o_blocks:]                # the warm-up blocks dropped

        def join(f, how=torch.cat):
            return how([getattr(o, f) for o in keep], -1)

        rds_on = keep[0].rds_symbols is not None
        outputs = self._outputs(
            join("mono"), join("left"), join("right"),
            *((join("rds_symbols"), join("rds_resync", torch.stack),
               join("rds_offset", torch.stack)) if rds_on else ()))
        return (ShardedCarry(state=_map(lambda a: a[None], state),
                             prev_tail=self._tail(iq)), outputs)

    def _step_exact(self, params, carry: ExactCarry, iq: Tensor):
        cfg = self.cfg
        t_shards, s_blocks = self.t_shards, self.shard_blocks
        bs, n_if = cfg.block_size, cfg.if_per_block
        halo_if = self.halo_if
        rds_on = cfg.supports_rds
        t_idx = self.mesh.time_index
        c_l = iq.shape[0]
        lanes = self.pll_lanes

        # ---- stage 1: the LTI front half, time-parallel: the mini
        # warm-up over the halo heals every front state; its outputs feed
        # only the back half's warm-up
        front = _map(lambda a: a[0], carry.front)
        front, fo_mini = receiver.front_step(
            params, front, self._left(carry, iq), cfg,
            precision=self.precision, rds_enabled=rds_on)
        fos = []
        for i in range(s_blocks):
            front, fo = receiver.front_step(
                params, front, iq[:, i * bs:(i + 1) * bs], cfg,
                precision=self.precision, rds_enabled=rds_on)
            fos.append(fo)

        # ---- stage 2: the global PLL replay over the sign codes
        streams = [torch.cat([fo.pilot for fo in fos], -1)]
        if rds_on:
            streams.append(torch.cat([fo.carrier for fo in fos], -1))
        codes_local = torch.stack([pll.encode_sign(v) for v in streams],
                                  dim=-2)                 # [C_l, L, S*N]
        span = halo_if + s_blocks * n_if
        split = t_shards * s_blocks * n_if   # the next chunk's start - halo
        carry0 = (carry.pll_integ, carry.pll_phase, carry.pll_angle)
        if self.chan_par:
            # the replay is serial in time but parallel over channels:
            # each time rank replays one group of cg channels over the
            # whole chunk, channel counts padded with inert INVALID rows
            cg = -(-c_l // t_shards)
            cp = cg * t_shards - c_l

            def pad(x, v):
                return x if cp == 0 else torch.cat(
                    [x, x.new_full((cp, *x.shape[1:]), v)])

            grp = slice(t_idx * cg, (t_idx + 1) * cg)
            got = self._all_to_all(pad(codes_local, pll.CODE_INVALID))
            codes_grp = got.reshape(t_shards, cg, lanes, -1).permute(
                1, 2, 0, 3).reshape(cg, lanes, -1)        # [cg, L, T*S*N]
            codes_all = torch.cat(
                [pad(carry.prev_codes, pll.CODE_INVALID)[grp], codes_grp],
                dim=-1).contiguous()
            phis_g, mid_g, _ = pll.phase_scan_coded(
                codes_all, tuple(pad(c, 0.0)[grp] for c in carry0),
                fs=cfg.if_fs, split_at=split, **self._lanes)
            spans = torch.stack([phis_g[..., j * s_blocks * n_if:
                                        j * s_blocks * n_if + span]
                                 for j in range(t_shards)])
            phis = self._all_to_all(spans).reshape(
                t_shards * cg, lanes, span)[:c_l]         # [C_l, L, span]
            carry_mid = tuple(self._gather(c, 0)[:c_l] for c in mid_g)
            new_prev_codes = self._from_last(codes_local[..., -halo_if:])
        else:
            codes_chunk = (self._gather(codes_local, -1) if t_shards > 1
                           else codes_local)              # [C_l, L, T*S*N]
            codes_all = torch.cat([carry.prev_codes, codes_chunk],
                                  dim=-1).contiguous()
            phis_all, carry_mid, _ = pll.phase_scan_coded(
                codes_all, carry0, fs=cfg.if_fs, split_at=split,
                **self._lanes)
            start = t_idx * s_blocks * n_if
            phis = phis_all[..., start:start + span]
            new_prev_codes = codes_chunk[..., split - halo_if:].contiguous()

        # NCO synthesis with pll.pll's float ops, so the samples match the
        # sequential receiver's bit for bit
        nco_q2, nco_i2 = trig.nco_sincos(phis * self._scale[:, None])
        nco = nco_i2[:, 0]
        nco_i = nco_q = None
        if rds_on:
            nco_i = nco_i2[:, 1]
            nco_q = nco_q2[:, 1]
            if t_idx == 0:
                # the reference's quirk: the stream's first quadrature NCO
                # sample is the init value 1.0 (fmMonoBlock.py:441)
                nco_q = nco_q.clone()
                nco_q[:, halo_if] = torch.where(
                    carry.started, nco_q[:, halo_if], 1.0)

        # ---- stage 3: the NCO-mixed back half, time-parallel, after its
        # own warm-up over the halo
        def cut(x, lo, n):
            return None if x is None else x[:, lo:lo + n]

        back = _map(lambda a: a[0], carry.back)
        back, _ = receiver.back_step(
            params, back, fo_mini, cut(nco, 0, halo_if),
            cut(nco_i, 0, halo_if), cut(nco_q, 0, halo_if), cfg,
            precision=self.precision, rds_enabled=rds_on)
        bos = []
        for i, fo in enumerate(fos):
            lo = halo_if + i * n_if
            back, bo = receiver.back_step(
                params, back, fo, cut(nco, lo, n_if), cut(nco_i, lo, n_if),
                cut(nco_q, lo, n_if), cfg, precision=self.precision,
                rds_enabled=rds_on)
            bos.append(bo)

        def cat(f):
            return torch.cat([getattr(b, f) for b in bos], -1)

        # ---- stage 4: the global CDR, replayed over the gathered
        # baseband like the PLL
        new_cdr = carry.cdr
        rds_out = ()
        if rds_on:
            bb = torch.stack([torch.stack([b.bb_i, b.bb_q], -2)
                              for b in bos])              # [S, C_l, 2, M]
            if self.chan_par:
                bbp = pad(bb.transpose(0, 1), 0.0).transpose(0, 1)
                send = bbp.reshape(s_blocks, t_shards, cg,
                                   *bb.shape[2:]).transpose(0, 1)
                bb_grp = self._all_to_all(send).reshape(
                    t_shards * s_blocks, cg, *bb.shape[2:])
                cdr_grp = receiver.CDRState(*(pad(a, 0)[grp]
                                              for a in carry.cdr))
                cdr_g, rds_all = self._cdr_replay(cdr_grp, bb_grp)
                new_cdr = receiver.CDRState(*(self._gather(a, 0)[:c_l]
                                              for a in cdr_g))

                def mine(x):     # [T*S, cg, ...] -> [S, C_l, ...]
                    got = self._all_to_all(x.reshape(t_shards, s_blocks,
                                                      *x.shape[1:]))
                    return got.transpose(0, 1).reshape(
                        s_blocks, t_shards * cg, *x.shape[2:])[:, :c_l]
            else:
                bb_all = self._gather(bb, 0) if t_shards > 1 else bb
                new_cdr, rds_all = self._cdr_replay(carry.cdr, bb_all)

                def mine(x):     # [T*S, C_l, ...] -> [S, C_l, ...]
                    return x[t_idx * s_blocks:(t_idx + 1) * s_blocks]
            syms, resync, offset = (mine(x) for x in rds_all)
            rds_out = (syms.movedim(0, -2).reshape(c_l, -1),
                       resync.movedim(0, -1), offset.movedim(0, -1))

        outputs = self._outputs(cat("mono"), cat("left"), cat("right"),
                                *rds_out)
        i2, p2, a2 = carry_mid
        return (ExactCarry(front=_map(lambda a: a[None], front),
                           back=_map(lambda a: a[None], back),
                           pll_integ=i2, pll_phase=p2, pll_angle=a2,
                           cdr=new_cdr, prev_tail=self._tail(iq),
                           prev_codes=new_prev_codes,
                           started=torch.ones_like(carry.started)),
                outputs)

    def _cdr_replay(self, cdr: receiver.CDRState, bb: Tensor):
        """The CDR over [blocks, c, 2, M] baseband in block order.  Returns
        the final CDR state and the per-block symbols, resync flags and
        offsets, each stacked on a leading block axis."""
        syms, resync, offset = [], [], []
        for blk in bb:
            _si, _sq, s, r, cdr = receiver._cdr(blk[..., 0, :], blk[..., 1, :],
                                                cdr, self.cfg.rds_sps)
            syms.append(s)
            resync.append(r)
            offset.append(cdr.offset)
        return cdr, (torch.stack(syms), torch.stack(resync),
                     torch.stack(offset))

"""The per-block FM receiver in PyTorch: the counterpart of
``dy4tpu/pipeline/receiver.py`` in all four modes (mono, stereo, and RDS
where the mode has it), from raw RF or from IF I/Q.

    receiver_step(params, state, iq_u8, cfg) -> (state', outputs)
    receiver_step_if(params, state, i_if, q_if, cfg) -> (state', outputs)

over a ``[channels, block]`` u8 batch (or ``[channels, if_per_block]``
float32 I and Q at the IF rate), with every piece of carried state in
``ReceiverState``.  The NamedTuples mirror dy4tpu's field for field,
so a state can be handed from one package to the other mid-stream
(``pipeline/convert.py``).

Three stages, as in dy4tpu: ``front_step`` / ``front_step_if`` (the LTI
front half), the pilot PLL (stacked with the RDS-carrier PLL where RDS is
on), and ``back_step`` (the NCO-mixed LTI back half: the U=1 audio back end
in modes 0 and 1, the rational one in modes 2 and 3) + clock/data
recovery.  Each stage selects its implementation:

  * ``"auto"`` (default): the hand-written CUDA kernel for a CUDA tensor,
    the plain torch version for a CPU tensor;
  * ``"plain"``: the plain torch version on any device (tests and the
    chip smoke's comparisons);
  * ``front_step`` alone also takes dy4tpu's A/B front ends,
    ``"fused-rf"`` (B11, ``frontend_cuda.fused_frontend_raw``) and
    ``"fused-phase"`` (B12, ``frontend_cuda.fused_frontend``): the RF stage
    to fm as a kernel on a CUDA tensor (its plain version on a CPU one),
    then the band stages in plain torch (``frontend_cuda.band_stages_
    plain``), as dy4tpu leaves them to XLA on these routes.

No environment variable picks the path, and a CUDA tensor never falls
back to the plain version silently.  Everything is float32 (dy4tpu's
``precision=HIGHEST``).

Opt-in features, as dy4tpu's: the narrowband IQ tracker
(``init_state(with_iqcorr=True)``: each block is corrected with the
coefficients of the blocks before it, inside B1's corr epilogue, and the
block's pre-correction moments are folded in), the span PLL
(``pll_span=K``, with ``pll_span_emit="kernel"`` for B9-expand), the
Kaiser audio filter (``make_params(audio_filter=
"kaiser")``) and the envelope CDR (``cdr_timing="envelope"``).  The entry
points put params and state on the card unless the caller asks for the
CPU (``device="cpu"``, as the tests do).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dy4tpu_torch.config import ModeConfig
from dy4tpu_torch.ops import (backend_cuda, demod, fir, firdes,
                              frontend_cuda, iqcorr, mix, pll, resample_cuda)

Tensor = torch.Tensor


class ReceiverParams(NamedTuple):
    """Filter coefficient tables (computed once per mode)."""
    rf_coeff: Tensor        # [taps] RF LPF 100 kHz (project.cpp:262)
    audio_coeff: Tensor     # [taps*U] audio LPF 16 kHz, gain*U
    bank_coeff: Tensor      # [F, taps] pilot / stereo / RDS-band filters
    rds_carrier_coeff: Optional[Tensor]  # [taps] 113.5-114.5 kHz
    rds_lpf_coeff: Optional[Tensor]      # [taps*U_rds] 3 kHz, gain*U_rds
    rds_rrc_coeff: Optional[Tensor]      # [taps] RRC at rds_fs


class RFState(NamedTuple):
    iq_tail: Tensor         # [..., 2, taps-1] I/Q LPF overlap-save tails
    prev_i: Tensor          # [...]
    prev_q: Tensor          # [...]


class AudioState(NamedTuple):
    mono_delay: Tensor      # [..., taps//2] all-pass delay line
    mono_tail: Tensor       # [..., (taps*U-1)//U] mono resampler tail
    bank_tail: Tensor       # [..., taps-1] ONE shared band-bank history
    stereo_tail: Tensor     # [..., (taps*U-1)//U] post-mix resampler tail
    pll: pll.PLLState       # stereo pilot PLL


class CDRState(NamedTuple):
    """Clock/data recovery carry (fmSupportLib.py:209-247)."""
    offset: Tensor          # [...] int32, sampling phase in [0, sps)
    found: Tensor           # [...] bool, timing lock flag


class RDSState(NamedTuple):
    carrier_tail: Tensor    # [..., taps-1]
    delay: Tensor           # [..., taps//2]
    lpf_tail_i: Tensor      # [..., (taps*U_rds-1)//U_rds]
    lpf_tail_q: Tensor
    rrc_tail_i: Tensor      # [..., taps-1]
    rrc_tail_q: Tensor
    pll: pll.PLLState
    cdr: CDRState


class ReceiverState(NamedTuple):
    rf: RFState
    audio: AudioState
    rds: Optional[RDSState]
    iqcorr: Optional[iqcorr.IQCorrState] = None   # opt-in IQ tracker


class StepOutputs(NamedTuple):
    mono: Tensor            # [..., audio_per_block] float32
    left: Tensor            # [..., audio_per_block]
    right: Tensor           # [..., audio_per_block]
    rds_bb_i: Optional[Tensor]    # [..., rds_per_block] post-RRC in-phase
    rds_bb_q: Optional[Tensor]
    rds_symbols: Optional[Tensor]  # [..., symbols_per_block] int8 hard bits
    rds_sym_i: Optional[Tensor]    # sampled I at symbol instants (soft)
    rds_resync: Optional[Tensor]   # [...] bool: CDR re-acquired this block
    rds_offset: Optional[Tensor]   # [...] int32: CDR sampling phase used
    pilot_snr_db: Tensor = None    # [...] pilot-lock SNR estimate (dB)


class FrontState(NamedTuple):
    """Carried state of the LTI front half (everything before the PLLs)."""
    rf: RFState
    mono_delay: Tensor
    bank_tail: Tensor
    carrier_tail: Optional[Tensor]
    rds_delay: Optional[Tensor]


class FrontOut(NamedTuple):
    """Per-block LTI signals feeding the PLLs and the back half."""
    fm_delayed: Tensor         # [..., if_per_block]
    pilot: Tensor              # [..., if_per_block]: stereo PLL input
    stereo_band: Tensor
    carrier: Optional[Tensor]  # RDS carrier BPF output: RDS PLL input
    rds_delayed: Optional[Tensor]


class BackState(NamedTuple):
    """Carried state of the post-PLL half."""
    mono_tail: Tensor
    stereo_tail: Tensor
    lpf_tail_i: Optional[Tensor]
    lpf_tail_q: Optional[Tensor]
    rrc_tail_i: Optional[Tensor]
    rrc_tail_q: Optional[Tensor]


class BackOut(NamedTuple):
    mono: Tensor
    left: Tensor
    right: Tensor
    bb_i: Optional[Tensor]     # post-RRC baseband (CDR input)
    bb_q: Optional[Tensor]


_IMPLS = ("auto", "plain")
_DEMODS = ("diff", "arctan")
_AB_FRONTENDS = ("fused-rf", "fused-phase")   # dy4tpu's A/B front ends
_FRONTENDS = _IMPLS + _AB_FRONTENDS


def _rds_on(cfg: ModeConfig, with_rds) -> bool:
    return cfg.supports_rds if with_rds is None else (
        bool(with_rds) and cfg.supports_rds)


def front_state_of(state: ReceiverState) -> FrontState:
    rds = state.rds
    return FrontState(rf=state.rf, mono_delay=state.audio.mono_delay,
                      bank_tail=state.audio.bank_tail,
                      carrier_tail=None if rds is None else rds.carrier_tail,
                      rds_delay=None if rds is None else rds.delay)


def back_state_of(state: ReceiverState) -> BackState:
    rds = state.rds
    return BackState(
        mono_tail=state.audio.mono_tail,
        stereo_tail=state.audio.stereo_tail,
        lpf_tail_i=None if rds is None else rds.lpf_tail_i,
        lpf_tail_q=None if rds is None else rds.lpf_tail_q,
        rrc_tail_i=None if rds is None else rds.rrc_tail_i,
        rrc_tail_q=None if rds is None else rds.rrc_tail_q)


def _flattener(batch: torch.Size):
    """(flat, unflat): [*batch, ...] <-> contiguous [prod(batch), ...],
    the 2-D layout the kernels take.  None passes through."""
    nb = len(batch)

    def flat(a):
        if a is None:
            return None
        return a.reshape(-1, *a.shape[nb:]).contiguous()

    def unflat(a):
        return None if a is None else a.reshape((*batch, *a.shape[1:]))

    return flat, unflat


def fused_phase_frontend_ok(cfg: ModeConfig) -> bool:
    """Whether ``front_step(frontend="fused-phase")`` takes this mode: its
    taps must phase-align to the decimation, ``(num_taps-1) % rf_decim ==
    0``.  dy4tpu's 128-lane gate (``fused_frontend_ok``) is a TPU layout
    rule; the port's kernels run every geometry."""
    return (cfg.num_taps - 1) % cfg.rf_decim == 0


def front_step(params: ReceiverParams, fstate: FrontState, iq_u8: Tensor,
               cfg: ModeConfig, *, rds_enabled: bool = True,
               frontend: str = "auto", demod_kind: str = "diff",
               corr: Optional[iqcorr.IQCorrCoeffs] = None,
               corr_moments: bool = False):
    """RF front end + band bank + RDS carrier recovery filters: the LTI
    half of the receiver (project.cpp:72-93 + fmMonoBlock.py:673-680).
    Returns ``(FrontState, FrontOut)``, and with ``corr_moments`` the
    block's IQ-tracker moments [..., 14] as a third value.

    ``frontend``: "auto" (``frontend_cuda.fused_frontend_full``, its
    corr variant with ``corr``: the kernel on a CUDA tensor, the plain
    version on a CPU one), "plain" (its plain version on any device), or
    dy4tpu's A/B routes "fused-rf" (B11) and "fused-phase" (B12, which
    needs ``fused_phase_frontend_ok(cfg)``): the RF stage to fm, then
    ``frontend_cuda.band_stages_plain``.

    ``corr``: batch-shaped IQ correction coefficients applied to the
    decimated I/Q before the demod; ``corr_moments`` (which needs
    ``corr``, as in dy4tpu) also returns the moments of that I/Q before
    the correction.  The A/B routes stop at fm and take no correction,
    as dy4tpu's.

    ``demod_kind``: "diff" (the differentiator the reference runs in real
    time, src/filter.cpp:85-102: the production path, B1's) or "arctan"
    (``demod.fm_demod_arctan``, the phase-unwrap demod of the reference's
    Python model, fmMonoBlock.py:628, kept as dy4tpu keeps it so a
    full-chain test can pin the chain against that model).  dy4tpu runs
    "arctan" on its stock path only and raises for its kernel front ends;
    so does the port: "arctan" takes ``frontend`` "auto" or "plain" and
    runs the plain front end on any device (B1 has no arctan demod), and
    raises ``ValueError`` for the A/B routes.  With "arctan" the
    ``RFState.prev_i`` slot carries the previous block's phase and
    ``prev_q`` the last Q sample, as in dy4tpu.

    ``iq_u8`` [..., n]: a whole block, or any n that decimates into whole
    IF samples (the sharded receiver's sub-block warm-up).
    """
    if demod_kind not in _DEMODS:
        raise ValueError(f"demod_kind must be one of {_DEMODS}, got "
                         f"{demod_kind!r}")
    if demod_kind == "arctan" and frontend not in _IMPLS:
        raise ValueError(f"demod_kind='arctan' runs the plain front end; "
                         f"frontend must be one of {_IMPLS}, got "
                         f"{frontend!r}")
    if iq_u8.shape[-1] % (2 * cfg.rf_decim):
        raise ValueError(f"block of {iq_u8.shape[-1]} bytes; mode "
                         f"{cfg.mode} takes a multiple of "
                         f"{2 * cfg.rf_decim} ({cfg.block_size} a block)")
    if corr is not None and frontend in _AB_FRONTENDS:
        raise ValueError(f"IQ correction unsupported with frontend="
                         f"{frontend!r}; use one of {_IMPLS}")
    if corr_moments and corr is None:
        raise ValueError("corr_moments=True requires corr (the front end "
                         "emits the moments with its correction epilogue)")
    if frontend == "fused-phase" and not fused_phase_frontend_ok(cfg):
        raise ValueError(f"frontend='fused-phase' needs phase-aligned taps "
                         f"((taps-1) % decim == 0; taps={cfg.num_taps}, "
                         f"decim={cfg.rf_decim})")
    if demod_kind == "arctan":
        return _front_step_arctan(params, fstate, iq_u8, cfg, rds_enabled,
                                  corr, corr_moments)
    flat, unflat, plain = _route(frontend, iq_u8.shape[:-1], _FRONTENDS)
    if frontend in _AB_FRONTENDS:
        return _front_step_ab(params, fstate, flat(iq_u8), cfg, rds_enabled,
                              frontend, flat, unflat)
    args = (flat(iq_u8), params.rf_coeff, params.bank_coeff,
            params.rds_carrier_coeff, flat(fstate.rf.iq_tail),
            flat(fstate.rf.prev_i), flat(fstate.rf.prev_q),
            flat(fstate.bank_tail), flat(fstate.mono_delay),
            flat(fstate.carrier_tail), flat(fstate.rds_delay), cfg.rf_decim)
    front = (frontend_cuda.fused_frontend_full_plain if plain
             else frontend_cuda.fused_frontend_full)
    corr_rows = (None if corr is None else
                 torch.stack([flat(c) for c in corr], dim=-1))  # [..., 4]
    outs = front(*args, rds=rds_enabled, corr=corr_rows)
    ret = _front_state(outs[:5] + outs[6:12], unflat(outs[5]), unflat)
    return (*ret, unflat(outs[12])) if corr_moments else ret


def _front_step_arctan(params: ReceiverParams, fstate: FrontState,
                       iq_u8: Tensor, cfg: ModeConfig, rds_enabled: bool,
                       corr: Optional[iqcorr.IQCorrCoeffs],
                       corr_moments: bool):
    """``front_step(demod_kind="arctan")``: dy4tpu's stock front end with
    the phase-unwrap demod, in plain torch on any leading batch dims."""
    i_ds, q_ds, iq_tail = frontend_cuda.rf_lpf_plain(
        iq_u8, params.rf_coeff, fstate.rf.iq_tail, cfg.rf_decim)
    mom = iqcorr.moments(i_ds, q_ds) if corr_moments else None
    if corr is not None:
        i_ds, q_ds = iqcorr.apply(i_ds, q_ds, corr)
    fm, phase = demod.fm_demod_arctan(i_ds, q_ds, fstate.rf.prev_i)
    (fmd, pilot, stereo, carrier, rdsdel, bank_tail, mono_delay,
     carrier_tail, rds_delay) = frontend_cuda.band_stages_plain(
        fm, params.bank_coeff, params.rds_carrier_coeff, fstate.bank_tail,
        fstate.mono_delay, fstate.carrier_tail, fstate.rds_delay,
        rds=rds_enabled)
    ret = _front_state((fmd, pilot, stereo, carrier, rdsdel, phase,
                        q_ds[..., -1], bank_tail, mono_delay, carrier_tail,
                        rds_delay), iq_tail, lambda a: a)
    return (*ret, mom) if corr_moments else ret


def _front_step_ab(params: ReceiverParams, fstate: FrontState,
                   iq_u8: Tensor, cfg: ModeConfig, rds_enabled: bool,
                   frontend: str, flat, unflat):
    """``front_step`` on an A/B route: B11 or B12 on the flattened
    ``iq_u8`` [C, bs] (their plain versions on a CPU tensor), then the
    post-demod band stages in plain torch."""
    rf = (frontend_cuda.fused_frontend_raw if frontend == "fused-rf"
          else frontend_cuda.fused_frontend)
    fm, iq_tail, prev_i, prev_q = rf(
        iq_u8, params.rf_coeff, flat(fstate.rf.iq_tail),
        flat(fstate.rf.prev_i), flat(fstate.rf.prev_q), cfg.rf_decim)
    (fmd, pilot, stereo, carrier, rdsdel, bank_tail, mono_delay,
     carrier_tail, rds_delay) = frontend_cuda.band_stages_plain(
        fm, params.bank_coeff, params.rds_carrier_coeff,
        flat(fstate.bank_tail), flat(fstate.mono_delay),
        flat(fstate.carrier_tail), flat(fstate.rds_delay), rds=rds_enabled)
    outs = (fmd, pilot, stereo, carrier, rdsdel, prev_i, prev_q, bank_tail,
            mono_delay, carrier_tail, rds_delay)
    return _front_state(outs, unflat(iq_tail), unflat)


def _route(frontend: str, batch: torch.Size, allowed=_IMPLS):
    """``(flat, unflat, plain)`` for a front end: the plain versions take
    any leading batch dims as they are, the kernel wrappers a contiguous
    ``[C, ...]`` (``_flattener``)."""
    if frontend not in allowed:
        raise ValueError(f"frontend must be one of {allowed}, got "
                         f"{frontend!r}")
    if frontend == "plain":
        same = lambda a: a  # noqa: E731
        return same, same, True
    return (*_flattener(batch), False)


def _front_state(outs, iq_tail: Tensor, unflat
                 ) -> tuple[FrontState, FrontOut]:
    """``(FrontState, FrontOut)`` from a front end's outputs: the five
    streams, ``prev_i``/``prev_q`` and the four band tails; ``iq_tail``
    is the new RF tail."""
    (fmd, pilot, stereo, carrier, rds_delayed, prev_i, prev_q, bank_tail,
     mono_delay, carrier_tail, rds_delay) = (unflat(o) for o in outs)
    return (FrontState(rf=RFState(iq_tail=iq_tail, prev_i=prev_i,
                                  prev_q=prev_q),
                       mono_delay=mono_delay, bank_tail=bank_tail,
                       carrier_tail=carrier_tail, rds_delay=rds_delay),
            FrontOut(fm_delayed=fmd, pilot=pilot, stereo_band=stereo,
                     carrier=carrier, rds_delayed=rds_delayed))


def front_step_if(params: ReceiverParams, fstate: FrontState, i_if: Tensor,
                  q_if: Tensor, cfg: ModeConfig, *, rds_enabled: bool = True,
                  frontend: str = "auto") -> tuple[FrontState, FrontOut]:
    """IF-entry front half: complex baseband at the IF rate (e.g. one
    channel of a channelizer) instead of raw RF u8.  The RF LPF and
    decimation are skipped; from the FM demod on it is ``front_step``.
    ``i_if``/``q_if``: [..., if_per_block] float32.  The RF ``iq_tail`` is
    carried through untouched, so the state stays interchangeable with
    the RF entry's.

    ``frontend``: "auto" (``frontend_cuda.fused_frontend_if``: the kernel
    on a CUDA tensor, the plain version on a CPU one) or "plain" (its
    plain version on any device).  The A/B routes are RF stages, which
    the IF entry does not have: they raise here.
    """
    if i_if.shape[-1] != cfg.if_per_block or q_if.shape != i_if.shape:
        raise ValueError(f"IF blocks of {tuple(i_if.shape)} and "
                         f"{tuple(q_if.shape)}; mode {cfg.mode} takes "
                         f"[..., {cfg.if_per_block}] for both")
    flat, unflat, plain = _route(frontend, i_if.shape[:-1])
    front = (frontend_cuda.fused_frontend_if_plain if plain
             else frontend_cuda.fused_frontend_if)
    outs = front(flat(i_if), flat(q_if), flat(fstate.rf.prev_i),
                 flat(fstate.rf.prev_q), params.bank_coeff,
                 params.rds_carrier_coeff, flat(fstate.bank_tail),
                 flat(fstate.mono_delay), flat(fstate.carrier_tail),
                 flat(fstate.rds_delay), rds=rds_enabled)
    return _front_state(outs, fstate.rf.iq_tail, unflat)


def back_step(params: ReceiverParams, bstate: BackState, fo: FrontOut,
              nco: Tensor, nco_i: Optional[Tensor], nco_q: Optional[Tensor],
              cfg: ModeConfig, *, rds_enabled: bool = True,
              backend: str = "auto") -> tuple[BackState, BackOut]:
    """Audio resampling + stereo matrix + RDS matched filtering: the
    post-PLL half (project.cpp:118-133; fmMonoBlock.py:684-696).  ``nco``
    is the stereo pilot NCO; ``nco_i``/``nco_q`` the RDS quadrature NCO
    pair (None when RDS is off).

    ``backend``: "auto" (the ``backend_cuda``/``resample_cuda`` wrappers:
    kernels on CUDA tensors, plain versions on CPU ones) or "plain".  The
    audio leg takes the U=1 back end when ``cfg.audio_up`` is 1 (modes 0
    and 1) and the rational one otherwise (modes 2 and 3).
    """
    if backend not in _IMPLS:
        raise ValueError(f"backend must be one of {_IMPLS}, got {backend!r}")
    plain = backend == "plain"
    batch = fo.fm_delayed.shape[:-1]
    flat, unflat = ((lambda a: a), (lambda a: a)) if plain else (
        _flattener(batch))
    if cfg.audio_up == 1:
        audio = (backend_cuda.fused_audio_backend_plain if plain
                 else backend_cuda.fused_audio_backend)
        rate = (cfg.audio_down,)
    else:
        audio = (resample_cuda.fused_audio_backend_rational_plain if plain
                 else resample_cuda.fused_audio_backend_rational)
        rate = (cfg.audio_up, cfg.audio_down)
    mono, left, right, mono_tail, stereo_tail = (
        unflat(o) for o in audio(
            flat(fo.fm_delayed), flat(fo.stereo_band), flat(nco),
            params.audio_coeff, flat(bstate.mono_tail),
            flat(bstate.stereo_tail), *rate))

    bb_i = bb_q = None
    lpf_tail_i = lpf_tail_q = rrc_tail_i = rrc_tail_q = None
    if rds_enabled:
        rds = (resample_cuda.fused_rds_backend_plain if plain
               else resample_cuda.fused_rds_backend)
        (bb_i, bb_q, lpf_tail_i, lpf_tail_q, rrc_tail_i, rrc_tail_q) = (
            unflat(o) for o in rds(
                flat(fo.rds_delayed), flat(nco_i), flat(nco_q),
                params.rds_lpf_coeff, params.rds_rrc_coeff,
                flat(bstate.lpf_tail_i), flat(bstate.lpf_tail_q),
                flat(bstate.rrc_tail_i), flat(bstate.rrc_tail_q),
                cfg.rds_up, cfg.rds_down))

    return (BackState(mono_tail=mono_tail, stereo_tail=stereo_tail,
                      lpf_tail_i=lpf_tail_i, lpf_tail_q=lpf_tail_q,
                      rrc_tail_i=rrc_tail_i, rrc_tail_q=rrc_tail_q),
            BackOut(mono=mono, left=left, right=right, bb_i=bb_i,
                    bb_q=bb_q))


def make_params(cfg: ModeConfig, with_rds: Optional[bool] = None,
                audio_filter: str = "reference",
                device="cuda") -> ReceiverParams:
    """Design all filters for a mode (host-side, run once) and put them
    on ``device`` (the card unless the caller asks for the CPU).
    ``with_rds=False`` omits the RDS filters (and must be matched by the
    same flag in ``init_state``).  ``audio_filter``: "reference" (the
    reference's Hann windowed sinc) or "kaiser" (the same geometry, about
    30 dB more alias rejection)."""
    designs = {"reference": firdes.lpf, "kaiser": firdes.lpf_kaiser}
    if audio_filter not in designs:
        raise ValueError(f"audio_filter must be one of {sorted(designs)}, "
                         f"got {audio_filter!r}")
    if_fs = cfg.if_fs
    t = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        a, device=device)
    rf = firdes.lpf(cfg.rf_fs, cfg.rf_fc, cfg.num_taps)
    audio = designs[audio_filter](if_fs * cfg.audio_up, cfg.audio_fc,
                                  cfg.audio_taps, up_factor=cfg.audio_up)
    bank = [firdes.bpf(if_fs, cfg.pilot_fb, cfg.pilot_fe, cfg.num_taps),
            firdes.bpf(if_fs, cfg.stereo_fb, cfg.stereo_fe, cfg.num_taps)]
    carrier = rds_lpf = rrc = None
    if _rds_on(cfg, with_rds):
        bank.append(firdes.bpf(if_fs, cfg.rds_fb, cfg.rds_fe, cfg.num_taps))
        carrier = firdes.bpf(if_fs, cfg.rds_carrier_fb, cfg.rds_carrier_fe,
                             cfg.num_taps)
        rds_lpf = firdes.lpf(if_fs * cfg.rds_up, cfg.rds_fc, cfg.rds_taps,
                             up_factor=cfg.rds_up)
        rrc = firdes.rrc(cfg.rds_fs, cfg.rds_rrc_taps, cfg.rds_symbol_rate)
    return ReceiverParams(rf_coeff=t(rf), audio_coeff=t(audio),
                          bank_coeff=t(np.stack(bank)),
                          rds_carrier_coeff=t(carrier),
                          rds_lpf_coeff=t(rds_lpf), rds_rrc_coeff=t(rrc))


def init_state(cfg: ModeConfig, batch: tuple[int, ...] = (),
               dtype=torch.float32, with_rds: Optional[bool] = None,
               with_iqcorr: bool = False, device="cuda") -> ReceiverState:
    """Zero state for ``batch`` streams on ``device`` (the card unless the
    caller asks for the CPU); ``with_iqcorr`` adds the IQ tracker."""
    t = cfg.num_taps
    z = lambda *s: torch.zeros((*batch, *s), dtype=dtype,  # noqa: E731
                               device=device)
    audio_tail = fir.state_len(cfg.audio_taps, cfg.audio_up)
    rf = RFState(iq_tail=z(2, t - 1), prev_i=z(), prev_q=z())
    audio = AudioState(mono_delay=z(t // 2), mono_tail=z(audio_tail),
                       bank_tail=z(t - 1), stereo_tail=z(audio_tail),
                       pll=pll.init_state(batch, dtype, device))
    rds = None
    if _rds_on(cfg, with_rds):
        lpf_tail = fir.state_len(cfg.rds_taps, cfg.rds_up)
        rds = RDSState(
            carrier_tail=z(t - 1), delay=z(t // 2),
            lpf_tail_i=z(lpf_tail), lpf_tail_q=z(lpf_tail),
            rrc_tail_i=z(cfg.rds_rrc_taps - 1),
            rrc_tail_q=z(cfg.rds_rrc_taps - 1),
            pll=pll.init_state(batch, dtype, device),
            cdr=CDRState(
                offset=torch.zeros(batch, dtype=torch.int32, device=device),
                found=torch.zeros(batch, dtype=torch.bool, device=device)))
    return ReceiverState(
        rf=rf, audio=audio, rds=rds,
        iqcorr=(iqcorr.init_iqcorr_state(batch, dtype, device)
                if with_iqcorr else None))


_CDR_TIMINGS = ("peak", "envelope")


def _cdr(bb_i: Tensor, bb_q: Tensor, state: CDRState, sps: int,
         timing: str = "peak"):
    """Clock/data recovery: pick a sampling phase when unlocked, then
    sample every ``sps``-th baseband sample (fmSupportLib.py:209-247,
    with the offset reduced mod sps so every block yields ``len/sps``
    symbols).  ``timing`` picks the acquisition estimator, as dy4tpu's
    (``_check_step`` refuses any other value):

    - "peak" (the reference's): the strongest |I| sample in the first
      2*sps; ties take the first, as ``jnp.argmax`` does;
    - "envelope": square-law spectral timing (Oerder & Meyr): the
      envelope i^2+q^2 of the RRC-shaped baseband has a line at the
      symbol rate whose phase is the sampling phase, ``tau = arg(sum_n
      e[n] exp(-j 2 pi n/sps)) * sps/(2 pi)``, so every sample of the
      block votes.

    Returns ``(sym_i, sym_q, symbols, resync, new_state)``."""
    n = bb_i.shape[-1]
    m = n // sps
    if timing == "envelope":
        w = 2.0 * np.pi * np.arange(n) / sps
        cos = torch.as_tensor(np.cos(w), dtype=bb_i.dtype, device=bb_i.device)
        sin = torch.as_tensor(np.sin(w), dtype=bb_i.dtype, device=bb_i.device)
        e = bb_i * bb_i + bb_q * bb_q
        tau = torch.atan2(torch.sum(e * sin, dim=-1),
                          torch.sum(e * cos, dim=-1)) * (sps / (2.0 * np.pi))
        cand = torch.round(tau).to(torch.int32) % sps
    else:
        search = torch.abs(bb_i[..., : 2 * sps])
        cand = (torch.argmax(search, dim=-1) % sps).to(torch.int32)
    resync = ~state.found
    offset = torch.where(resync, cand, state.offset)
    idx = (offset.to(torch.int64)[..., None]
           + sps * torch.arange(m, device=bb_i.device))     # [..., m]
    sym_i = torch.gather(bb_i, -1, idx)
    sym_q = torch.gather(bb_q, -1, idx)
    symbols = (sym_i >= 0).to(torch.int8)
    thresh = 0.05
    lost = ((torch.abs(sym_i[..., -1]) < thresh)
            & (torch.abs(sym_i[..., -2]) < thresh))
    return sym_i, sym_q, symbols, resync, CDRState(offset=offset,
                                                   found=~lost)


def receiver_step(params: ReceiverParams, state: ReceiverState,
                  iq_u8: Tensor, cfg: ModeConfig,
                  with_rds: Optional[bool] = None, frontend: str = "auto",
                  backend: str = "auto", pll_impl: str = "auto",
                  cdr_timing: str = "peak", pll_span: int = 1,
                  pll_span_emit: str = "torch", demod_kind: str = "diff"
                  ) -> tuple[ReceiverState, StepOutputs]:
    """Process one block of interleaved u8 IQ samples.

    ``iq_u8``: [..., block_size] uint8 (I even, Q odd).  ``frontend``:
    "auto", "plain", "fused-rf" or "fused-phase" (``front_step``);
    ``backend``: "auto" or "plain" (module docstring); ``pll_impl``:
    "auto", "kernel" or "plain" (``ops/pll.py``); ``cdr_timing``: "peak"
    or "envelope" (``_cdr``; dy4tpu's default when ``DY4TPU_CDR`` is
    unset is "peak"); ``pll_span``: 1 (the exact per-sample PLL) or K > 1
    (the span PLL; dy4tpu's ``DY4TPU_PLL_SPAN``); ``pll_span_emit``:
    "torch" or "kernel" (B9-expand; dy4tpu's ``DY4TPU_SPAN_EMIT``), see
    ``pll.pll``; ``demod_kind``: "diff" or "arctan" (``front_step``).  The
    port reads no environment variable.

    With an ``iqcorr`` tracker in the state, the block is corrected with
    the coefficients of the blocks before it (block 0 is the identity),
    and the front end's decimated pre-correction I/Q moments are folded
    into the tracker.
    """
    _check_step(state, cdr_timing)
    rds_enabled = _rds_on(cfg, with_rds) and state.rds is not None
    new_iqcorr = None
    if state.iqcorr is not None:
        corr = iqcorr.coeffs(state.iqcorr)
        fstate, fo, mom = front_step(
            params, front_state_of(state), iq_u8, cfg,
            rds_enabled=rds_enabled, frontend=frontend,
            demod_kind=demod_kind, corr=corr, corr_moments=True)
        new_iqcorr = iqcorr.fold(state.iqcorr, mom)
    else:
        fstate, fo = front_step(params, front_state_of(state), iq_u8, cfg,
                                rds_enabled=rds_enabled, frontend=frontend,
                                demod_kind=demod_kind)
    return _finish_step(params, state, fstate, fo, cfg, rds_enabled,
                        backend, pll_impl, cdr_timing, pll_span, new_iqcorr,
                        pll_span_emit)


def receiver_step_if(params: ReceiverParams, state: ReceiverState,
                     i_if: Tensor, q_if: Tensor, cfg: ModeConfig,
                     with_rds: Optional[bool] = None, frontend: str = "auto",
                     backend: str = "auto", pll_impl: str = "auto",
                     cdr_timing: str = "peak", pll_span: int = 1,
                     pll_span_emit: str = "torch"
                     ) -> tuple[ReceiverState, StepOutputs]:
    """Process one block of IF-rate complex baseband (I/Q at
    ``cfg.if_fs``, [..., if_per_block] float32), e.g. one channel of a
    channelizer: ``receiver_step`` from the FM demod on, with the RF LPF
    left to whoever made the IF stream.  Keywords as ``receiver_step``.

    An ``iqcorr`` tracker in the state estimates from (and corrects) the
    IF stream itself, in torch before B6, as dy4tpu's does: right for a
    direct IF capture (a wideband tuner's imbalance is corrected before
    the channel bank instead).
    """
    _check_step(state, cdr_timing)
    rds_enabled = _rds_on(cfg, with_rds) and state.rds is not None
    new_iqcorr = None
    if state.iqcorr is not None:
        corr = iqcorr.coeffs(state.iqcorr)
        new_iqcorr = iqcorr.estimate(i_if, q_if, state.iqcorr)
        i_if, q_if = iqcorr.apply(i_if, q_if, corr)
    fstate, fo = front_step_if(params, front_state_of(state), i_if, q_if,
                               cfg, rds_enabled=rds_enabled,
                               frontend=frontend)
    return _finish_step(params, state, fstate, fo, cfg, rds_enabled,
                        backend, pll_impl, cdr_timing, pll_span, new_iqcorr,
                        pll_span_emit)


def _check_step(state: ReceiverState, cdr_timing: str) -> None:
    if cdr_timing not in _CDR_TIMINGS:
        raise ValueError(f"unknown cdr_timing {cdr_timing!r}; expected one "
                         f"of {_CDR_TIMINGS}")


def _finish_step(params: ReceiverParams, state: ReceiverState,
                 fstate: FrontState, fo: FrontOut, cfg: ModeConfig,
                 rds_enabled: bool, backend: str, pll_impl: str,
                 cdr_timing: str, pll_span: int = 1,
                 new_iqcorr: Optional[iqcorr.IQCorrState] = None,
                 pll_span_emit: str = "torch"
                 ) -> tuple[ReceiverState, StepOutputs]:
    # ---- stereo + RDS PLLs (project.cpp:118-133; fmMonoBlock.py:683) ----
    if rds_enabled:
        # the pilot (19 kHz, x2, bw .01) and RDS carrier (114 kHz, x0.5,
        # bw .001) loops stacked on a lane axis: ONE scan
        rds = state.rds
        both_in = torch.stack([fo.pilot, fo.carrier], dim=-2)  # [..., 2, N]
        both_state = pll.PLLState(*(torch.stack([a, b], dim=-1) for a, b
                                    in zip(state.audio.pll, rds.pll)))
        nco_i2, nco_q2, both_pll = pll.pll(
            both_in, both_state,
            freq=np.array([cfg.pll_freq, cfg.rds_pll_freq], np.float32),
            fs=cfg.if_fs,
            nco_scale=np.array([cfg.pll_nco_scale, cfg.rds_pll_nco_scale],
                               np.float32),
            norm_bandwidth=np.array([cfg.pll_bandwidth,
                                     cfg.rds_pll_bandwidth], np.float32),
            impl=pll_impl, span=pll_span, span_emit=pll_span_emit)
        nco = nco_i2[..., 0, :]
        nco_i = nco_i2[..., 1, :]
        nco_q = nco_q2[..., 1, :]
        pll_state = pll.PLLState(*(a[..., 0] for a in both_pll))
        rds_pll = pll.PLLState(*(a[..., 1] for a in both_pll))
    else:
        nco_i = nco_q = None
        nco, _, pll_state = pll.pll(
            fo.pilot.contiguous(), state.audio.pll, freq=cfg.pll_freq,
            fs=cfg.if_fs, nco_scale=cfg.pll_nco_scale,
            norm_bandwidth=cfg.pll_bandwidth, impl=pll_impl, span=pll_span,
            span_emit=pll_span_emit)

    # pilot-lock SNR estimate: E[pilot^2 * nco] = (A^2/4) cos(2 phase_err)
    # while the in-band noise is uncorrelated with the NCO
    p2 = torch.mean(fo.pilot * fo.pilot, dim=-1)
    c2 = torch.mean(fo.pilot * fo.pilot * nco, dim=-1)
    sig = torch.clamp(2.0 * c2, min=0.0)            # = A^2/2
    noise = torch.clamp(p2 - sig, min=1e-12)
    pilot_snr_db = 10.0 * torch.log10(torch.clamp(sig, min=1e-12) / noise)

    bstate, bo = back_step(params, back_state_of(state), fo, nco, nco_i,
                           nco_q, cfg, rds_enabled=rds_enabled,
                           backend=backend)

    new_audio = AudioState(mono_delay=fstate.mono_delay,
                           mono_tail=bstate.mono_tail,
                           bank_tail=fstate.bank_tail,
                           stereo_tail=bstate.stereo_tail, pll=pll_state)

    # ---- RDS clock/data recovery ----
    new_rds = None
    rds_out = (None,) * 6
    if rds_enabled:
        sym_i, _, symbols, resync, cdr = _cdr(bo.bb_i, bo.bb_q, rds.cdr,
                                              cfg.rds_sps, cdr_timing)
        new_rds = RDSState(carrier_tail=fstate.carrier_tail,
                           delay=fstate.rds_delay,
                           lpf_tail_i=bstate.lpf_tail_i,
                           lpf_tail_q=bstate.lpf_tail_q,
                           rrc_tail_i=bstate.rrc_tail_i,
                           rrc_tail_q=bstate.rrc_tail_q,
                           pll=rds_pll, cdr=cdr)
        rds_out = (bo.bb_i, bo.bb_q, symbols, sym_i, resync, cdr.offset)

    outputs = StepOutputs(mono=bo.mono, left=bo.left, right=bo.right,
                          rds_bb_i=rds_out[0], rds_bb_q=rds_out[1],
                          rds_symbols=rds_out[2], rds_sym_i=rds_out[3],
                          rds_resync=rds_out[4], rds_offset=rds_out[5],
                          pilot_snr_db=pilot_snr_db)
    return (ReceiverState(rf=fstate.rf, audio=new_audio, rds=new_rds,
                          iqcorr=new_iqcorr), outputs)


def receiver_step_pcm(params: ReceiverParams, state: ReceiverState,
                      iq_u8: Tensor, cfg: ModeConfig, stereo: bool = True,
                      with_rds: Optional[bool] = None,
                      cdr_timing: str = "peak", pll_span: int = 1):
    """One step returning quantised s16 PCM like the reference CLI
    (project.cpp:307-317): the counterpart of dy4tpu's
    ``receiver_step_jit``.  Returns ``(state', pcm, outputs)``."""
    new_state, out = receiver_step(params, state, iq_u8, cfg,
                                   with_rds=with_rds, cdr_timing=cdr_timing,
                                   pll_span=pll_span)
    if stereo:
        pcm = mix.quantize_s16(mix.interleave(out.left, out.right))
    else:
        pcm = mix.quantize_s16(out.mono)
    return new_state, pcm, out


def run_blocks(params: ReceiverParams, state: ReceiverState,
               iq_u8_blocks: Tensor, cfg: ModeConfig, pll_span: int = 1,
               pll_span_emit: str = "torch",
               **step_kwargs) -> tuple[ReceiverState, StepOutputs]:
    """Run the receiver over a [num_blocks, ..., block_size] stream.
    Returns the final state and every ``StepOutputs`` field stacked on a
    leading block axis (None fields stay None), as dy4tpu's
    ``lax.scan`` does.  ``pll_span``, ``pll_span_emit`` and
    ``step_kwargs`` (``frontend=`` among them) go to ``receiver_step``."""
    outs = []
    for blk in iq_u8_blocks:
        state, out = receiver_step(params, state, blk, cfg,
                                   pll_span=pll_span,
                                   pll_span_emit=pll_span_emit,
                                   **step_kwargs)
        outs.append(out)
    return state, StepOutputs(*(
        None if fields[0] is None else torch.stack(fields)
        for fields in zip(*outs)))

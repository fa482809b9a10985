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
    chip smoke's comparisons).

No environment variable picks the path, and a CUDA tensor never falls
back to the plain version silently.  Everything is float32 (dy4tpu's
``precision=HIGHEST``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dy4tpu.config import ModeConfig
from dy4tpu_torch.ops import (backend_cuda, demod, fir, firdes,
                              frontend_cuda, mix, pll, resample_cuda)

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
    iqcorr: None = None     # dy4tpu's opt-in IQ tracker: not ported yet


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
_IQCORR = ("the IQ tracker (ops/iqcorr.py) is not ported yet: ROADMAP "
           "Queue A item 9")


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


def front_step(params: ReceiverParams, fstate: FrontState, iq_u8: Tensor,
               cfg: ModeConfig, *, rds_enabled: bool = True,
               frontend: str = "auto") -> tuple[FrontState, FrontOut]:
    """RF front end + band bank + RDS carrier recovery filters: the LTI
    half of the receiver (project.cpp:72-93 + fmMonoBlock.py:673-680).

    ``frontend``: "auto" (``frontend_cuda.fused_frontend_full``: the
    kernel on a CUDA tensor, the plain version on a CPU one) or "plain"
    (normalize + FIR + demod, then ``_front_post_demod``, on any device).
    """
    if iq_u8.shape[-1] != cfg.block_size:
        raise ValueError(f"block of {iq_u8.shape[-1]} bytes; mode "
                         f"{cfg.mode} takes {cfg.block_size}")
    if frontend == "plain":
        fm, iq_tail, prev_i, prev_q = frontend_cuda.rf_demod_plain(
            iq_u8, params.rf_coeff, fstate.rf.iq_tail, fstate.rf.prev_i,
            fstate.rf.prev_q, cfg.rf_decim)
        new_rf = RFState(iq_tail=iq_tail, prev_i=prev_i, prev_q=prev_q)
        return _front_post_demod(params, fstate, fm, new_rf, rds_enabled)
    if frontend != "auto":
        raise ValueError(f"frontend must be one of {_IMPLS}, got "
                         f"{frontend!r}")
    batch = iq_u8.shape[:-1]
    flat, unflat = _flattener(batch)
    (fmd, pilot, stereo, carrier, rds_delayed, iq_tail, prev_i, prev_q,
     bank_tail, mono_delay, carrier_tail, rds_delay) = (
        frontend_cuda.fused_frontend_full(
            flat(iq_u8), params.rf_coeff, params.bank_coeff,
            params.rds_carrier_coeff, flat(fstate.rf.iq_tail),
            flat(fstate.rf.prev_i), flat(fstate.rf.prev_q),
            flat(fstate.bank_tail), flat(fstate.mono_delay),
            flat(fstate.carrier_tail), flat(fstate.rds_delay),
            cfg.rf_decim, rds=rds_enabled))
    return (FrontState(rf=RFState(iq_tail=unflat(iq_tail),
                                  prev_i=unflat(prev_i),
                                  prev_q=unflat(prev_q)),
                       mono_delay=unflat(mono_delay),
                       bank_tail=unflat(bank_tail),
                       carrier_tail=unflat(carrier_tail),
                       rds_delay=unflat(rds_delay)),
            FrontOut(fm_delayed=unflat(fmd), pilot=unflat(pilot),
                     stereo_band=unflat(stereo), carrier=unflat(carrier),
                     rds_delayed=unflat(rds_delayed)))


def _front_post_demod(params: ReceiverParams, fstate: FrontState,
                      fm: Tensor, new_rf: RFState, rds_enabled: bool
                      ) -> tuple[FrontState, FrontOut]:
    """Everything between the FM demod output and the PLLs (plain)."""
    (fm_delayed, pilot, stereo, carrier, rds_delayed, bank_tail,
     mono_delay, carrier_tail, rds_delay) = frontend_cuda.band_stages_plain(
        fm, params.bank_coeff, params.rds_carrier_coeff, fstate.bank_tail,
        fstate.mono_delay, fstate.carrier_tail, fstate.rds_delay,
        rds=rds_enabled)
    return (FrontState(rf=new_rf, mono_delay=mono_delay,
                       bank_tail=bank_tail, carrier_tail=carrier_tail,
                       rds_delay=rds_delay),
            FrontOut(fm_delayed=fm_delayed, pilot=pilot,
                     stereo_band=stereo, carrier=carrier,
                     rds_delayed=rds_delayed))


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
    on a CUDA tensor, the plain version on a CPU one) or "plain" (demod,
    then ``_front_post_demod``, on any device).
    """
    if i_if.shape[-1] != cfg.if_per_block or q_if.shape != i_if.shape:
        raise ValueError(f"IF blocks of {tuple(i_if.shape)} and "
                         f"{tuple(q_if.shape)}; mode {cfg.mode} takes "
                         f"[..., {cfg.if_per_block}] for both")
    if frontend == "plain":
        fm, prev_i, prev_q = demod.fm_demod_diff(i_if, q_if, fstate.rf.prev_i,
                                                 fstate.rf.prev_q)
        new_rf = RFState(iq_tail=fstate.rf.iq_tail, prev_i=prev_i,
                         prev_q=prev_q)
        return _front_post_demod(params, fstate, fm, new_rf, rds_enabled)
    if frontend != "auto":
        raise ValueError(f"frontend must be one of {_IMPLS}, got "
                         f"{frontend!r}")
    batch = i_if.shape[:-1]
    flat, unflat = _flattener(batch)
    (fmd, pilot, stereo, carrier, rds_delayed, prev_i, prev_q, bank_tail,
     mono_delay, carrier_tail, rds_delay) = frontend_cuda.fused_frontend_if(
        flat(i_if), flat(q_if), flat(fstate.rf.prev_i),
        flat(fstate.rf.prev_q), params.bank_coeff, params.rds_carrier_coeff,
        flat(fstate.bank_tail), flat(fstate.mono_delay),
        flat(fstate.carrier_tail), flat(fstate.rds_delay), rds=rds_enabled)
    return (FrontState(rf=RFState(iq_tail=fstate.rf.iq_tail,
                                  prev_i=unflat(prev_i),
                                  prev_q=unflat(prev_q)),
                       mono_delay=unflat(mono_delay),
                       bank_tail=unflat(bank_tail),
                       carrier_tail=unflat(carrier_tail),
                       rds_delay=unflat(rds_delay)),
            FrontOut(fm_delayed=unflat(fmd), pilot=unflat(pilot),
                     stereo_band=unflat(stereo), carrier=unflat(carrier),
                     rds_delayed=unflat(rds_delayed)))


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
                device="cpu") -> ReceiverParams:
    """Design all filters for a mode (host-side, run once) and put them
    on ``device``.  The audio LPF is the reference's Hann windowed sinc.
    ``with_rds=False`` omits the RDS filters (and must be matched by the
    same flag in ``init_state``)."""
    if_fs = cfg.if_fs
    t = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        a, device=device)
    rf = firdes.lpf(cfg.rf_fs, cfg.rf_fc, cfg.num_taps)
    audio = firdes.lpf(if_fs * cfg.audio_up, cfg.audio_fc, cfg.audio_taps,
                       up_factor=cfg.audio_up)
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
               with_iqcorr: bool = False, device="cpu") -> ReceiverState:
    if with_iqcorr:
        raise NotImplementedError(_IQCORR)
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
    return ReceiverState(rf=rf, audio=audio, rds=rds)


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
                  cdr_timing: str = "peak"
                  ) -> tuple[ReceiverState, StepOutputs]:
    """Process one block of interleaved u8 IQ samples.

    ``iq_u8``: [..., block_size] uint8 (I even, Q odd).  ``frontend`` /
    ``backend``: "auto" or "plain" (module docstring); ``pll_impl``:
    "auto", "kernel" or "plain" (``ops/pll.py``); ``cdr_timing``: "peak"
    or "envelope" (``_cdr``; dy4tpu's default when ``DY4TPU_CDR`` is
    unset is "peak", and the port reads no environment variable).
    """
    _check_step(state, cdr_timing)
    rds_enabled = _rds_on(cfg, with_rds) and state.rds is not None
    fstate, fo = front_step(params, front_state_of(state), iq_u8, cfg,
                            rds_enabled=rds_enabled, frontend=frontend)
    return _finish_step(params, state, fstate, fo, cfg, rds_enabled,
                        backend, pll_impl, cdr_timing)


def receiver_step_if(params: ReceiverParams, state: ReceiverState,
                     i_if: Tensor, q_if: Tensor, cfg: ModeConfig,
                     with_rds: Optional[bool] = None, frontend: str = "auto",
                     backend: str = "auto", pll_impl: str = "auto",
                     cdr_timing: str = "peak"
                     ) -> tuple[ReceiverState, StepOutputs]:
    """Process one block of IF-rate complex baseband (I/Q at
    ``cfg.if_fs``, [..., if_per_block] float32), e.g. one channel of a
    channelizer: ``receiver_step`` from the FM demod on, with the RF LPF
    left to whoever made the IF stream.  Keywords as ``receiver_step``.
    """
    _check_step(state, cdr_timing)
    rds_enabled = _rds_on(cfg, with_rds) and state.rds is not None
    fstate, fo = front_step_if(params, front_state_of(state), i_if, q_if,
                               cfg, rds_enabled=rds_enabled,
                               frontend=frontend)
    return _finish_step(params, state, fstate, fo, cfg, rds_enabled,
                        backend, pll_impl, cdr_timing)


def _check_step(state: ReceiverState, cdr_timing: str) -> None:
    if state.iqcorr is not None:
        raise NotImplementedError(_IQCORR)
    if cdr_timing not in _CDR_TIMINGS:
        raise ValueError(f"unknown cdr_timing {cdr_timing!r}; expected one "
                         f"of {_CDR_TIMINGS}")


def _finish_step(params: ReceiverParams, state: ReceiverState,
                 fstate: FrontState, fo: FrontOut, cfg: ModeConfig,
                 rds_enabled: bool, backend: str, pll_impl: str,
                 cdr_timing: str) -> tuple[ReceiverState, StepOutputs]:
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
            impl=pll_impl)
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
            norm_bandwidth=cfg.pll_bandwidth, impl=pll_impl)

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
    return (ReceiverState(rf=fstate.rf, audio=new_audio, rds=new_rds),
            outputs)


def receiver_step_pcm(params: ReceiverParams, state: ReceiverState,
                      iq_u8: Tensor, cfg: ModeConfig, stereo: bool = True,
                      with_rds: Optional[bool] = None,
                      cdr_timing: str = "peak"):
    """One step returning quantised s16 PCM like the reference CLI
    (project.cpp:307-317): the counterpart of dy4tpu's
    ``receiver_step_jit``.  Returns ``(state', pcm, outputs)``."""
    new_state, out = receiver_step(params, state, iq_u8, cfg,
                                   with_rds=with_rds, cdr_timing=cdr_timing)
    if stereo:
        pcm = mix.quantize_s16(mix.interleave(out.left, out.right))
    else:
        pcm = mix.quantize_s16(out.mono)
    return new_state, pcm, out


def run_blocks(params: ReceiverParams, state: ReceiverState,
               iq_u8_blocks: Tensor, cfg: ModeConfig, **step_kwargs
               ) -> tuple[ReceiverState, StepOutputs]:
    """Run the receiver over a [num_blocks, ..., block_size] stream.
    Returns the final state and every ``StepOutputs`` field stacked on a
    leading block axis (None fields stay None), as dy4tpu's
    ``lax.scan`` does.  ``step_kwargs`` go to ``receiver_step``."""
    outs = []
    for blk in iq_u8_blocks:
        state, out = receiver_step(params, state, blk, cfg, **step_kwargs)
        outs.append(out)
    return state, StepOutputs(*(
        None if fields[0] is None else torch.stack(fields)
        for fields in zip(*outs)))

"""Wideband multi-station receiver: channelizer -> C parallel receivers.
The counterpart of ``dy4tpu/pipeline/wideband.py``.

One complex capture at ``fs_w = C * cfg.if_fs`` is split by the polyphase
DFT filter bank (``ops/channelizer.py``, kernel B7) into C critically-
sampled basebands at the IF rate, and the bank's channel axis lands on the
receiver's batch axis: every station then rides the same mono + stereo +
RDS chain from the FM demod on (``receiver.receiver_step_if``: B6, B2, B3
or B5, B4).  Optional per-channel AFC (``ops/afc.py``) and a wideband-
tuner IQ tracker (``ops/iqcorr.py``) ride the same state.

    wideband_step(params, chan, state, wb_u8, cfg) -> (state', outputs)

The NamedTuples mirror dy4tpu's field for field (``pipeline/convert.py``
carries a state between the packages).  ``channelizer`` picks the bank's
route as the receiver's ``frontend``/``backend`` pick theirs: "auto" (the
kernel for a CUDA tensor, the plain version for a CPU one) or "plain".
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dy4tpu.config import ModeConfig
from dy4tpu_torch.ops import afc as afc_ops
from dy4tpu_torch.ops import iqcorr as iqcorr_ops
from dy4tpu_torch.ops.channelizer import (ChannelizerParams,
                                          ChannelizerState,
                                          channelize_block_u8,
                                          init_channelizer_state,
                                          make_channelizer, rssi_dbfs)
from dy4tpu_torch.pipeline import receiver

Tensor = torch.Tensor


class WidebandState(NamedTuple):
    chan: ChannelizerState
    rx: receiver.ReceiverState
    afc: Optional[afc_ops.AFCState] = None   # per-channel carrier track
    iqcorr: Optional[iqcorr_ops.IQCorrState] = None  # wideband-tuner
    #                                 fault tracker (pre-bank corrector)


class WidebandOutputs(NamedTuple):
    rx: receiver.StepOutputs   # per-station audio/RDS, channel axis first
    rssi: Tensor               # [..., C] per-channel dBFS (squelch/scan)


def make_wideband(cfg: ModeConfig, channels: int, *,
                  taps_per_branch: int = 12,
                  device="cpu") -> ChannelizerParams:
    """Design the bank matched to a mode: spacing = output rate =
    ``cfg.if_fs`` (channel c sits on carrier ``+c * cfg.if_fs``)."""
    return make_channelizer(channels, cfg.if_fs,
                            taps_per_branch=taps_per_branch, device=device)


def wideband_init(cfg: ModeConfig, chan: ChannelizerParams,
                  batch: tuple[int, ...] = (),
                  with_rds: Optional[bool] = None, afc: bool = False,
                  iqcorr: bool = False) -> WidebandState:
    """State for ``wideband_step`` on the bank's device: the channelizer
    tail [*batch, K-1] and a receiver state over [*batch, C].  ``afc``
    adds the per-channel carrier-offset loop, ``iqcorr`` the wideband-
    tuner fault tracker (one per band)."""
    c = chan.channels
    dev = chan.h.device
    return WidebandState(
        chan=init_channelizer_state(chan, batch=batch),
        rx=receiver.init_state(cfg, batch=(*batch, c), with_rds=with_rds,
                               device=dev),
        afc=(afc_ops.init_afc_state(batch=(*batch, c), device=dev)
             if afc else None),
        iqcorr=(iqcorr_ops.init_iqcorr_state(batch, device=dev)
                if iqcorr else None))


def _map(fn, tree):
    """``fn`` over every tensor leaf of a NamedTuple tree; None stays."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    return fn(tree)


def wideband_step(params: receiver.ReceiverParams, chan: ChannelizerParams,
                  state: WidebandState, wb_u8: Tensor, cfg: ModeConfig, *,
                  with_rds: Optional[bool] = None, frontend: str = "auto",
                  backend: str = "auto", pll_impl: str = "auto",
                  channelizer: str = "auto", afc_alpha: float = 0.5
                  ) -> tuple[WidebandState, WidebandOutputs]:
    """One wideband block -> every station's audio + RDS outputs + RSSI.

    ``wb_u8``: [..., 2 * C * cfg.if_per_block] interleaved u8 IQ at
    ``fs_w = C * cfg.if_fs``.  ``out.rx`` holds the receiver's outputs
    with a channel axis (mono/left/right [..., C, audio_per_block], RDS
    streams [..., C, ...]); ``out.rssi`` [..., C] is the per-channel
    signal strength.  ``frontend``/``backend``/``pll_impl`` go to
    ``receiver_step_if``; ``channelizer`` to ``channelize_block_u8``.
    """
    c = chan.channels
    n_w = c * cfg.if_per_block
    if wb_u8.shape[-1] != 2 * n_w:
        raise ValueError(f"wideband block of {wb_u8.shape[-1]} bytes; "
                         f"{c} channels at mode {cfg.mode} take {2 * n_w}")
    # tuner-fault correction: coefficients from the moments accumulated
    # before this block, folded into the bank's DFT (or applied after it
    # on the plain route); the fault lives at the tuner, ahead of AFC
    corr = (iqcorr_ops.coeffs_gaussian(state.iqcorr)
            if state.iqcorr is not None else None)
    (y_i, y_q), chan_state = channelize_block_u8(
        chan, state.chan, wb_u8, impl=channelizer, corr=corr)
    new_iqcorr = None
    if state.iqcorr is not None:
        new_iqcorr = iqcorr_ops.fold(
            state.iqcorr, iqcorr_ops.wideband_moments(wb_u8))

    # per-channel AFC de-rotation; the loop closes on the mono output
    phase_next = None
    if state.afc is not None:
        y_i, y_q, phase_next = afc_ops.rotate(y_i, y_q, state.afc)

    # the receivers run on one flat [prod(batch)*C] axis
    lead = y_i.shape[:-2]
    nb = len(lead)
    fl = lambda a: a.reshape(-1, *a.shape[nb + 1:])  # noqa: E731
    unfl = lambda a: a.reshape(*lead, c, *a.shape[1:])  # noqa: E731
    rx_state, out = receiver.receiver_step_if(
        params, _map(fl, state.rx), fl(y_i), fl(y_q), cfg,
        with_rds=with_rds, frontend=frontend, backend=backend,
        pll_impl=pll_impl)
    rx_state = _map(unfl, rx_state)
    out = _map(unfl, out)

    new_afc = None
    if state.afc is not None:
        # mean(mono) is the residual offset in rad/IF-sample; clamp the
        # estimate to half the channel half-width
        dc = torch.mean(out.mono, dim=-1)
        new_afc = afc_ops.update(state.afc, phase_next, dc,
                                 alpha=afc_alpha,
                                 max_freq=cfg.if_fs / 4.0, fs=cfg.if_fs)
    return (WidebandState(chan=chan_state, rx=rx_state, afc=new_afc,
                          iqcorr=new_iqcorr),
            WidebandOutputs(rx=out, rssi=rssi_dbfs(y_i, y_q)))


def run_wideband_blocks(params, chan: ChannelizerParams,
                        state: WidebandState, wb_blocks: Tensor,
                        cfg: ModeConfig, **step_kwargs
                        ) -> tuple[WidebandState, WidebandOutputs]:
    """Run ``wideband_step`` over [num_blocks, ..., 2*C*if_per_block].
    Returns the final state and every output field stacked on a leading
    block axis (None fields stay None), as dy4tpu's ``lax.scan`` does."""
    outs = []
    for blk in wb_blocks:
        state, out = wideband_step(params, chan, state, blk, cfg,
                                   **step_kwargs)
        outs.append(out)
    rx_out = receiver.StepOutputs(*(
        None if fields[0] is None else torch.stack(fields)
        for fields in zip(*(o.rx for o in outs))))
    return state, WidebandOutputs(
        rx=rx_out, rssi=torch.stack([o.rssi for o in outs]))

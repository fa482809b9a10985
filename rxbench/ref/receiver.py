"""The plain reference of the FM receiver: the COE3DY4 block chain written
out in float64 numpy, one stream per row, from a configuration file of
``rxbench/configs`` alone.

It imports nothing of the program and takes none of its tables: it
designs its own taps (``rxbench.firdes``) and carries its own state.  Per
block of interleaved u8 I/Q (``src/project.cpp``, ``model/fmMonoBlock.py``):

1. RF front end: (u8 - 128) / 128, the 100 kHz low-pass on I and Q,
   keeping every ``rf_decim``-th output, then the differentiating FM
   demod (``src/filter.cpp:85-102``, 0/0 -> 0);
2. the band bank on fm (pilot, stereo and RDS band-passes), the mono
   delay line, and for RDS the squared RDS band through the carrier
   band-pass and the RDS delay line;
3. the pilot PLL and the RDS carrier PLL (``src/filter.cpp:174-228``):
   the detector ``atan2(-x sin(phi), x cos(phi))`` is ``wrap(pi*[x < 0] -
   phi)``, so the loop reads the sign of its input; the NCO lags the
   input by one sample (a block's first NCO sample is the carried one);
   the accumulators wrap modulo 4 pi, exact for NCO scales 2 and 1/2;
4. audio: ``2 * nco * stereo band``, the polyphase audio low-pass (up U,
   down D) on the mono and stereo legs, L = M + S, R = M - S;
5. RDS: the RDS band mixed with the carrier NCO's cos and sin, the
   polyphase 3 kHz low-pass, the root-raised-cosine matched filter;
6. clock and data recovery ("peak": while unlocked the sampling phase is
   the first strongest |I| sample of the first two symbols, then every
   ``sps``-th sample; the lock is lost when the block's last two symbols
   both fall under 0.05).

Every FIR carries the last inputs it read as its state, so a block
stream is one long stream.  The state is a dict of arrays keyed like the
program's state fields (``"rf.iq_tail"``, ``"audio.pll.phase_est"``, ...),
so a run may start from the program's state at a chunk boundary.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from rxbench import firdes

_CP, _CI = 2.666, 3.555
_WRAP = 4.0 * math.pi
_TWO_PI = 2.0 * math.pi


def _ratio(target: float, source: float) -> tuple[int, int]:
    t, s = int(round(target)), int(round(source))
    g = math.gcd(t, s)
    return t // g, s // g


@dataclass(frozen=True)
class Geometry:
    """A configuration's sample counts a block, from its file."""
    rf_decim: int
    iq: int                  # complex RF samples a block
    n_if: int                # IF samples a block
    audio_up: int
    audio_down: int
    n_audio: int
    rds: bool
    rds_up: int = 1
    rds_down: int = 1
    n_rds: int = 0
    sps: int = 1
    n_sym: int = 0

    @classmethod
    def of(cls, cfg: dict) -> "Geometry":
        decim = int(cfg["rf_decim"])
        iq = int(cfg["block_iq_samples"])
        if_fs = cfg["rf_fs"] / decim
        n_if = iq // decim
        up, down = _ratio(cfg["audio_fs"], if_fs)
        rds = bool(cfg["rds"])
        kw = {}
        if rds:
            sps = int(cfg["rds_sps"])
            r_up, r_down = _ratio(sps * cfg["rds_symbol_rate"], if_fs)
            n_rds = n_if * r_up // r_down
            kw = dict(rds_up=r_up, rds_down=r_down, n_rds=n_rds, sps=sps,
                      n_sym=n_rds // sps)
        geo = cls(rf_decim=decim, iq=iq, n_if=n_if, audio_up=up,
                  audio_down=down, n_audio=n_if * up // down, rds=rds, **kw)
        if (iq % decim or (n_if * up) % down
                or rds and ((n_if * geo.rds_up) % geo.rds_down
                            or geo.n_rds % geo.sps)):
            raise ValueError(f"block of {iq} samples gives no whole "
                             f"outputs at every stage: {geo}")
        return geo


class Receiver:
    """The reference receiver of one configuration (a dict read from its
    file).  ``step(state, iq_u8)`` runs one block of every row."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.geo = g = Geometry.of(cfg)
        k = int(cfg["num_taps"])
        self.k = k
        if_fs = cfg["rf_fs"] / g.rf_decim
        f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
        self.h_rf = f64(firdes.lpf(cfg["rf_fs"], cfg["rf_fc"], k))
        self.h_audio = f64(firdes.lpf(if_fs * g.audio_up, cfg["audio_fc"],
                                      k * g.audio_up, g.audio_up))
        bands = [(cfg["pilot_fb"], cfg["pilot_fe"]),
                 (cfg["stereo_fb"], cfg["stereo_fe"])]
        if g.rds:
            bands.append((cfg["rds_fb"], cfg["rds_fe"]))
            self.h_carrier = f64(firdes.bpf(if_fs, cfg["rds_carrier_fb"],
                                            cfg["rds_carrier_fe"], k))
            self.h_rds_lpf = f64(firdes.lpf(if_fs * g.rds_up, cfg["rds_fc"],
                                            k * g.rds_up, g.rds_up))
            self.h_rrc = f64(firdes.rrc(g.sps * cfg["rds_symbol_rate"], k,
                                        cfg["rds_symbol_rate"]))
        self.h_bank = [f64(firdes.bpf(if_fs, fb, fe, k)) for fb, fe in bands]
        lanes = [(cfg["pll_freq"], cfg["pll_nco_scale"], cfg["pll_bandwidth"])]
        if g.rds:
            lanes.append((cfg["rds_pll_freq"], cfg["rds_pll_nco_scale"],
                          cfg["rds_pll_bandwidth"]))
        freq, scale, bw = (np.array(v, np.float64) for v in zip(*lanes))
        self.kp = bw * _CP
        self.ki = bw * bw * _CI
        self.dtheta = _TWO_PI * freq / if_fs
        self.scale = scale
        self.lost_below = float(cfg["cdr_lost_below"])
        self.audio_tail = (k * g.audio_up - 1) // g.audio_up
        self.rds_tail = (k * g.rds_up - 1) // g.rds_up if g.rds else 0

    # ---- state ----
    def init_state(self, rows: int) -> dict:
        """The program's initial state: zero histories, PLL feedback and
        NCO at 1 (the reference model's ``ncoState`` and its ``q_ncoState =
        1.0``), the CDR unlocked."""
        k, z = self.k, lambda *s: np.zeros((rows, *s))  # noqa: E731
        st = {"rf.iq_tail": z(2, k - 1), "rf.prev_i": z(), "rf.prev_q": z(),
              "audio.mono_delay": z(k // 2), "audio.bank_tail": z(k - 1),
              "audio.mono_tail": z(self.audio_tail),
              "audio.stereo_tail": z(self.audio_tail)}
        loops = ["audio.pll"] + (["rds.pll"] if self.geo.rds else [])
        for loop in loops:
            st.update({f"{loop}.integrator": z(), f"{loop}.phase_est": z(),
                       f"{loop}.angle": z(), f"{loop}.nco": z() + 1.0,
                       f"{loop}.nco_q": z() + 1.0})
        if self.geo.rds:
            st.update({"rds.carrier_tail": z(k - 1), "rds.delay": z(k // 2),
                       "rds.lpf_tail_i": z(self.rds_tail),
                       "rds.lpf_tail_q": z(self.rds_tail),
                       "rds.rrc_tail_i": z(k - 1), "rds.rrc_tail_q": z(k - 1),
                       "rds.cdr.offset": np.zeros(rows, np.int64),
                       "rds.cdr.found": np.zeros(rows, bool)})
        return st

    # ---- one block ----
    def step(self, st: dict, iq_u8: np.ndarray) -> tuple[dict, dict]:
        """One block of every row: ``iq_u8`` [rows, 2 * iq] u8.  Returns
        the new state and ``{"mono", "left", "right"}`` [rows, n_audio],
        with RDS also ``"sym_i"`` (soft symbols), ``"symbols"`` (hard,
        int8), ``"resync"``, ``"offset"`` and the CDR's input ``"bb_i"``."""
        g, k = self.geo, self.k
        new = {}
        x = (iq_u8.astype(np.float64) - 128.0) / 128.0
        iq = np.stack([x[:, 0::2], x[:, 1::2]], axis=1)         # [R, 2, n]
        ds, new["rf.iq_tail"] = _fir(iq, self.h_rf, st["rf.iq_tail"],
                                     down=g.rf_decim)
        i, q = ds[:, 0], ds[:, 1]
        i_prev = np.concatenate([st["rf.prev_i"][:, None], i[:, :-1]], 1)
        q_prev = np.concatenate([st["rf.prev_q"][:, None], q[:, :-1]], 1)
        power = i * i + q * q
        num = i * (q - q_prev) - q * (i - i_prev)
        fm = np.where(power == 0, 0.0, num / np.where(power == 0, 1.0, power))
        new["rf.prev_i"], new["rf.prev_q"] = i[:, -1], q[:, -1]

        fm_del, new["audio.mono_delay"] = _delay(fm, st["audio.mono_delay"])
        bands = [_fir(fm, h, st["audio.bank_tail"])[0] for h in self.h_bank]
        new["audio.bank_tail"] = fm[:, fm.shape[1] - (k - 1):]
        pll_in = [bands[0]]
        if g.rds:
            squared = bands[2] * bands[2]
            carrier, new["rds.carrier_tail"] = _fir(
                squared, self.h_carrier, st["rds.carrier_tail"])
            rds_del, new["rds.delay"] = _delay(bands[2], st["rds.delay"])
            pll_in.append(carrier)

        loops = ["audio.pll"] + (["rds.pll"] if g.rds else [])
        nco_i, nco_q = self._pll(np.stack(pll_in, 1), st, new, loops)

        legs = np.stack([fm_del, 2.0 * nco_i[:, 0] * bands[1]], 1)
        tails = np.stack([st["audio.mono_tail"], st["audio.stereo_tail"]], 1)
        audio, tails = _fir(legs, self.h_audio, tails, up=g.audio_up,
                            down=g.audio_down)
        new["audio.mono_tail"] = tails[:, 0]
        new["audio.stereo_tail"] = tails[:, 1]
        mono, stereo = audio[:, 0], audio[:, 1]
        out = {"mono": mono, "left": mono + stereo, "right": mono - stereo}
        if g.rds:
            mixed = np.stack([nco_i[:, 1] * rds_del, nco_q[:, 1] * rds_del], 1)
            tails = np.stack([st["rds.lpf_tail_i"], st["rds.lpf_tail_q"]], 1)
            lp, tails = _fir(mixed, self.h_rds_lpf, tails, up=g.rds_up,
                             down=g.rds_down)
            new["rds.lpf_tail_i"] = tails[:, 0]
            new["rds.lpf_tail_q"] = tails[:, 1]
            tails = np.stack([st["rds.rrc_tail_i"], st["rds.rrc_tail_q"]], 1)
            bb, tails = _fir(lp, self.h_rrc, tails)
            new["rds.rrc_tail_i"] = tails[:, 0]
            new["rds.rrc_tail_q"] = tails[:, 1]
            out.update(self.cdr(bb[:, 0], st, new))
        return new, out

    def _pll(self, x: np.ndarray, st: dict, new: dict, loops: list[str]):
        """The loops over ``x`` [R, L, n] (lane l is loop ``loops[l]``):
        returns the NCO's cos and sin [R, L, n] and writes each loop's
        carry into ``new``."""
        def field(name):
            return np.stack([st[f"{lp}.{name}"] for lp in loops], 1)

        integ = field("integrator")
        pe, angle = field("phase_est"), field("angle")
        # the detector's target pi*[x < 0], the wrap's +pi folded in
        target = np.where(x < 0, math.pi, 0.0) + math.pi
        live = (x != 0).astype(np.float64)          # the zero-input guard
        target = np.ascontiguousarray(np.moveaxis(target, -1, 0))
        live = np.ascontiguousarray(np.moveaxis(live, -1, 0))
        kp, ki, dth = self.kp, self.ki, self.dtheta
        n = x.shape[-1]
        phis = np.empty((n, *x.shape[:-1]))
        err = np.empty_like(pe)
        for t in range(n):
            phi = angle + pe
            phis[t] = phi
            np.subtract(target[t], phi, out=err)
            np.remainder(err, _TWO_PI, out=err)
            err -= math.pi
            err *= live[t]
            integ = integ + ki * err
            pe = np.remainder(pe + kp * err + integ, _WRAP)
            angle = np.remainder(angle + dth, _WRAP)
        arg = np.moveaxis(phis, 0, -1) * self.scale[:, None]
        cos, sin = np.cos(arg), np.sin(arg)
        cos[..., 0], sin[..., 0] = field("nco"), field("nco_q")
        end = (angle + pe) * self.scale
        for lane, lp in enumerate(loops):
            new[f"{lp}.integrator"] = integ[:, lane]
            new[f"{lp}.phase_est"] = pe[:, lane]
            new[f"{lp}.angle"] = angle[:, lane]
            new[f"{lp}.nco"] = np.cos(end[:, lane])
            new[f"{lp}.nco_q"] = np.sin(end[:, lane])
        return cos, sin

    def cdr(self, bb_i: np.ndarray, st: dict, new: dict) -> dict:
        """The CDR over one block's RRC output ``bb_i`` [rows, n_rds]
        from the carry in ``st`` (``rds.cdr.offset``, ``rds.cdr.found``),
        its carry written into ``new``: its outputs, with ``bb_i``.  It
        feeds nothing back into the chain."""
        sps = self.geo.sps
        cand = np.argmax(np.abs(bb_i[:, :2 * sps]), axis=1) % sps
        resync = ~st["rds.cdr.found"]
        offset = np.where(resync, cand, st["rds.cdr.offset"])
        out = self.sample(bb_i, offset)
        new["rds.cdr.offset"], new["rds.cdr.found"] = offset, out.pop("found")
        return {**out, "resync": resync, "offset": offset, "bb_i": bb_i}

    def sample(self, bb_i: np.ndarray, offset: np.ndarray) -> dict:
        """The CDR's symbols at sampling phase ``offset`` [rows]: soft
        ``sym_i``, hard ``symbols`` and the lock it keeps (``found``)."""
        sps, m = self.geo.sps, self.geo.n_sym
        sym_i = np.take_along_axis(bb_i, offset[:, None] + sps * np.arange(m),
                                   axis=1)
        lost = ((np.abs(sym_i[:, -1]) < self.lost_below)
                & (np.abs(sym_i[:, -2]) < self.lost_below))
        return {"sym_i": sym_i, "symbols": (sym_i >= 0).astype(np.int8),
                "found": ~lost}


def _delay(x: np.ndarray, state: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    d = state.shape[-1]
    return (np.concatenate([state, x[..., :x.shape[-1] - d]], -1),
            x[..., x.shape[-1] - d:])


def _fir(x: np.ndarray, h: np.ndarray, state: np.ndarray, *, up: int = 1,
         down: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Stateful polyphase FIR over the last axis: upsample ``x`` by ``up``,
    filter with ``h``, keep every ``down``-th output from the first:
    ``y[m] = sum_i h[m*down - i*up] x[i]``, where x[i < 0] is the carried
    state (its last ``len(state)`` inputs).  Returns ``(y, new_state)``."""
    s = state.shape[-1]
    n = x.shape[-1]
    ext = np.concatenate([state, x], -1)
    m = n * up // down
    pos = np.arange(m) * down
    base, phase = pos // up, pos % up
    hp = np.concatenate([h, np.zeros(up)])
    taps = -(-len(h) // up)
    y = np.zeros((*x.shape[:-1], m))
    if up == 1:
        for j in range(taps):
            y += h[j] * ext[..., s + base[0] - j: s + base[-1] - j + 1: down]
    else:
        for j in range(taps):
            tap = hp[np.minimum(phase + j * up, len(h))]
            y += tap * ext[..., s + base - j]
    return y, ext[..., ext.shape[-1] - s:]

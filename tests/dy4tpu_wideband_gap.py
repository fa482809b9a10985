"""Where the port's wideband step parts from dy4tpu's, channel by channel,
beside dy4tpu's own jitted step parted from its un-jitted one.

Runs on the CPU, at tests/test_torch_graph_wideband_dy4tpu.py's size and
configuration (mode 0, C=4 x 2 bands x T=12, 5 steps, AFC and the IQ
tracker on), over both of its captures: a station on every channel with
RDS on channel 1, and channel 1's station alone among channels of noise.
For each output field and channel it prints the largest |difference| of
the port's graphed run (``graph.run_wideband_blocks``, chunk 2) and of
dy4tpu's jitted step loop, each against dy4tpu's un-jitted step loop,
and where the port's largest one lies.  A gap the port shares with
dy4tpu's own two compilations is float32 rounding of that input, not a
fault of the port.

    JAX_PLATFORMS=cpu python tests/dy4tpu_wideband_gap.py
"""

import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dy4tpu.config import get_mode as jget_mode  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.pipeline import wideband as jwb  # noqa: E402
from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.pipeline import convert, graph  # noqa: E402
from dy4tpu_torch.pipeline import wideband as wb  # noqa: E402
from test_torch_graph_wideband import (BANDS, C, T,  # noqa: E402
                                       wideband_blocks)

FIELDS = ("mono", "rds_bb_i", "rds_bb_q", "pilot_snr_db", "rds_symbols")


def _dy4tpu(blocks, jit: bool) -> dict:
    cfg = jget_mode(0)
    jp = jrx.make_params(cfg)
    jc = jwb.make_wideband(cfg, C, taps_per_branch=T)

    def step(s, b):
        return jwb.wideband_step(jp, jc, s, b, cfg)

    fn = jax.jit(step) if jit else step
    js = jwb.wideband_init(cfg, jc, batch=(BANDS,), afc=True, iqcorr=True)
    outs = []
    for blk in blocks:
        js, jo = fn(js, jnp.asarray(blk))
        outs.append(jo)
    return dict(jp=jp, jc=jc, **{f: np.stack(
        [np.asarray(getattr(o.rx, f)) for o in outs]) for f in FIELDS})


def _port(blocks, jp, jc) -> dict:
    cfg = get_mode(0)
    params = convert.params_from_numpy(jp, device="cpu")
    chan = convert.chan_params_from_numpy(jc, device="cpu")
    state = wb.wideband_init(cfg, chan, (BANDS,), afc=True, iqcorr=True)
    _, outs = graph.run_wideband_blocks(params, chan, state,
                                        torch.from_numpy(blocks), cfg,
                                        chunk=2)
    return {f: getattr(outs.rx, f).numpy() for f in FIELDS}


def main() -> int:
    torch.set_num_threads(2)
    for empty in (False, True):
        blocks = wideband_blocks(0, empty=empty).numpy()
        plain = _dy4tpu(blocks, jit=False)
        jitted = _dy4tpu(blocks, jit=True)
        port = _port(blocks, plain["jp"], plain["jc"])
        print("capture:", "channel 1's station alone, the others noise"
              if empty else "a station on every channel, RDS on channel 1")
        print(f"{'field':13s} ch  port-unjitted  jitted-unjitted  "
              "port's largest at [step, band, sample]")
        for f in FIELDS:
            for c in range(C):
                ref = plain[f][:, :, c].astype(np.float64)
                ours = np.abs(port[f][:, :, c] - ref)
                theirs = np.abs(jitted[f][:, :, c] - ref)
                at = np.unravel_index(ours.argmax(), ours.shape)
                print(f"{f:13s} {c:2d}  {ours.max():13.3g}  "
                      f"{theirs.max():15.3g}  {list(map(int, at))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

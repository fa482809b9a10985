"""The plain reference against the port's plain CPU path at a tiny size:
4 stations (two I/Q-swapped), 3 blocks, modes 0 and 2.  Tolerances: the
port runs float32 and the reference float64; the mono leg sums float32
products of unit-scale samples (about 4e-7 of its peak), the stereo leg
and the soft symbols also carry the float32 PLL's phase (about 1e-5)."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rxbench import spec  # noqa: E402
from rxbench.gen import traffic  # noqa: E402
from rxbench.ref.receiver import Geometry, Receiver  # noqa: E402

TOL = {"mono": 1e-5, "left": 5e-5, "right": 5e-5, "sym_i": 5e-5}


@pytest.mark.parametrize("config", ["fm-mode0", "fm-mode2"])
def test_reference_agrees_with_the_port_plain_path(config):
    import torch

    from dy4tpu_torch.pipeline import receiver as rx
    from rxbench.harness import program_config

    cfg = spec.config(config)
    geo = Geometry.of(cfg)
    wl = dict(spec.workload("m0-c64-k8"), ring_blocks=3, chunk=3,
              stations=4, programs=2)
    t = traffic.draw(wl, geo, 2**31 + 7)
    ring = traffic.ring(traffic.synthesize(t, wl, cfg, geo), t, wl, geo,
                        torch.device("cpu"))[:3]               # [3, 4, bs]
    mcfg = program_config(cfg)
    params = rx.make_params(mcfg, device="cpu")
    state = rx.init_state(mcfg, (4,), device="cpu")
    _, outs = rx.run_blocks(params, state, ring, mcfg)

    ref = Receiver(cfg)
    st = ref.init_state(4)
    got = []
    for b in range(3):
        st, o = ref.step(st, ring[b].numpy())
        got.append(o)
    want = {k: np.stack([o[k] for o in got]) for k in got[0]}
    for field, port in (("mono", "mono"), ("left", "left"),
                        ("right", "right"), ("sym_i", "rds_sym_i")):
        a = getattr(outs, port).numpy()
        gap = np.max(np.abs(a - want[field])) / np.max(np.abs(want[field]))
        assert gap < TOL[field], (field, gap)
    for field, port in (("symbols", "rds_symbols"), ("resync", "rds_resync"),
                        ("offset", "rds_offset")):
        assert np.array_equal(getattr(outs, port).numpy(), want[field]), field


@pytest.mark.parametrize("config", ["fm-mode0", "fm-mode2"])
def test_reference_at_any_block_is_a_straight_run(config):
    """``check.reference`` (two passes of the chain, then the CDR alone)
    against the reference run block by block over four passes of a
    4-block loop of 8 stations."""
    from types import SimpleNamespace

    from rxbench import check

    cfg = spec.config(config)
    geo = Geometry.of(cfg)
    wl = dict(spec.workload("m0-c64-k8"), ring_blocks=4, chunk=1,
              stations=8, programs=4)
    t = traffic.draw(wl, geo, 2**31 + 11)
    import torch
    ring = traffic.ring(traffic.synthesize(t, wl, cfg, geo), t, wl, geo,
                        torch.device("cpu")).numpy()
    bench = SimpleNamespace(ring_blocks=4, rows=np.arange(8),
                            loop_inputs=lambda n: ring[np.arange(n) % 4])
    ref = Receiver(cfg)
    at, _ = check.reference(bench, ref)
    st = ref.init_state(8)
    for b in range(16):
        st, want = ref.step(st, ring[b % 4])
        got = at(b)
        for field in ("mono", "left", "right", "sym_i"):
            gap = np.max(np.abs(got[field] - want[field]))
            assert gap <= 1e-12 * np.max(np.abs(want[field])), (b, field)
        for field in ("symbols", "resync", "offset"):
            assert np.array_equal(got[field], want[field]), (b, field)

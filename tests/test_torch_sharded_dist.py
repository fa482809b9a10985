"""The port's sharded receiver over real process groups: four ranks on the
CPU joined by gloo, each driving its own shard, against the port's own
sequential ``run_blocks`` (mirroring tests/test_sharded.py, which runs
dy4tpu's on a virtual 8-device mesh), and ``wideband_dp`` against the
single-process ``run_wideband_blocks``.

One launch serves every case: this file, run as a script, is the rank
(``python tests/test_torch_sharded_dist.py RANK WORLD DIR BACKEND``).  The
ranks meet through a ``FileStore`` in a temporary directory (no TCP port to
collide on between parallel test workers), run every case of ``CASES`` on
the two meshes (ch=2, time=2) and (ch=1, time=4), and save their local
outputs; the test process assembles them per case and compares.  A rank
that fails or outlasts ``TIMEOUT`` fails every case.

The ranks also run ``matches_sequential_ch2_time2`` through the sharded
step's chunk runner (``graph.sharded_runner``), and ``wideband_dp`` runs
through the wideband chunk runner: under gloo each runs its eager body,
under NCCL it is captured as a CUDA graph with its collectives.  The same
cases run with NCCL on four cards (``-m cuda``, skipped without them; the
kernels then run on the ranks and in the references):

    python -m pytest --noconftest tests/test_torch_sharded_dist.py -m cuda

Bars: the exact discipline bitwise on every output field, every channel,
across the ``step`` boundary; the legacy one converging as
test_sharded.py's ``test_sharded_legacy_converges`` asserts.  Channel c
takes the broadcast from byte 74*c on, so every row differs.  The
sequential references run at the global batch: neither the plain
receiver's rows nor the kernels' depend on the batch (the wideband DFT's
cuBLAS matmul does; ``test_wideband_dp_matches_one_process``).
"""

import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # one per rank (``_rank``)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 600      # seconds for the whole launch
SHIFT = 74         # bytes between neighbouring channels
NOISE = 0.05       # per I/Q sample, as tx.fm.synthesize takes it
N_BLOCKS = 8       # blocks of each stream
C_MAX = 8          # channels of the mode-0 stream
WB = dict(channels=4, bands=4, steps=2)   # wideband_dp at ch=2

# name -> mesh (ch, time), mode, channels, shard_blocks, overlap_blocks
# (None: the auto sub-block halo), exact, steps
CASES = {
    "matches_sequential_ch2_time2": dict(mesh=(2, 2), mode=0, C=2, S=2,
                                         O=1, exact=True),
    "rds_symbols_time4": dict(mesh=(1, 4), mode=0, C=1, S=1, O=1,
                              exact=True),
    "channel_parallel_replay_c8_time4": dict(mesh=(1, 4), mode=0, C=8,
                                             S=1, O=1, exact=True),
    "nondivisible_channels_c6_time4": dict(mesh=(1, 4), mode=0, C=6, S=1,
                                           O=1, exact=True),
    "subblock_auto_halo_time4": dict(mesh=(1, 4), mode=0, C=1, S=1,
                                     O=None, exact=True),
    "legacy_converges_time4": dict(mesh=(1, 4), mode=0, C=2, S=1, O=1,
                                   exact=False),
    "mode1_no_rds_time4": dict(mesh=(1, 4), mode=1, C=2, S=2, O=1,
                               exact=True),
}

# cases also run through ``graph.sharded_runner`` on the ranks
RUNNER_CASES = ("matches_sequential_ch2_time2",)


def _streams(mode: int, channels: int) -> np.ndarray:
    """[channels, N_BLOCKS * block_size] u8: the bench broadcast with
    noise (so that no two stretches of the PLL's sign codes are alike; the
    clean pilot repeats every 240 kHz / 19 kHz x 12 samples), channel c
    from byte SHIFT*c on."""
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.tx import fm
    cfg = get_mode(mode)
    flat = fm.stereo_rds_broadcast(cfg, N_BLOCKS + 1, noise=NOISE,
                                   seed=mode).ravel()
    n = N_BLOCKS * cfg.block_size
    return np.stack([flat[SHIFT * c:SHIFT * c + n] for c in range(channels)])


def _wideband_capture() -> np.ndarray:
    """[steps, bands, 2*C*if_per_block] u8: one station on channel 1, band
    b starting SHIFT*b bytes in."""
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.tx import fm
    cfg = get_mode(0)
    steps, bands, c = WB["steps"], WB["bands"], WB["channels"]
    n_audio = (steps + 1) * cfg.audio_per_block
    cap = fm.synthesize_wideband(cfg, c, steps + 1, stations={1: dict(
        left=fm.tone(800.0, cfg.audio_fs, n_audio, amp=0.7),
        right=fm.tone(2400.0, cfg.audio_fs, n_audio, amp=0.7))})
    step = 2 * c * cfg.if_per_block
    return np.stack([cap[SHIFT * b:SHIFT * b + steps * step].reshape(
        steps, step) for b in range(bands)], axis=1)


# ---- the rank ----

def _run_case(case, mesh, iq, runner: bool = False):
    """This rank's outputs of every step, by the eager ``step`` loop or,
    with ``runner``, through ``graph.sharded_runner`` at K=1 (captured
    with its collectives on the card, its eager body under gloo)."""
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.parallel import ShardedReceiver
    from dy4tpu_torch.pipeline import graph
    from dy4tpu_torch.pipeline import receiver as rx
    cfg = get_mode(case["mode"])
    params = rx.make_params(cfg, device=mesh.device)
    r = ShardedReceiver(cfg, mesh, shard_blocks=case["S"],
                        overlap_blocks=case["O"], exact=case["exact"])
    iq = torch.from_numpy(iq[:case["C"]])
    carry = r.init(case["C"])
    pieces = [r.input_sharding(iq[:, k * r.chunk_len:(k + 1) * r.chunk_len])
              for k in range(iq.shape[1] // r.chunk_len)]
    outs = []
    if runner:
        run = graph.sharded_runner(r, params, carry)
        for piece in pieces:
            out = run.run(piece[None])
            outs.append({f: v[0].cpu() for f, v in out._asdict().items()
                         if v is not None})
    else:
        for piece in pieces:
            carry, out = r.step(params, carry, piece)
            outs.append({f: v.cpu() for f, v in out._asdict().items()
                         if v is not None})
    return dict(ch=mesh.ch_index, time=mesh.time_index, halo_if=r.halo_if,
                outs=outs)


def _run_wideband(mesh, blocks):
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.pipeline import wideband as wb
    cfg = get_mode(0)
    params = rx.make_params(cfg, device=mesh.device)
    chan = wb.make_wideband(cfg, WB["channels"], device=mesh.device)
    place, run = wb.wideband_dp(params, chan, cfg, mesh)
    state = place(wb.wideband_init(cfg, chan, (WB["bands"],)))
    _, out = run(state, place(torch.from_numpy(blocks), axis=1))
    return dict(ch=mesh.ch_index, rssi=out.rssi.cpu(),
                rx={f: None if v is None else v.cpu()
                    for f, v in out.rx._asdict().items()})


def _rank(rank: int, world: int, work: Path, backend: str) -> None:
    """One rank: gloo on the CPU, or NCCL with card ``rank``."""
    import torch.distributed as dist
    from dy4tpu_torch.parallel import make_mesh
    if backend == "nccl":
        torch.cuda.set_device(rank)
        devices = [torch.device("cuda", r) for r in range(world)]
    else:
        torch.set_num_threads(1)
        devices = ["cpu"] * world
    dist.init_process_group(
        backend, store=dist.FileStore(str(work / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT // 2))
    try:
        meshes = {(2, 2): make_mesh(2, 2, devices=devices),
                  (1, 4): make_mesh(1, 4, devices=devices)}
        data = np.load(work / "streams.npz")
        res = {name: _run_case(case, meshes[case["mesh"]],
                               data[f"mode{case['mode']}"])
               for name, case in CASES.items()}
        for name in RUNNER_CASES:
            case = CASES[name]
            res[f"runner_{name}"] = _run_case(
                case, meshes[case["mesh"]], data[f"mode{case['mode']}"],
                runner=True)
        res["wideband_dp_ch2"] = _run_wideband(meshes[(2, 2)], data["wb"])
        torch.save(res, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---- the test process ----

def _sequential(data, dev):
    """The port's sequential receiver over each mode's whole stream on
    ``dev``, {mode: StepOutputs stacked [N_BLOCKS, C, ...]}, and the
    single-process wideband run over all bands, back on the CPU."""
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.pipeline import receiver as rx
    from dy4tpu_torch.pipeline import wideband as wb
    cpu = lambda t: type(t)(*(None if v is None else v.cpu()  # noqa: E731
                              for v in t))
    seq = {}
    for mode in (0, 1):
        cfg = get_mode(mode)
        iq = data[f"mode{mode}"]
        blocks = torch.from_numpy(iq.reshape(len(iq), N_BLOCKS, -1)
                                  .transpose(1, 0, 2).copy()).to(dev)
        _, out = rx.run_blocks(
            rx.make_params(cfg, device=dev),
            rx.init_state(cfg, (len(iq),), device=dev), blocks, cfg)
        seq[mode] = cpu(out)
    cfg = get_mode(0)
    params = rx.make_params(cfg, device=dev)
    chan = wb.make_wideband(cfg, WB["channels"], device=dev)
    blocks = torch.from_numpy(data["wb"]).to(dev)
    per = WB["bands"] // 2
    for key, rows in (("wb", slice(None)),
                      *((f"wb{c}", slice(c * per, (c + 1) * per))
                        for c in range(2))):
        bands = blocks[:, rows].contiguous()
        _, out = wb.run_wideband_blocks(
            params, chan, wb.wideband_init(cfg, chan, (bands.shape[1],)),
            bands, cfg)
        seq[key] = wb.WidebandOutputs(rx=cpu(out.rx), rssi=out.rssi.cpu())
    return seq


@pytest.fixture(scope="module",
                params=["gloo", pytest.param("nccl", marks=pytest.mark.cuda)])
def launch(request, tmp_path_factory):
    """Run the four ranks once (gloo on the CPU, or NCCL on four cards),
    and the sequential references meanwhile (on the CPU, or on card 0
    through the kernels); returns (the ranks' results, the
    references)."""
    backend = request.param
    if backend == "nccl" and torch.cuda.device_count() < WORLD:
        pytest.skip(f"NCCL ranks need {WORLD} CUDA devices")
    work = tmp_path_factory.mktemp(f"sharded_{backend}")
    data = dict(mode0=_streams(0, C_MAX), mode1=_streams(1, 2),
                wb=_wideband_capture())
    np.savez(work / "streams.npz", **data)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD),
                               str(work), backend], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    logs = []
    try:
        seq = _sequential(data, "cpu" if backend == "gloo" else "cuda:0")
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks {bad} failed:\n" + "\n".join(
        f"--- rank {r}:\n{log[-3000:]}" for r, log in enumerate(logs))
    return ([torch.load(work / f"rank{r}.pt") for r in range(WORLD)], seq,
            backend)


def _assemble(results, case, field):
    """The global [C, ...] stream of ``field`` from every rank's per-step
    pieces, in channel and time order."""
    ch, t_shards = case["mesh"]
    steps = len(results[0]["outs"])
    per_step = []
    for k in range(steps):
        rows = []
        for c in range(ch):
            ranks = [results[c * t_shards + t] for t in range(t_shards)]
            assert [(r["ch"], r["time"]) for r in ranks] == [
                (c, t) for t in range(t_shards)]
            rows.append(torch.cat([r["outs"][k][field] for r in ranks], -1))
        per_step.append(torch.cat(rows, 0))
    return torch.cat(per_step, -1)


def _seq_stream(seq, field, c):
    """[N_BLOCKS, C, ...] sequential outputs -> [c, N_BLOCKS * n]."""
    x = getattr(seq, field)[:, :c]
    if x.dim() == 2:                               # per-block scalars
        return x.movedim(0, -1)
    return x.movedim(0, -2).reshape(c, -1)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_ranks_match_sequential(launch, name):
    _check_ranks(launch, name, name)


@pytest.mark.parametrize("name", RUNNER_CASES)
def test_sharded_runner_on_the_ranks_matches_sequential(launch, name):
    """The same case through ``graph.sharded_runner`` (K=1, dy4tpu's
    compiled ``step_c``): the sequential bars, and every step's outputs
    bitwise those of the eager ``step`` loop on every rank."""
    _check_ranks(launch, name, f"runner_{name}")
    for r in launch[0]:
        for got, want in zip(r[f"runner_{name}"]["outs"], r[name]["outs"],
                             strict=True):
            assert got.keys() == want.keys()
            for f in want:
                assert torch.equal(got[f], want[f]), f


def _check_ranks(launch, name, key):
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import mix
    results = [r[key] for r in launch[0]]
    case = CASES[name]
    cfg = get_mode(case["mode"])
    seq = launch[1][case["mode"]]
    c = case["C"]
    got = {f: _assemble(results, case, f) for f in results[0]["outs"][0]}
    if case["O"] is None:            # the sub-block halo: a quarter block
        assert {r["halo_if"] for r in results} == {cfg.if_per_block // 4}
    if not case["exact"]:
        # mono is LTI, exact up to rounding; stereo re-locks in the warm-up
        # and lands within 10% RMS of the sequential run after two blocks
        np.testing.assert_allclose(got["mono"].numpy(),
                                   _seq_stream(seq, "mono", c).numpy(),
                                   atol=2e-5)
        apb = cfg.audio_per_block
        a = got["left"][:, 2 * apb:].double()
        b = _seq_stream(seq, "left", c)[:, 2 * apb:].double()
        err = (a - b).pow(2).mean(-1).sqrt()
        assert bool((err < 0.1 * b.pow(2).mean(-1).sqrt()).all()), err
        return
    want = {f: _seq_stream(seq, f, c) for f in ("mono", "left", "right")}
    want["pcm"] = mix.quantize_s16(mix.interleave(want["left"],
                                                  want["right"]))
    rds = ("rds_symbols", "rds_resync", "rds_offset")
    if cfg.supports_rds:
        want.update({f: _seq_stream(seq, f, c) for f in rds})
    else:
        assert not set(rds) & set(got)
    assert got.keys() == want.keys()
    for f in want:
        assert got[f].shape == want[f].shape, f
        assert torch.equal(got[f], want[f]), (
            f, float((got[f].double() - want[f].double()).abs().max()))


def test_wideband_dp_matches_one_process(launch):
    """Each ch rank's bands (the ranks that share a ch index alike) equal
    one process running the same bands bit for bit; on the CPU they also
    equal the rows of one process running all bands.  On the card the
    DFT's float32 matmul picks its cuBLAS kernel by the number of rows, so
    batches of other sizes part in the last bits there."""
    results, seq, backend = launch
    per = WB["bands"] // 2
    for r in results:
        got = r["wideband_dp_ch2"]
        refs = [(seq[f"wb{got['ch']}"], slice(None))]
        if backend == "gloo":
            refs.append((seq["wb"], slice(got["ch"] * per,
                                          (got["ch"] + 1) * per)))
        for ref, rows in refs:
            assert torch.equal(got["rssi"], ref.rssi[:, rows])
            for f, v in got["rx"].items():
                want = getattr(ref.rx, f)
                if want is None:
                    assert v is None, f
                else:
                    assert torch.equal(v, want[:, rows]), f


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]),
          sys.argv[4])

"""The port's exact time-sharded receiver on one process
(dy4tpu_torch.parallel, plain paths on the CPU): the halo, the sign codes
and the coded PLL replay against dy4tpu's, the replay against the port's
own per-sample scan, the 1x1 ``ShardedReceiver`` against the port's
sequential ``run_blocks`` (bitwise) and dy4tpu's un-jitted receiver
(tests/test_torch_modes.py's bars), the guard on the halo length, a stream
handed from dy4tpu's ``ShardedReceiver`` to the port's mid-way, and the
multi-process helpers with a monkeypatched environment.  The multi-rank
runs are in tests/test_torch_sharded_dist.py.

Streams: the bench broadcast (800/2400 Hz, RDS 0A), channel c from byte
74*c on, so no two rows are equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.ops import pll as jpll  # noqa: E402
from dy4tpu.parallel import ShardedReceiver as JShardedReceiver  # noqa: E402
from dy4tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from dy4tpu.parallel import sharded as jsharded  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
import dy4tpu_torch  # noqa: E402
from dy4tpu_torch.ops import mix, pll, pll_cuda  # noqa: E402
from dy4tpu_torch.parallel import (ShardedReceiver, make_mesh,  # noqa: E402
                                   multihost, sharded)
from dy4tpu_torch.parallel.mesh import Mesh  # noqa: E402
from dy4tpu_torch.pipeline import convert  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402

SHIFT = 74
RNG = np.random.default_rng(0)
LANES = dict(freq=np.array([19e3, 114e3], np.float32), fs=240e3,
             norm_bandwidth=np.array([0.01, 0.001], np.float32))


def _streams(cfg, channels, n_blocks):
    """[channels, n_blocks * block_size] u8: the broadcast with noise (a
    clean pilot's sign codes repeat every 12 IF samples at mode 0, and
    would hide a replay that takes its codes from the wrong place),
    channel c from byte SHIFT*c on."""
    flat = fm.stereo_rds_broadcast(cfg, n_blocks + 1, noise=0.05,
                                   seed=cfg.mode).ravel()
    n = n_blocks * cfg.block_size
    return np.stack([flat[SHIFT * c:SHIFT * c + n] for c in range(channels)])


def _blocks(cfg, iq):
    """[C, B*bs] -> [B, C, bs] for ``run_blocks``."""
    return torch.from_numpy(iq.reshape(len(iq), -1, cfg.block_size)
                            .transpose(1, 0, 2).copy())


def _run_sharded(r, params, iq):
    """Every ``step`` over the [C, k*chunk_len] stream on a 1x1 mesh;
    returns each output field concatenated over the steps.  On the CPU the
    coded replay takes its plain version and counts no launch."""
    carry = r.init(len(iq))
    outs = []
    launches = pll_cuda.phase_scan_coded.launches
    for k in range(iq.shape[1] // r.chunk_len):
        carry, out = r.step(params, carry, r.input_sharding(
            iq[:, k * r.chunk_len:(k + 1) * r.chunk_len]))
        outs.append(out)
    assert pll_cuda.phase_scan_coded.launches == launches
    return {f: torch.cat([getattr(o, f) for o in outs], -1)
            for f in sharded.ShardedOutputs._fields
            if getattr(outs[0], f) is not None}


def _seq_fields(cfg, seq):
    """``run_blocks``'s [B, C, ...] outputs in ``ShardedOutputs``' layout:
    [C, B*n] streams, [C, B] per-block values, the interleaved PCM."""
    stream = lambda x: x.movedim(0, -2).reshape(x.shape[1], -1)  # noqa: E731
    want = {f: stream(getattr(seq, f)) for f in ("mono", "left", "right")}
    want["pcm"] = mix.quantize_s16(mix.interleave(want["left"],
                                                  want["right"]))
    if cfg.supports_rds:
        want["rds_symbols"] = stream(seq.rds_symbols)
        want["rds_resync"] = seq.rds_resync.movedim(0, -1)
        want["rds_offset"] = seq.rds_offset.movedim(0, -1)
    return want


# ---- the halo, the codes and the coded replay ----

@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_exact_min_halo_equals_dy4tpu(mode):
    cfg = get_mode(mode)
    assert sharded.exact_min_halo_if(cfg) == jsharded.exact_min_halo_if(cfg)
    frac = {0: 4, 2: 3}.get(mode)
    if frac:      # a quarter block at mode 0, a third at mode 2
        assert frac * sharded.exact_min_halo_if(cfg) == cfg.if_per_block


def test_lazy_attributes_and_codes():
    assert dy4tpu_torch.ShardedReceiver is ShardedReceiver
    assert dy4tpu_torch.make_mesh is make_mesh
    assert (pll.CODE_POS, pll.CODE_NEG, pll.CODE_ZERO, pll.CODE_INVALID) == (
        jpll.CODE_POS, jpll.CODE_NEG, jpll.CODE_ZERO, jpll.CODE_INVALID)


def test_encode_sign_equals_dy4tpu():
    x = RNG.standard_normal((3, 2, 1000)).astype(np.float32)
    x[RNG.random(x.shape) < 0.1] = 0.0          # exact zeros
    x[0, 0, :5] = -0.0
    ours = pll.encode_sign(torch.from_numpy(x))
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jpll.encode_sign(jnp.asarray(x))))


def _coded_case(c=3, lanes=2, n_if=256, total=5):
    """Codes with exact zeros and an INVALID pre-stream prefix, a
    mid-stream carry, and the split after the live blocks, as
    tests/test_pll_pallas.py's coded case."""
    x = RNG.standard_normal((c, lanes, total * n_if)).astype(np.float32)
    x[..., 40:60] = 0.0
    codes = np.array(jpll.encode_sign(jnp.asarray(x)))
    codes[..., :n_if // 2] = jpll.CODE_INVALID
    carry = tuple(RNG.uniform(lo, hi, (c, lanes)).astype(np.float32)
                  for lo, hi in ((-1e-3, 1e-3), (0, 4 * np.pi),
                                 (0, 4 * np.pi)))
    return x, codes, carry, (total - 1) * n_if


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_coded_replay_matches_dy4tpu(impl):
    """Against dy4tpu's scan and its Pallas kernel (interpret mode on the
    CPU): phases and both carries within test_torch_pll.py's 2e-4."""
    _, codes, carry, split = _coded_case()
    pa, ma, ea = pll.phase_scan_coded(
        torch.from_numpy(codes), tuple(torch.from_numpy(c) for c in carry),
        split_at=split, **LANES)
    pb, mb, eb = jpll.phase_scan_coded(
        jnp.asarray(codes), tuple(jnp.asarray(c) for c in carry),
        split_at=split, impl=impl, **LANES)
    np.testing.assert_allclose(pa.numpy(), np.asarray(pb), atol=2e-4)
    for u, v in zip(ma + ea, mb + eb):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), atol=2e-4)


def _consts():
    return tuple(torch.as_tensor(v) for v in pll._loop_consts(
        LANES["freq"], LANES["fs"], LANES["norm_bandwidth"]))


@pytest.mark.parametrize("split", [0, 700, 1280], ids=["0", "mid", "end"])
def test_coded_replay_equals_the_sample_scan(split):
    """On valid codes the replay is the port's per-sample scan over the
    samples the codes came from, bit for bit: phases, the carry after
    ``split`` samples (the input carry at 0, the end carry at M) and the
    end carry."""
    x, codes, carry, _ = _coded_case()
    codes = pll.encode_sign(torch.from_numpy(x))    # every code valid
    carry = tuple(torch.from_numpy(c) for c in carry)
    phis, mid, end = pll.phase_scan_coded(codes, carry, split_at=split,
                                          **LANES)
    kp, ki, dth = _consts()
    x = torch.from_numpy(x)
    ref_phis, ref_end = pll_cuda.phase_scan_plain(x, kp, ki, dth, carry)
    _, ref_mid = pll_cuda.phase_scan_plain(x[..., :split], kp, ki, dth,
                                           carry)
    assert torch.equal(phis, ref_phis)
    for a, b in zip(mid + end, ref_mid + ref_end):
        assert torch.equal(a, b)


def test_invalid_codes_freeze_the_carry():
    """An INVALID prefix leaves the carry exactly at its input while its
    phases are still emitted; past it the replay is the sample scan from
    that carry; a row INVALID throughout ends where it began."""
    x, _, carry, _ = _coded_case()
    carry = tuple(torch.from_numpy(c) for c in carry)
    pre = 100
    codes = pll.encode_sign(torch.from_numpy(x))
    codes[..., :pre] = pll.CODE_INVALID
    codes[1, 0] = pll.CODE_INVALID                  # a padding row
    phis, mid, end = pll.phase_scan_coded(codes, carry, split_at=pre,
                                          **LANES)
    for a, b in zip(mid, carry):
        assert torch.equal(a, b)
    still = carry[2] + carry[1]                     # ang + pe, frozen
    assert torch.equal(phis[..., :pre], still[..., None].expand(-1, -1, pre))
    assert torch.equal(phis[1, 0], still[1, 0].expand(x.shape[-1]))
    for a, b in zip(end, carry):
        assert torch.equal(a[1, 0], b[1, 0])
    kp, ki, dth = _consts()
    ref_phis, ref_end = pll_cuda.phase_scan_plain(
        torch.from_numpy(x[..., pre:]), kp, ki, dth, carry)
    live = torch.ones(carry[0].shape, dtype=torch.bool)
    live[1, 0] = False
    assert torch.equal(phis[..., pre:][live], ref_phis[live])
    for a, b in zip(end, ref_end):
        assert torch.equal(a[live], b[live])
    with pytest.raises(ValueError, match="split_at"):
        pll.phase_scan_coded(codes, carry, split_at=x.shape[-1] + 1,
                             **LANES)


# ---- the 1x1 sharded receiver ----

@pytest.fixture(scope="module")
def mode0():
    """Mode 0, 8 blocks of two channels, the port's sequential run of each
    channel count, and a cache of 1x1 sharded runs (shard_blocks=4, two
    ``step`` calls) by (channels, overlap_blocks)."""
    cfg = get_mode(0)
    iq = _streams(cfg, 2, 8)
    params = rx.make_params(cfg, device=DEV)
    seq = {c: rx.run_blocks(params, rx.init_state(cfg, (c,), device=DEV),
                            _blocks(cfg, iq[:c]), cfg)[1] for c in (1, 2)}
    runs = {}

    def sharded_run(channels, overlap):
        if (channels, overlap) not in runs:
            r = ShardedReceiver(cfg, make_mesh(devices=[DEV]),
                                shard_blocks=4, overlap_blocks=overlap)
            assert r.halo_if == (cfg.if_per_block // 4 if overlap is None
                                 else cfg.if_per_block)
            runs[channels, overlap] = _run_sharded(
                r, params, torch.from_numpy(iq[:channels]))
        return runs[channels, overlap]

    return cfg, iq, seq, sharded_run


@pytest.mark.parametrize("overlap", [None, 1], ids=["auto_halo", "block"])
@pytest.mark.parametrize("channels", [1, 2])
def test_1x1_mode0_equals_run_blocks(mode0, channels, overlap):
    """shard_blocks=4, two ``step`` calls: every output field bit-equal to
    ``run_blocks`` on the same batch, across the step boundary."""
    cfg, _, seq, sharded_run = mode0
    got = sharded_run(channels, overlap)
    want = _seq_fields(cfg, seq[channels])
    assert got.keys() == want.keys()
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        assert torch.equal(got[f], want[f]), f


def test_1x1_mode0_matches_dy4tpu_unjitted(mode0):
    """The same 8 blocks through dy4tpu's un-jitted receiver_step:
    test_torch_modes.py's bars (floats to 1e-4, RDS decisions exact)."""
    cfg, iq, _, sharded_run = mode0
    got = sharded_run(2, None)
    jp = jrx.make_params(cfg)
    js = jrx.init_state(cfg, batch=(2,))
    outs = []
    for blk in _blocks(cfg, iq).numpy():
        js, jo = jrx.receiver_step(jp, js, jnp.asarray(blk), cfg)
        outs.append(jax.tree.map(np.asarray, jo))
    ref = rx.StepOutputs(*(None if f[0] is None else torch.from_numpy(
        np.stack(f)) for f in zip(*outs)))
    want = _seq_fields(cfg, ref)
    for f in ("mono", "left", "right"):
        np.testing.assert_allclose(got[f].numpy(), want[f].numpy(),
                                   atol=1e-4, err_msg=f)
    for f in ("rds_symbols", "rds_resync", "rds_offset"):
        np.testing.assert_array_equal(got[f].numpy(), want[f].numpy(),
                                      err_msg=f)


@pytest.mark.parametrize("mode", [1, 2])
def test_1x1_other_modes_equal_run_blocks(mode):
    """Mode 1 (no RDS, one PLL lane) and mode 2 (rational audio, 171/640
    RDS, 27 samples per symbol, a third-block halo): shard_blocks=2, two
    steps, bit-equal to ``run_blocks``."""
    cfg = get_mode(mode)
    channels = 2 if mode == 1 else 1
    iq = _streams(cfg, channels, 4)
    params = rx.make_params(cfg, device=DEV)
    r = ShardedReceiver(cfg, make_mesh(devices=[DEV]), shard_blocks=2)
    got = _run_sharded(r, params, torch.from_numpy(iq))
    _, seq = rx.run_blocks(params, rx.init_state(cfg, (channels,),
                                                 device=DEV),
                           _blocks(cfg, iq), cfg)
    want = _seq_fields(cfg, seq)
    assert got.keys() == want.keys()
    for f in want:
        assert torch.equal(got[f], want[f]), f


@pytest.mark.parametrize("exact,replay", [(True, True), (True, False),
                                          (False, True)])
def test_halo_longer_than_a_shard_raises(exact, replay):
    """dy4tpu's channel-parallel replay drops this guard (sharded.py:492)
    and clamps the carried codes (:531); the port refuses the geometry."""
    cfg = get_mode(0)
    mesh = Mesh(ch=1, time=4, ch_index=0, time_index=0, device=DEV)
    with pytest.raises(ValueError, match="halo"):
        ShardedReceiver(cfg, mesh, overlap_blocks=2, shard_blocks=1,
                        exact=exact, channel_parallel_replay=replay)
    r = ShardedReceiver(cfg, mesh, overlap_blocks=1, shard_blocks=1,
                        exact=exact, channel_parallel_replay=replay)
    assert r.chan_par == (exact and replay)


def _as_dict(tree):
    return convert.leaves_by_path(tree)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "legacy"])
def test_init_carry_equals_dy4tpu(exact):
    """The port's init carry on a 1x1 mesh is dy4tpu's, field path for
    field path (shape, dtype, value), and converts from it."""
    cfg = get_mode(0)
    theirs = JShardedReceiver(cfg, jmake_mesh(1, 1), exact=exact).init(2)
    ours = ShardedReceiver(cfg, make_mesh(devices=[DEV]),
                           exact=exact).init(2)
    frm = (convert.exact_carry_from_numpy if exact
           else convert.sharded_carry_from_numpy)
    back = frm(theirs, device=DEV)
    assert type(back) is type(ours)
    a, b, c = _as_dict(ours), _as_dict(theirs), _as_dict(back)
    assert a.keys() == b.keys() == c.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype == c[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(c[k], b[k], err_msg=k)


def test_stream_handed_over_from_dy4tpu():
    """dy4tpu's 1x1 ShardedReceiver (jitted) runs the first step of 4
    blocks; its ExactCarry crosses over; the port's second step matches
    dy4tpu's second step within test_torch_modes.py's hand-off bars
    (floats to 1e-4, the s16 PCM then to 2 LSB, RDS decisions exact).
    The carry is taken past the PLL's lock transient, where the jitted
    and un-jitted dy4tpu part by up to 1.1e-2 (ROADMAP Queue C)."""
    cfg = get_mode(0)
    iq = _streams(cfg, 2, 8)
    jr = JShardedReceiver(cfg, jmake_mesh(1, 1), shard_blocks=4)
    jp = jrx.make_params(cfg)
    carry = jr.init(2)
    carry, _ = jr.step(jp, carry, jnp.asarray(iq[:, :jr.chunk_len]))
    ours = convert.exact_carry_from_numpy(carry, device=DEV)
    _, jo = jr.step(jp, carry, jnp.asarray(iq[:, jr.chunk_len:]))
    r = ShardedReceiver(cfg, make_mesh(devices=[DEV]), shard_blocks=4)
    r.init(2)
    _, to = r.step(convert.params_from_numpy(jp, device=DEV), ours,
                   torch.from_numpy(iq[:, r.chunk_len:]))
    for f in ("mono", "left", "right"):
        np.testing.assert_allclose(getattr(to, f).numpy(),
                                   np.asarray(getattr(jo, f)), atol=1e-4,
                                   err_msg=f)
    pcm = to.pcm.numpy().astype(np.int32) - np.asarray(jo.pcm, np.int32)
    assert np.abs(pcm).max() <= 2
    for f in ("rds_symbols", "rds_resync", "rds_offset"):
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)), err_msg=f)


# ---- the multi-process helpers (monkeypatched environment) ----

_LAUNCH_VARS = ("SLURM_JOB_ID", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE",
                "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "MEGASCALE_COORDINATOR_ADDRESS", "TPU_WORKER_ID",
                "CLOUD_TPU_TASK_ID", "TPU_WORKER_HOSTNAMES", "WORLD_SIZE",
                "RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for k in _LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.fixture
def fake_init(clean_env):
    """Record init_process_group's calls instead of making them."""
    calls = []

    def init(backend=None, init_method=None, world_size=-1, rank=-1):
        calls.append((init_method, world_size, rank))

    clean_env.setattr(multihost.dist, "init_process_group", init)
    clean_env.setattr(multihost.dist, "is_initialized", lambda: False)
    return calls


def test_initialize_single_host(clean_env):
    topo = multihost.initialize()
    assert topo.num_processes == 1 and topo.is_coordinator
    assert len(topo.local_devices) >= 1


def test_initialize_defaults_to_launcher_env(fake_init, clean_env):
    """With no arguments but a launcher's environment, the process group
    is still brought up (from ``env://``); an explicit num_processes=1
    never brings it up; explicit arguments go through."""
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:8476")
    multihost.initialize()
    assert fake_init == [("env://", -1, -1)]
    fake_init.clear()
    multihost.initialize(num_processes=1)
    assert fake_init == []
    clean_env.delenv("JAX_COORDINATOR_ADDRESS")
    multihost.initialize(coordinator_address="10.0.0.2:8476",
                         num_processes=4, process_id=2)
    assert fake_init == [("tcp://10.0.0.2:8476", 4, 2)]
    fake_init.clear()
    for k, v in (("WORLD_SIZE", "4"), ("RANK", "1"),
                 ("MASTER_ADDR", "10.0.0.3"), ("MASTER_PORT", "29500")):
        clean_env.setenv(k, v)                      # torchrun's variables
    multihost.initialize()
    assert fake_init == [("env://", -1, -1)]


def test_initialize_single_process_launch_is_noop(fake_init, clean_env):
    """A single-node batch job, a one-host worker list and a torchrun of
    one process bring nothing up; a multi-task launch does."""
    clean_env.setenv("SLURM_JOB_ID", "12345")
    clean_env.setenv("SLURM_NTASKS", "1")
    clean_env.setenv("TPU_WORKER_HOSTNAMES", "localhost")
    clean_env.setenv("WORLD_SIZE", "1")
    clean_env.setenv("RANK", "0")
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")
    multihost.initialize()
    assert fake_init == []
    for k, v in (("SLURM_NTASKS", "4"), ("WORLD_SIZE", "2"),
                 ("TPU_WORKER_HOSTNAMES", "host-a,host-b")):
        clean_env.setenv(k, v)
        multihost.initialize()
        assert len(fake_init) == 1, k
        fake_init.clear()
        clean_env.setenv(k, {"TPU_WORKER_HOSTNAMES": "localhost"}.get(k, "1"))


def test_initialize_reraises_real_bringup_failure(clean_env):
    """A genuine bring-up failure raises; only a second initialization
    falls through (to the single-process topology here)."""
    def boom(**kw):
        raise RuntimeError("connection to coordinator timed out")

    clean_env.setattr(multihost.dist, "init_process_group", boom)
    clean_env.setattr(multihost.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="timed out"):
        multihost.initialize(coordinator_address="10.0.0.9:1",
                             num_processes=2, process_id=0)

    def already(**kw):
        raise RuntimeError("trying to initialize the default process group "
                           "twice: already initialized")

    clean_env.setattr(multihost.dist, "init_process_group", already)
    topo = multihost.initialize(coordinator_address="10.0.0.9:1",
                                num_processes=2, process_id=0)
    assert topo.num_processes == 1


def test_local_channel_slice_and_pod_mesh():
    # one process: every channel is local, and the mesh is 1x1
    assert multihost.local_channel_slice(12) == slice(0, 12)
    mesh = multihost.pod_mesh(time_per_host=1, devices=[DEV])
    assert mesh.shape == {"ch": 1, "time": 1} and mesh.time_group is None
    with pytest.raises(ValueError):
        multihost.pod_mesh(time_per_host=3, devices=[DEV])
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(ch=2, time=2, devices=[DEV] * 4)

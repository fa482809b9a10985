"""Packaging and dispatch rules of the port (dy4tpu_torch) that hold on a
machine without a GPU: it never imports JAX, a CPU tensor takes the plain
versions without counting a launch (in every mode and through the IF
entry), any other non-CUDA tensor is refused by the kernel wrappers, the
kernels are built for sm_90a (the PLL without FMA contraction), and
chip_smoke.py fails instead of falling back.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu_torch.ops import (backend_cuda, channelizer_cuda,  # noqa: E402
                              frontend_cuda, pll, pll_cuda, resample_cuda)
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.runtime import kernels  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
cfg = get_mode(0)
WRAPPERS = (frontend_cuda.fused_frontend_full, pll_cuda.phase_scan,
            backend_cuda.fused_audio_backend, resample_cuda.fused_rds_backend,
            resample_cuda.fused_audio_backend_rational,
            frontend_cuda.fused_frontend_if,
            channelizer_cuda.channelize_branches)


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import dy4tpu_torch\n"
            "assert 'torch' not in sys.modules, 'import dy4tpu_torch is heavy'\n"
            "from dy4tpu_torch.pipeline import convert, receiver, wideband\n"
            "from dy4tpu_torch.ops import (afc, backend_cuda, channelizer,"
            " channelizer_cuda, demod, fir, firdes, frontend_cuda, iqcorr,"
            " mix, pll, pll_cuda, resample_cuda, trig)\n"
            "from dy4tpu_torch.runtime import kernels\n"
            "from dy4tpu_torch.tools import wideband as tool\n"
            "from dy4tpu_torch.tx import fm\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax')\n"
            "print('JAX-MODULES', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "JAX-MODULES []" in r.stdout, r.stdout


def test_cpu_receiver_step_launches_no_kernel():
    counts = [w.launches for w in WRAPPERS]
    rng = np.random.default_rng(0)
    blk = torch.from_numpy(rng.integers(0, 256, (2, cfg.block_size),
                                        dtype=np.uint8))
    rx.receiver_step(rx.make_params(cfg), rx.init_state(cfg, (2,)), blk, cfg)
    assert [w.launches for w in WRAPPERS] == counts


def test_cpu_mode2_and_if_entry_launch_no_kernel():
    """Mode 2 (the rational back ends) and the IF entry on CPU tensors."""
    c = get_mode(2)
    counts = [w.launches for w in WRAPPERS]
    rng = np.random.default_rng(1)
    blk = torch.from_numpy(rng.integers(0, 256, (2, c.block_size),
                                        dtype=np.uint8))
    params = rx.make_params(c)
    rx.receiver_step(params, rx.init_state(c, (2,)), blk, c)
    i_if = torch.from_numpy(rng.standard_normal(
        (2, c.if_per_block)).astype(np.float32))
    rx.receiver_step_if(params, rx.init_state(c, (2,)), i_if, i_if, c)
    assert [w.launches for w in WRAPPERS] == counts


@pytest.mark.parametrize("which", range(len(WRAPPERS)))
def test_wrappers_refuse_non_cuda_devices(which):
    """A tensor that is not on the CPU goes to the kernel or raises: here
    a 'meta' tensor, which no kernel takes."""
    c, n = 2, cfg.if_per_block
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,  # noqa: E731
                                                 device="meta")
    calls = [
        lambda: frontend_cuda.fused_frontend_full(
            m(c, cfg.block_size, dt=torch.uint8), m(101), m(3, 101), m(101),
            m(c, 2, 100), m(c), m(c), m(c, 100), m(c, 50), m(c, 100),
            m(c, 50), cfg.rf_decim),
        lambda: pll_cuda.phase_scan(m(c, 2, n), m(2), m(2), m(2),
                                    (m(c, 2), m(c, 2), m(c, 2))),
        lambda: backend_cuda.fused_audio_backend(
            m(c, n), m(c, n), m(c, n), m(101), m(c, 100), m(c, 100),
            cfg.audio_down),
        lambda: resample_cuda.fused_rds_backend(
            m(c, n), m(c, n), m(c, n), m(1919), m(101), m(c, 100),
            m(c, 100), m(c, 100), m(c, 100), cfg.rds_up, cfg.rds_down),
        lambda: resample_cuda.fused_audio_backend_rational(
            m(c, 9600), m(c, 9600), m(c, 9600), m(14847), m(c, 100),
            m(c, 100), 147, 800),
        lambda: frontend_cuda.fused_frontend_if(
            m(c, n), m(c, n), m(c), m(c), m(3, 101), m(101), m(c, 100),
            m(c, 50), m(c, 100), m(c, 50)),
        lambda: channelizer_cuda.channelize_branches(
            m(c, 2 * 16 * n, dt=torch.uint8), m(16, 12), m(c, 191),
            m(c, 191)),
    ]
    before = WRAPPERS[which].launches
    with pytest.raises(ValueError, match="CUDA"):
        calls[which]()
    assert WRAPPERS[which].launches == before


def test_kernel_path_without_rds_reaches_the_kernel():
    """``rds=False`` (modes 1 and 3) goes to the kernel route like RDS
    does, with no RDS taps or tails: a meta tensor is refused there."""
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,  # noqa: E731
                                                 device="meta")
    for call in (
            lambda: frontend_cuda.fused_frontend_full(
                m(2, cfg.block_size, dt=torch.uint8), m(101), m(2, 101),
                None, m(2, 2, 100), m(2), m(2), m(2, 100), m(2, 50), None,
                None, cfg.rf_decim, rds=False),
            lambda: frontend_cuda.fused_frontend_if(
                m(2, 9216), m(2, 9216), m(2), m(2), m(2, 101), None,
                m(2, 100), m(2, 50), None, None, rds=False)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="CUDA"):
        pll.pll(torch.zeros(2, 64), pll.init_state((2,)), freq=19e3,
                fs=cfg.if_fs, impl="kernel")


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_nvcc_command_targets_sm90a(name):
    cmd = kernels.nvcc_command(name, Path("/tmp/x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert str(kernels.CSRC / f"{name}.cu") in cmd
    assert (kernels.CSRC / f"{name}.cu").is_file()
    assert ("-fmad=false" in cmd) == (name == "pll")
    assert kernels.lib_path(name).parent == kernels.build_dir()


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: chip_smoke.py runs")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    # alone in a directory, without the port beside it, it fails too
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout

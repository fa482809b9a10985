"""The port's utilities (dy4tpu_torch.utils.logging and .profiling)
against dy4tpu's, on CPU: the twins of tests/test_utils.py's logging
cases (``log_vector``'s file byte-equal to dy4tpu's, ``log_psd``'s bins
within 1e-3 dB of dy4tpu's on a tone, as test_fft_psd.py holds its PSD
routes), plus the profiler trace (the program's spans:
tests/test_torch_spans.py)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu.utils import gen  # noqa: E402
from dy4tpu.utils import logging as jlog  # noqa: E402
from dy4tpu_torch.utils import logging as dlog  # noqa: E402
from dy4tpu_torch.utils import profiling  # noqa: E402


def test_log_vector_gnuplot_format(tmp_path):
    path = dlog.log_vector("demo", None, [1.5, -2.25, 3.0],
                           directory=str(tmp_path))
    lines = open(path).read().strip().splitlines()
    assert len(lines) == 3
    x0, y0 = lines[0].split()
    assert float(x0) == 0.0 and float(y0) == 1.5


@pytest.mark.parametrize("with_x", [False, True])
def test_log_vector_bytes_equal_dy4tpu(tmp_path, with_x):
    y = np.random.default_rng(3).standard_normal(50) * 1e3
    x = np.linspace(-1.0, 7.5, 50) if with_x else None
    ours = dlog.log_vector("v", x, y, directory=str(tmp_path / "ours"))
    ref = jlog.log_vector("v", x, y, directory=str(tmp_path / "ref"))
    assert open(ours, "rb").read() == open(ref, "rb").read()
    assert os.path.basename(ours) == "v.dat"
    np.testing.assert_array_equal(dlog.gen_index_vector(7),
                                  jlog.gen_index_vector(7))
    assert dlog.DEFAULT_DIR == jlog.DEFAULT_DIR


def test_log_psd_writes_bins(tmp_path):
    x = gen.generate_sin(48e3, 1000, 4096)
    path = dlog.log_psd("psd", x, 48e3, nfft=512, directory=str(tmp_path),
                        device="cpu")
    assert os.path.exists(path)
    assert len(open(path).read().strip().splitlines()) == 256


def test_log_psd_equals_dy4tpu(tmp_path):
    """The same tone through both packages' ``log_psd``: the same
    frequency column to the file's 6 digits, the dB column within 1e-3 dB
    (bins within 60 dB of the peak; below, a Hann sidelobe's dB carries
    the two FFTs' rounding)."""
    x = gen.generate_sin(48e3, 1000, 4096) + 1e-3 * np.random.default_rng(
        4).standard_normal(4096)
    ours = np.loadtxt(dlog.log_psd("p", x, 48e3, directory=str(
        tmp_path / "ours"), device="cpu"))
    ref = np.loadtxt(jlog.log_psd("p", x, 48e3, directory=str(
        tmp_path / "ref")))
    np.testing.assert_array_equal(ours[:, 0], ref[:, 0])
    near = ref[:, 1] > ref[:, 1].max() - 60
    np.testing.assert_allclose(ours[near, 1], ref[near, 1], atol=1e-3)


def test_log_psd_defaults_to_the_card():
    """Without ``device`` the PSD is asked of the card (kernel B10), so a
    machine without one raises rather than runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        dlog.log_psd("p", np.ones(1024), 48e3, directory="/nonexistent")


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        torch.ones(64).sum()
    files = list(logdir.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)

"""The port's capture tools (dy4tpu_torch.tools.synth, .ratechange and
.psdview) against dy4tpu's on the same inputs, on CPU, and the
subprocess twins of tests/test_tools.py's ratechange and psdview cases,
run with ``--device cpu``.

Bars: synth's captures byte-equal to dy4tpu's for the same flags;
``resample_iq`` within 1 LSB of dy4tpu's (float32 sums in another order
may flip a u8 rounding at a half-step); psdview's per-block PSDs in
linear power, 10^(dB/10), within 1e-4 of each row's peak of dy4tpu's (the
dB of a deep Hann sidelobe turns a tiny absolute error into a large dB
one; the comparison in linear power weighs it by the bin's power).  The
capture for psdview is a broadcast from synth, so that the PLLs lock as
in test_torch_receiver.py.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu.tools import psdview as jpsdview  # noqa: E402
from dy4tpu.tools import ratechange as jratechange  # noqa: E402
from dy4tpu.tools import synth as jsynth  # noqa: E402
from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.tools import psdview, ratechange, synth  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ENV = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
       "OMP_NUM_THREADS": "2"}
PSD_LIN_TOL = 1e-4

SYNTH_CASES = {
    "default": ["--blocks", "3"],
    "station": ["--blocks", "3", "--pi", "0xF205", "--radiotext",
                "HELLO FROM THE PORT", "--af", "98.5,101.1", "--ptyn",
                "JAZZ"],
    "faults": ["--blocks", "3", "--dc", "0.1", "-0.05", "--iq-imbalance",
               "0.75", "20", "--multipath", "24:0.4:120,60:0.2"],
    "wideband": ["--blocks", "3", "--wideband", "4", "--stations", "1,3"],
}


def _run(mod, args, timeout=600):
    return subprocess.run([sys.executable, "-m", mod, *args],
                          capture_output=True, cwd=REPO, env=ENV,
                          timeout=timeout)


@pytest.mark.parametrize("case", sorted(SYNTH_CASES))
def test_synth_equals_dy4tpu(tmp_path, case):
    """Both ``main``s in-process with the same flags write the same
    bytes: a broadcast, an RDS station stream, the three faults, and a
    wideband capture."""
    flags = SYNTH_CASES[case]
    ours, ref = tmp_path / "ours.raw", tmp_path / "ref.raw"
    assert synth.main([str(ours), *flags]) == 0
    assert jsynth.main([str(ref), *flags]) == 0
    a, b = ours.read_bytes(), ref.read_bytes()
    assert len(a) > 0 and a == b


def test_synth_refuses_rds_in_a_mode_without_it(tmp_path):
    assert synth.main([str(tmp_path / "x.raw"), "--mode", "1", "--pi",
                       "0x1234"]) == 2
    assert synth.main([str(tmp_path / "x.raw"), "--wideband", "4",
                       "--stations", "5"]) == 2


def test_resample_iq_equals_dy4tpu():
    """2400 -> 1440 kS/s on the same u8 capture: equal lengths, every
    byte within 1 LSB."""
    iq = np.random.default_rng(0).integers(0, 256, 2 * 24000,
                                           dtype=np.uint8)
    ours = ratechange.resample_iq(iq, 2400e3, 1440e3, device="cpu")
    ref = np.asarray(jratechange.resample_iq(iq, 2400e3, 1440e3))
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    assert np.abs(ours.astype(np.int16) - ref).max() <= 1
    assert ratechange.RATES_KSPS == jratechange.RATES_KSPS


def _lin_err(got, ref) -> float:
    g, r = 10.0 ** (np.asarray(got, np.float64) / 10), \
        10.0 ** (np.asarray(ref, np.float64) / 10)
    return float((np.abs(g - r) / r.max()).max())


def test_block_psds_equal_dy4tpu(tmp_path):
    """psdview's first pass over a 3-block mode-0 broadcast from synth,
    block for block and panel for panel (RF I, RDS baseband, mono)."""
    cap = tmp_path / "c.raw"
    assert synth.main([str(cap), "--blocks", "3", "--pi", "0x54A7",
                       "--ps", "DY4TPU"]) == 0
    args = argparse.Namespace(infile=str(cap), blocks=3, nfft=512,
                              device="cpu")
    cfg = get_mode(0)
    ours, n = psdview._block_psds(args, cfg)
    ref, n_ref = jpsdview._block_psds(args, cfg)
    assert n == n_ref == 3 and len(ours) == len(ref) == 3
    for b in range(3):
        for panel, (po, pr) in enumerate(zip(ours[b], ref[b])):
            np.testing.assert_allclose(po[0], np.asarray(pr[0]), rtol=1e-12)
            assert po[1].shape == (256,) and np.isfinite(po[1]).all()
            err = _lin_err(po[1], pr[1])
            assert err <= PSD_LIN_TOL, (b, panel, err)


def test_block_psds_short_capture(tmp_path):
    cap = tmp_path / "short.raw"
    np.zeros(100, np.uint8).tofile(cap)
    args = argparse.Namespace(infile=str(cap), blocks=3, nfft=512,
                              device="cpu")
    assert psdview._block_psds(args, get_mode(0)) == (None, 0)


@pytest.mark.parametrize("tool", [psdview, ratechange])
def test_tools_refuse_cuda_without_a_card(tool, tmp_path, monkeypatch):
    """``--device cuda`` (the default) exits with an error where torch
    finds no CUDA device, and does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cap = tmp_path / "c.raw"
    np.zeros(2 * get_mode(0).block_size, np.uint8).tofile(cap)
    argv = ([str(cap), "--out", str(tmp_path / "p.png")] if tool is psdview
            else [str(cap), str(tmp_path / "o.raw"), "--to", "1440"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(argv)
    assert not (tmp_path / "o.raw").exists()


def test_ratechange_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    src = str(tmp_path / "in.raw")
    dst = str(tmp_path / "out.raw")
    rng.integers(0, 256, 2 * 240000, dtype=np.uint8).tofile(src)
    p = _run("dy4tpu_torch.tools.ratechange",
             [src, dst, "--to", "1440", "--device", "cpu"])
    assert p.returncode == 0, p.stderr.decode()
    assert os.path.getsize(dst) == 2 * 144000


def test_psdview_headless(tmp_path):
    pytest.importorskip("matplotlib")
    cap = str(tmp_path / "c.raw")
    png = str(tmp_path / "psd.png")
    np.random.default_rng(0).integers(
        0, 256, 2 * get_mode(0).block_size, dtype=np.uint8).tofile(cap)
    p = _run("dy4tpu_torch.tools.psdview",
             [cap, "--mode", "0", "--blocks", "2", "--out", png,
              "--device", "cpu"])
    assert p.returncode == 0, p.stderr.decode()
    assert os.path.getsize(png) > 10000


def test_psdview_animate_frames_and_gif(tmp_path):
    """--animate renders one frame per block (fmMonoAnim.py:44-93
    parity): PNG sequence via %d pattern, animated GIF via .gif."""
    pytest.importorskip("matplotlib")
    cap = str(tmp_path / "c.raw")
    np.random.default_rng(0).integers(
        0, 256, 3 * 2 * get_mode(0).block_size, dtype=np.uint8).tofile(cap)
    pat = str(tmp_path / "frame_%02d.png")
    p = _run("dy4tpu_torch.tools.psdview",
             [cap, "--mode", "0", "--blocks", "3", "--animate",
              "--out", pat, "--device", "cpu"])
    assert p.returncode == 0, p.stderr.decode()
    for b in range(3):
        assert os.path.getsize(pat % b) > 5000

    gif = str(tmp_path / "psd.gif")
    p = _run("dy4tpu_torch.tools.psdview",
             [cap, "--mode", "0", "--blocks", "3", "--animate",
              "--out", gif, "--device", "cpu"])
    assert p.returncode == 0, p.stderr.decode()
    assert os.path.getsize(gif) > 10000


def test_synth_impairment_flags(tmp_path):
    """--dc / --iq-imbalance / --multipath thread the tx fault models
    through to the capture (the twin of test_tools.py's case, run
    in-process: synth needs no device)."""
    cfg = get_mode(0)
    cap = str(tmp_path / "dc.raw")
    assert synth.main([cap, "--mode", "0", "--blocks", "4",
                       "--dc", "0.1", "-0.05"]) == 0
    iq = np.fromfile(cap, np.uint8)
    assert len(iq) == 4 * cfg.block_size
    assert 6.0 < iq[0::2].mean() - iq[1::2].mean() < 24.0

    cap2 = str(tmp_path / "fault.raw")
    assert synth.main([cap2, "--mode", "0", "--blocks", "4",
                       "--dc", "0.1", "-0.05", "--iq-imbalance", "0.75", "20",
                       "--multipath", "24:0.4:120,60:0.2"]) == 0
    iq2 = np.fromfile(cap2, np.uint8)
    assert len(iq2) == len(iq) and not np.array_equal(iq, iq2)

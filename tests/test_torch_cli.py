"""End-to-end tests of the port's CLI, ``python -m dy4tpu_torch``, over
real pipes with ``--device cpu`` (the plain versions): the twins of
dy4tpu's tests/test_cli.py and test_deemph.py::test_cli_deemphasis_flag,
at fewer blocks (the plain PLL is a Python loop on the CPU).  A test
whose dy4tpu twin is marked ``slow`` is marked ``slow`` here too.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.rds import coding  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ENV = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
       "OMP_NUM_THREADS": "2"}


def _capture(n_blocks=4, rds=False, mode=0):
    cfg = get_mode(mode)
    n_audio = n_blocks * cfg.audio_per_block
    left = fm.tone(800.0, cfg.audio_fs, n_audio, amp=0.7)
    right = fm.tone(2400.0, cfg.audio_fs, n_audio, amp=0.7)
    bits = (coding.make_ps_bitstream(0xBEEF, 10, "TESTING!", repeats=40)
            if rds else None)
    return cfg, fm.synthesize(cfg, n_blocks, left=left, right=right,
                              rds_bits=bits)


def _run(args, stdin_bytes, env=ENV, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "dy4tpu_torch", *args, "--device", "cpu"],
        input=stdin_bytes, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=REPO, env=env, timeout=timeout)


def _tone_ratio(x, fs, want, leak):
    t = np.arange(len(x)) / fs
    p = lambda f: np.abs(x @ np.exp(-2j * np.pi * f * t))  # noqa: E731
    return p(want) / p(leak)


def test_cli_stereo_pipe():
    cfg, iq = _capture(3)
    p = _run(["0", "s"], iq.tobytes())
    assert p.returncode == 0, p.stderr.decode()
    pcm = np.frombuffer(p.stdout, "<i2")
    assert len(pcm) == 3 * cfg.audio_per_block * 2   # interleaved L/R
    left = pcm[0::2][cfg.audio_per_block:] / 16384.0
    assert _tone_ratio(left, cfg.audio_fs, 800.0, 2400.0) > 3
    assert b"processed 3 blocks" in p.stderr
    assert b"x real-time) on cpu" in p.stderr


def test_cli_mono_output_length():
    cfg, iq = _capture(2)
    p = _run(["0", "m"], iq.tobytes())
    assert p.returncode == 0, p.stderr.decode()
    assert len(np.frombuffer(p.stdout, "<i2")) == 2 * cfg.audio_per_block


def test_cli_rejects_rds_on_unsupported_mode():
    p = _run(["1", "r"], b"")
    assert p.returncode == 2
    assert b"does not support RDS" in p.stderr


def test_cli_refuses_cuda_without_a_card():
    """The default device is the card; without one the CLI says so and
    exits nonzero instead of falling back."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, "-m", "dy4tpu_torch", "0", "m"],
                       input=b"", capture_output=True, cwd=REPO, env=ENV,
                       timeout=120)
    assert p.returncode != 0
    assert b"no CUDA device" in p.stderr


def test_cli_chunked_dispatch_identical_and_stdout_clean():
    """``--chunk N`` produces byte-identical PCM, and stdout stays a pure
    PCM pipe with the RDS console on (stereo + RDS in one run)."""
    cfg, iq = _capture(3, rds=True)
    p1 = _run(["0", "sr"], iq.tobytes())
    p2 = _run(["0", "sr", "--chunk", "2"], iq.tobytes())   # 2 + 1 blocks
    assert p1.returncode == 0 and p2.returncode == 0, p2.stderr.decode()
    assert p1.stdout == p2.stdout
    assert len(p1.stdout) == 3 * cfg.audio_per_block * 2 * 2


@pytest.mark.parametrize("mode", [1, 3])
def test_cli_other_modes_stereo(mode):
    cfg = get_mode(mode)
    n_blocks = 2
    n_audio = n_blocks * cfg.audio_per_block
    iq = fm.synthesize(cfg, n_blocks,
                       left=fm.tone(500.0, cfg.audio_fs, n_audio, amp=0.7),
                       right=fm.tone(1300.0, cfg.audio_fs, n_audio, amp=0.7))
    p = _run([str(mode), "s"], iq.tobytes())
    assert p.returncode == 0, p.stderr.decode()
    pcm = np.frombuffer(p.stdout, "<i2")
    assert len(pcm) == n_blocks * cfg.audio_per_block * 2
    left = pcm[0::2][cfg.audio_per_block:] / 16384.0
    assert _tone_ratio(left, cfg.audio_fs, 500.0, 1300.0) > 3


def test_cli_mode2_peak_cdr_hint(tmp_path, monkeypatch, capsys):
    """``2 r`` with the default peak CDR prints the hint; ``--cdr
    envelope`` or ``DY4TPU_CDR=envelope`` silence it, and mode 0 starts
    clean.  The hint prints at start-up, so an empty input will do; the
    CLI runs in this process (``app.main``) to save start-ups."""
    from dy4tpu_torch import app
    empty = tmp_path / "empty.raw"
    empty.write_bytes(b"")
    io = ["--input", str(empty), "--output", str(tmp_path / "o.pcm"),
          "--device", "cpu"]
    monkeypatch.delenv("DY4TPU_CDR", raising=False)

    def hint(*args):
        assert app.main([*args, *io]) == 0
        return "--cdr envelope" in capsys.readouterr().err

    assert hint("2", "r")
    assert not hint("2", "r", "--cdr", "envelope")
    assert not hint("0", "r")
    monkeypatch.setenv("DY4TPU_CDR", "envelope")
    assert not hint("2", "r")


def test_cli_span_pll_from_the_environment():
    """``DY4TPU_PLL_SPAN=8`` reaches the receiver (the PCM differs from
    the exact loop's); a span that does not divide the block is
    refused."""
    cfg, iq = _capture(1)
    exact = _run(["0", "s"], iq.tobytes())
    span = _run(["0", "s"], iq.tobytes(),
                env={**ENV, "DY4TPU_PLL_SPAN": "8"})
    assert span.returncode == 0, span.stderr.decode()
    assert len(span.stdout) == len(exact.stdout)
    assert span.stdout != exact.stdout
    bad = _run(["0", "s"], b"", env={**ENV, "DY4TPU_PLL_SPAN": "7"})
    assert bad.returncode != 0 and b"does not divide" in bad.stderr


def test_cli_deemphasis_flag(tmp_path):
    """``--deemphasis us`` runs end to end and attenuates a 12 kHz tone by
    about the analog curve's 17 dB against the parity default."""
    cfg = get_mode(0)
    n_blocks = 2
    n_audio = n_blocks * cfg.audio_per_block
    iq = fm.synthesize(cfg, n_blocks,
                       left=fm.tone(12e3, cfg.audio_fs, n_audio, amp=0.5),
                       right=fm.tone(12e3, cfg.audio_fs, n_audio, amp=0.5))
    raw = tmp_path / "iq.raw"
    iq.tofile(raw)

    def rms(extra):
        out = tmp_path / f"pcm_{len(extra)}.raw"
        p = _run(["0", "m", "--input", str(raw), "--output", str(out),
                  *extra], None)
        assert p.returncode == 0, p.stderr.decode()
        pcm = np.fromfile(out, "<i2").astype(np.float64)
        return np.sqrt(np.mean(pcm[len(pcm) // 2:] ** 2))

    ratio_db = 20 * np.log10(rms(["--deemphasis", "us"]) / rms([]))
    assert -20.0 < ratio_db < -13.0, ratio_db


@pytest.mark.slow
def test_cli_rds_decodes_station():
    cfg, iq = _capture(20, rds=True)
    p = _run(["0", "r"], iq.tobytes())
    assert p.returncode == 0, p.stderr.decode()
    err = p.stderr.decode()
    assert "PI=BEEF" in err, err
    assert "TESTING!" in err, err


@pytest.mark.slow
def test_cli_rds_json_events(tmp_path):
    """``--rds-json FILE``: one JSON-lines event per decoded group, with
    the accumulated station snapshot."""
    cfg, iq = _capture(20, rds=True)
    out = tmp_path / "events.jsonl"
    p = _run(["0", "r", "--rds-json", str(out)], iq.tobytes())
    assert p.returncode == 0, p.stderr.decode()
    events = [json.loads(line) for line in
              out.read_text().strip().splitlines()]
    assert len(events) >= 3
    last = events[-1]
    assert last["pi"] == "BEEF"
    assert last["ps"] == "TESTING!"
    assert last["groups_seen"] == len(events)
    assert all(e["group"] == "0A" for e in events)

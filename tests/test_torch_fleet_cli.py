"""The port's fleet serving tool (dy4tpu_torch.tools.fleet) as a user runs
it, on the CPU: chunks of 1, 3 and 8 blocks and ``--sync-ingest`` give
equal RDS arrays and equal station lines; ``main()`` prints dy4tpu's line
formats and decodes PI at every station, says so when a capture is
shorter than a block, refuses ``--device cuda`` without a card, and runs
``--iqcorr`` and ``--mode 2 --cdr envelope``; and (slow) the twin of
tests/test_tools.py's synth -> fleet round trip.  The outputs against
dy4tpu's are in tests/test_torch_fleet.py.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.rds import coding  # noqa: E402
from dy4tpu_torch.runtime import native  # noqa: E402
from dy4tpu_torch.tools import fleet  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime not built")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.pathsep.join(
    [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
              if p])}
cfg = get_mode(0)
N_BLOCKS = 16
STATIONS = ((0x54A7, "DY4TPU  "), (0x0A0B, "FLEET  2"))
FIELDS = ("rds_symbols", "rds_resync", "rds_offset")
STATS = re.compile(r"^(\d+) stations x (\d+) blocks \((overlapped|sync) "
                   r"ingest, chunk=(\d+)\): wall \d+ ms = \d+ MS/s \(\d+x "
                   r"real-time\); phases: put \d+ ms, dispatch \d+ ms, host "
                   r"decode \d+ ms$")
STATION = re.compile(r"^\[ *(\d+)\] (.+): PI=(\S+) PS=(.+) PTY=(.+) "
                     r"\((\d+) groups\)")


def _capture(path, mode, n_blocks, pi, ps, **kw):
    c = get_mode(mode)
    n_audio = n_blocks * c.audio_per_block
    bits = coding.make_ps_bitstream(pi, 10, ps, repeats=8)
    iq = fm.synthesize(c, n_blocks, rds_bits=bits,
                       left=fm.tone(800.0, c.audio_fs, n_audio, amp=0.6),
                       right=fm.tone(2400.0, c.audio_fs, n_audio, amp=0.6),
                       **kw)
    iq.tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    return [_capture(d / f"st{i}.raw", 0, N_BLOCKS, pi, ps)
            for i, (pi, ps) in enumerate(STATIONS)]


def test_chunks_and_sync_ingest_agree(caps):
    """Chunks of 1, 3 and 8 blocks, overlapped and synchronous, over the
    first 3 blocks: equal arrays, equal station lines."""
    runs = [fleet.serve(caps, cfg, chunk=k, sync_ingest=s, max_blocks=3,
                        record=True, device=DEV)
            for k, s in ((1, False), (3, False), (8, True))]
    lines = [fleet.report(r, cfg, DEV)[1:] for r in runs]
    for r in runs:
        assert r.n_blocks == 3
        for f in FIELDS:
            assert getattr(r, f).shape[:2] == (3, 2)
            np.testing.assert_array_equal(getattr(r, f),
                                          getattr(runs[0], f), err_msg=f)
    assert lines[0] == lines[1] == lines[2]
    assert [r.chunk for r in runs] == [1, 3, 8]
    assert fleet.report(runs[2], cfg, DEV)[0].split("(")[1].startswith(
        "sync ingest, chunk=8)")


def test_main_prints_dy4tpu_lines(caps, capsys):
    """A 16-block capture x 2 through ``main()``: dy4tpu's stats line and
    one station line each, PI decoded at both stations."""
    assert fleet.main(["--mode", "0", "--repeat", "2", "--device", "cpu",
                       caps[0]]) == 0
    err = capsys.readouterr().err.splitlines()
    m = STATS.match(err[0])
    assert m and m.groups() == ("2", str(N_BLOCKS), "overlapped", "8"), err
    assert len(err) == 3
    for ch, line in enumerate(err[1:]):
        s = STATION.match(line)
        assert s, line
        assert (int(s.group(1)), s.group(2), s.group(3)) == (ch, caps[0],
                                                             "54A7")
        assert int(s.group(6)) >= 1


def test_main_short_capture_and_bad_device(tmp_path, capsys):
    short = tmp_path / "short.raw"
    np.zeros(cfg.block_size - 2, np.uint8).tofile(short)
    assert fleet.main(["--device", "cpu", str(short)]) == 1
    assert "shorter than one block" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, "-m", "dy4tpu_torch.tools.fleet",
                        str(short)], capture_output=True, cwd=REPO, env=ENV,
                       timeout=120)
    assert p.returncode != 0
    assert b"no CUDA device" in p.stderr


@pytest.mark.parametrize("mode,flags", [(0, ["--iqcorr"]),
                                        (2, ["--cdr", "envelope"])])
def test_main_options_run(tmp_path, capsys, mode, flags):
    """``--iqcorr`` (a capture through a tuner fault) and mode 2 with the
    envelope CDR run end to end on two blocks."""
    fault = (dict(dc_i=0.1, dc_q=-0.05, iq_gain=0.75, iq_phase_deg=15.0)
             if "--iqcorr" in flags else {})
    cap = _capture(tmp_path / "c.raw", mode, 2, 0x54A7, "DY4TPU  ", **fault)
    assert fleet.main(["--mode", str(mode), "--device", "cpu", *flags,
                       cap, cap]) == 0
    err = capsys.readouterr().err.splitlines()
    assert STATS.match(err[0]).groups()[:2] == ("2", "2")
    assert len(err) == 3 and all(STATION.match(ln) for ln in err[1:])


@pytest.mark.slow
def test_synth_then_fleet_roundtrip(tmp_path):
    """Twin of tests/test_tools.py's round trip: the port's synth, then
    the port's fleet, both as subprocesses, on the CPU."""
    cap = str(tmp_path / "st.raw")

    def run(mod, args):
        return subprocess.run([sys.executable, "-m", mod, *args],
                              capture_output=True, cwd=REPO, env=ENV,
                              timeout=900)

    p = run("dy4tpu_torch.tools.synth",
            [cap, "--mode", "0", "--blocks", "20", "--pi", "0x0A0B",
             "--ps", "TOOLTEST"])
    assert p.returncode == 0, p.stderr.decode()
    assert os.path.getsize(cap) == 20 * cfg.block_size
    p = run("dy4tpu_torch.tools.fleet",
            ["--mode", "0", "--device", "cpu", cap, cap])
    assert p.returncode == 0, p.stderr.decode()
    err = p.stderr.decode()
    assert err.count("PI=0A0B") == 2, err
    assert "2 stations" in err

"""Checkpoint / resume of the port (dy4tpu_torch.utils.checkpoint): the
port's own round trip, a file written by dy4tpu mid-stream (with the IQ
tracker and the RDS host decoder) loaded into the port, and the CLI's
``--checkpoint`` / ``--resume`` on the CPU.

Bars: within the port a resumed stream continues bit for bit (the state
round-trips exactly); a dy4tpu file continues within the port's bars
against dy4tpu (outputs 1e-4, decisions exact), since from there on two
packages compute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
DEV = "cpu"   # the port's entry points default to the card

import jax.numpy as jnp  # noqa: E402

from dy4tpu.config import get_mode  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.rds.decoder import RDSDecoder as JDecoder  # noqa: E402
from dy4tpu.utils import checkpoint as jckpt  # noqa: E402
from dy4tpu_torch import app  # noqa: E402
from dy4tpu_torch.pipeline import convert  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.rds import coding  # noqa: E402
from dy4tpu_torch.rds import decoder as tdecoder  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402
from dy4tpu_torch.utils import checkpoint as ckpt  # noqa: E402

cfg = get_mode(0)
FAULT = dict(dc_i=0.1, dc_q=-0.05, iq_gain=0.75, iq_phase_deg=15.0)


def _blocks(n_blocks):
    """[n_blocks, 1, block] u8: the broadcast through a faulted tuner."""
    n_audio = n_blocks * cfg.audio_per_block
    bits = coding.make_ps_bitstream(fm.PI_CODE, 10, fm.PS_NAME,
                                    repeats=max(2, n_blocks))
    iq = fm.synthesize(cfg, n_blocks,
                       left=fm.tone(800.0, cfg.audio_fs, n_audio, amp=0.7),
                       right=fm.tone(2400.0, cfg.audio_fs, n_audio, amp=0.7),
                       rds_bits=bits, **FAULT)
    return iq.reshape(n_blocks, 1, cfg.block_size)


def _template(with_iqcorr=True, batch=(1,)):
    return rx.init_state(cfg, batch, with_iqcorr=with_iqcorr, device=DEV)


def test_port_round_trip_continues_bit_for_bit(tmp_path):
    blocks = torch.from_numpy(_blocks(3))
    params = rx.make_params(cfg, device=DEV)
    st, _ = rx.receiver_step(params, _template(), blocks[0], cfg)
    dec = tdecoder.RDSDecoder()
    dec.push_block(np.random.default_rng(0).integers(0, 2, 300)
                   .astype(np.int8))
    path = str(tmp_path / "rx.ckpt")
    ckpt.save(path, st, host_state={"manchester": dec.manchester,
                                    "framer": dec.framer},
              meta={"block": 1})
    st2, host, meta = ckpt.load(path, _template())
    assert meta == {"block": 1}
    assert type(host["framer"]) is tdecoder.FrameSynchronizer
    for a, b in zip(convert.leaves_by_path(st).values(),
                    convert.leaves_by_path(st2).values()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for b in (1, 2):
        st, o1 = rx.receiver_step(params, st, blocks[b], cfg)
        st2, o2 = rx.receiver_step(params, st2, blocks[b], cfg)
        for f in rx.StepOutputs._fields:
            assert torch.equal(getattr(o1, f), getattr(o2, f)), f


def test_load_refuses_a_mismatched_template(tmp_path):
    path = str(tmp_path / "rx.ckpt")
    ckpt.save(path, _template(), meta={"block": 0})
    with pytest.raises(ValueError, match="state leaves"):
        ckpt.load(path, _template(with_iqcorr=False))
    with pytest.raises(ValueError, match="template's"):
        ckpt.load(path, _template(batch=(2,)))
    wrong = _template()
    wrong = wrong._replace(rds=wrong.rds._replace(cdr=wrong.rds.cdr._replace(
        offset=wrong.rds.cdr.offset.to(torch.int64))))
    with pytest.raises(ValueError, match="int64"):
        ckpt.load(path, wrong)


def test_dy4tpu_file_loads_into_the_port(tmp_path):
    """dy4tpu runs block 0 with the tracker and RDS, feeds its host
    decoder, and saves; the port loads the file (its decoder classes come
    from ``dy4tpu_torch.rds``) and continues as dy4tpu does."""
    blocks = _blocks(2)
    jp = jrx.make_params(cfg)
    js, jo = jrx.receiver_step(jp, jrx.init_state(cfg, batch=(1,),
                                                  with_iqcorr=True),
                               jnp.asarray(blocks[0]), cfg)
    jdec = JDecoder()
    jdec.push_block(np.asarray(jo.rds_symbols)[0],
                    resync=bool(np.asarray(jo.rds_resync)[0]),
                    offset=int(np.asarray(jo.rds_offset)[0]))
    path = str(tmp_path / "dy4tpu.ckpt")
    jckpt.save(path, js, host_state={
        "manchester": jdec.manchester, "framer": jdec.framer,
        "last_offset": jdec._last_offset,
        "deemph": (np.zeros(1, np.float32),)}, meta={"block": 1})

    st, host, meta = ckpt.load(path, _template())
    assert meta["block"] == 1
    assert type(host["manchester"]) is tdecoder.ManchesterDecoder
    assert type(host["framer"]) is tdecoder.FrameSynchronizer
    assert st.iqcorr.count.dtype == torch.int32
    assert int(st.iqcorr.count[0]) == 1

    js, jo = jrx.receiver_step(jp, js, jnp.asarray(blocks[1]), cfg)
    st, to = rx.receiver_step(convert.params_from_numpy(jp, device=DEV),
                              st, torch.from_numpy(blocks[1]), cfg)
    for f in rx.StepOutputs._fields:
        ours, ref = getattr(to, f).numpy(), np.asarray(getattr(jo, f))
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(ours, ref, atol=1e-3 if f ==
                                       "pilot_snr_db" else 1e-4, err_msg=f)
        else:
            np.testing.assert_array_equal(ours, ref, err_msg=f)
    # the unpickled host decoder continues as dy4tpu's
    tdec = tdecoder.RDSDecoder()
    tdec.manchester, tdec.framer = host["manchester"], host["framer"]
    tdec._last_offset = host["last_offset"]
    more = np.random.default_rng(1).integers(0, 2, 400).astype(np.int8)
    np.testing.assert_array_equal(tdec.manchester.push(more),
                                  jdec.manchester.push(more))


def test_cli_checkpoint_resume_equals_uninterrupted(tmp_path):
    """``--checkpoint`` after 2 blocks, then ``--resume`` over the rest of
    the capture: the PCM of the two runs, end to end, equals one
    uninterrupted run's (tracker, blend and de-emphasis on)."""
    blocks = _blocks(4)
    full = tmp_path / "all.raw"
    rest = tmp_path / "rest.raw"
    blocks.tofile(full)
    blocks[2:].tofile(rest)
    ck = str(tmp_path / "cli.ckpt")
    common = ["0", "sr", "--device", "cpu", "--iqcorr", "--stereo-blend",
              "--deemphasis", "us"]

    def run(inp, out, *extra):
        assert app.main([*common, "--input", str(inp), "--output",
                         str(out), *extra]) == 0
        return np.fromfile(out, "<i2")

    whole = run(full, tmp_path / "whole.pcm")
    first = run(full, tmp_path / "first.pcm", "--max-blocks", "2",
                "--checkpoint", ck)
    second = run(rest, tmp_path / "second.pcm", "--resume", ck)
    assert len(whole) == 4 * cfg.audio_per_block * 2
    np.testing.assert_array_equal(np.concatenate([first, second]), whole)


@pytest.mark.parametrize("writer", ["port", "dy4tpu"])
def test_holds_tells_a_tracker_file_from_one_without(tmp_path, writer):
    """``holds`` reads the tracker's presence from a port file's field
    paths and from a dy4tpu file's leaf count; the CLI's ``--resume``
    picks its template by it and loads once."""
    for tracked in (True, False):
        path = str(tmp_path / f"{writer}-{tracked}.ckpt")
        if writer == "port":
            ckpt.save(path, _template(with_iqcorr=tracked))
        else:
            jckpt.save(path, jrx.init_state(cfg, batch=(1,),
                                            with_iqcorr=tracked))
        assert ckpt.holds(path, "iqcorr", _template()) is tracked
        want = _template() if tracked else _template(with_iqcorr=False)
        st, _, _ = ckpt.load(path, want)
        assert (st.iqcorr is not None) is tracked

"""The compiled step's host side on the CPU: no host copy and no host
read in a warm step, and the chunk runner against dy4tpu.

**Sync audit.**  A CUDA graph cannot capture a host-to-device copy from
numpy, a read of a device value on the host, or an operation whose
output shape depends on the data; on the card each of them would also
stall the host every block.  After one warm-up chunk through the runner,
a second chunk of every configuration the compiled step covers (modes
0-3, the IF entry, the IQ tracker, the span PLL with both emits, the
envelope CDR, and the CLI's chunk body) calls none of ``torch.tensor``,
``torch.as_tensor``, ``torch.from_numpy``, ``Tensor.item``, ``.cpu``,
``.numpy`` or ``.tolist`` (each patched to raise) and dispatches no
``aten._local_scalar_dense`` and no ``aten.nonzero`` (a
``TorchDispatchMode``).  On the card ``chip_smoke.py`` phase 10 runs the
same steps under ``torch.cuda.set_sync_debug_mode("error")``.

**Against dy4tpu.**  One case a mode: ``graph.run_blocks`` at chunks of
2 over 3 blocks (a ragged last chunk) against dy4tpu's un-jitted
``receiver_step`` loop, on tests/test_torch_modes.py's capture (the
bench broadcast with noise 0.02, and the same with I/Q swapped) and
within its bars: every float output and state leaf to atol 1e-4
(measured about 1e-6), the pilot SNR to 1e-3 dB, and every RDS decision
exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from dy4tpu.config import get_mode as jget_mode  # noqa: E402
from dy4tpu.pipeline import receiver as jrx  # noqa: E402
from dy4tpu.rds import coding  # noqa: E402
from dy4tpu.tx import fm as jfm  # noqa: E402
from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.ops import deemph  # noqa: E402
from dy4tpu_torch.pipeline import convert, graph  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.tx import fm  # noqa: E402
from torch_graph_cases import (CONFIGS, DEV, FAULT, Case,  # noqa: E402
                               audited, blocks_of)

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_warm_step_makes_no_host_copy_or_read(monkeypatch, name):
    case = Case(name)
    runner = graph.receiver_runner(case.params, case.state(), case.cfg,
                                   entry=case.entry, **case.kw)
    runner.run(*(t[:1] for t in case.inputs))          # the warm-up
    second = tuple(t[1:2] for t in case.inputs)
    audited(monkeypatch, lambda: runner.run(*second))


def test_warm_cli_chunk_makes_no_host_copy_or_read(monkeypatch):
    cfg = get_mode(0)
    blocks = blocks_of(0, tuple(sorted(FAULT.items())))[:, :1].contiguous()
    runner = graph.cli_runner(
        rx.make_params(cfg, device=DEV),
        rx.init_state(cfg, (1,), with_iqcorr=True, device=DEV),
        deemph.init_deemph_state((1,), stereo=True, device=DEV), cfg,
        stereo=True, blend=True, de_a=deemph.deemph_coeff(cfg.audio_fs),
        keep_rds=True, cdr_timing="envelope")
    runner.run(blocks[:1])
    audited(monkeypatch, lambda: runner.run(blocks[1:2]))


# ---- against dy4tpu ----

def _assert_leaf(ours, ref, name, atol=1e-4):
    if ref is None:
        assert ours is None, name
        return
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, name
    assert ours.dtype == ref.dtype, (name, ours.dtype, ref.dtype)
    if ref.dtype.kind == "f":
        np.testing.assert_allclose(ours, ref, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(ours, ref, err_msg=name)


def _noisy_broadcast(cfg, n_blocks):
    """tests/test_torch_modes.py's [n_blocks, 2, block_size] u8."""
    n_audio = n_blocks * cfg.audio_per_block
    bits = coding.make_ps_bitstream(fm.PI_CODE, 10, fm.PS_NAME, repeats=4)
    iq = jfm.synthesize(cfg, n_blocks,
                        left=jfm.tone(800.0, cfg.audio_fs, n_audio, amp=0.7),
                        right=jfm.tone(2400.0, cfg.audio_fs, n_audio,
                                       amp=0.7),
                        rds_bits=bits, noise=0.02, seed=5).reshape(
                            n_blocks, 1, cfg.block_size)
    swapped = iq.reshape(n_blocks, 1, -1, 2)[..., ::-1].reshape(iq.shape)
    return np.concatenate([iq, swapped], axis=1)


@pytest.mark.parametrize("mode", (0, 1, 2, 3))
def test_runner_matches_dy4tpu(mode):
    n = 3
    cfg = get_mode(mode)
    blocks = torch.from_numpy(_noisy_broadcast(jget_mode(mode), n))
    jp = jrx.make_params(jget_mode(mode))
    js = jrx.init_state(jget_mode(mode), batch=(2,))
    j_outs = []
    for blk in blocks.numpy():
        js, jo = jrx.receiver_step(jp, js, jnp.asarray(blk), jget_mode(mode))
        j_outs.append(jo)
    state, outs = graph.run_blocks(convert.params_from_numpy(jp, device=DEV),
                                   rx.init_state(cfg, (2,), device=DEV),
                                   blocks, cfg, chunk=2)
    for f in rx.StepOutputs._fields:
        ref = getattr(j_outs[0], f)
        if ref is None:
            assert getattr(outs, f) is None, f
            continue
        _assert_leaf(getattr(outs, f), np.stack(
            [np.asarray(getattr(o, f)) for o in j_outs]), f,
            1e-3 if f == "pilot_snr_db" else 1e-4)
    ours = convert.state_to_numpy(state)
    ref = convert.leaves_by_path(js)
    assert ours.keys() == ref.keys()
    for k in ref:
        _assert_leaf(ours[k], ref[k], k)

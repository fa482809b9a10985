"""The compiled step's chunk runner on the CPU with the receiver's options
and the CLI's chunk body, against the eager receiver.

``graph.run_blocks`` (``graph.run_blocks_if`` for the IF entry) at
chunks of 1, 2 and 3 over 5 blocks of C=3 channels, bitwise equal to the
eager loop in outputs and end state: the IF entry at mode 0, the IQ
tracker on the broadcast through test_iqcorr.py's tuner fault, the span
PLL (``pll_span=8``) with both emits, and the envelope CDR at mode 2.
The CLI's chunk body (``graph.cli_runner``: steps, stereo blend,
de-emphasis, interleave and quantize) is held the same way to the eager
chunk loop ``app.py`` ran before it, at the CLI's C=1.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu_torch.config import get_mode  # noqa: E402
from dy4tpu_torch.ops import deemph, mix  # noqa: E402
from dy4tpu_torch.pipeline import graph  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from torch_graph_cases import (DEV, FAULT, KS, N_BLOCKS, Case,  # noqa: E402
                               assert_tree_equal, blocks_of)

OPTIONS = ("if_mode0", "tracker", "span8", "span8_kernel_emit",
           "envelope_mode2")


@pytest.fixture(scope="module", params=OPTIONS)
def case(request):
    c = Case(request.param)
    c.reference = c.eager()
    return c


@pytest.mark.parametrize("k", KS)
def test_runner_equals_eager_with_options(case, k):
    run = graph.run_blocks if case.entry == "rf" else graph.run_blocks_if
    state, outs = run(case.params, case.state(), *case.inputs, case.cfg,
                      chunk=k, **case.kw)
    want_state, want_outs = case.reference
    assert_tree_equal(outs, want_outs, f"{case.name} chunk {k} outputs")
    assert_tree_equal(state, want_state, f"{case.name} chunk {k} state")


# ---- the CLI's chunk body ----

def _eager_cli(params, state, de_state, cfg, blocks, *, stereo, blend,
               de_a, keep_rds, **kw):
    """The eager chunk loop of the receiver CLI (one chunk of every
    block: the quantize is elementwise): PCM and the RDS fields, and the
    end state."""
    outs = []
    for blk in blocks:
        state, out = rx.receiver_step(params, state, blk, cfg, **kw)
        if blend and stereo:
            bl, br = mix.stereo_blend(out.left, out.right, out.pilot_snr_db)
            out = out._replace(left=bl, right=br)
        if de_a is not None:
            streams = (out.left, out.right) if stereo else (out.mono,)
            filt = [deemph.deemphasis_block(s, d, de_a)
                    for s, d in zip(streams, de_state)]
            de_state = tuple(f[1] for f in filt)
            ys = tuple(f[0] for f in filt)
            out = (out._replace(left=ys[0], right=ys[1]) if stereo
                   else out._replace(mono=ys[0]))
        outs.append(out)
    if stereo:
        pcm = mix.quantize_s16(mix.interleave(
            torch.stack([o.left for o in outs]),
            torch.stack([o.right for o in outs])))
    else:
        pcm = mix.quantize_s16(torch.stack([o.mono for o in outs]))
    host = [pcm]
    if keep_rds:
        host += [torch.stack([getattr(o, f) for o in outs])
                 for f in ("rds_symbols", "rds_resync", "rds_offset")]
    return tuple(host), (state, de_state)


# (mode, stereo, blend, de-emphasis tau, RDS, tracker): the phase-4 CLI
# (0 sr --iqcorr --stereo-blend --deemphasis us) at every chunk, and a
# mono path with the European de-emphasis at chunks of 3
CLI = {"mode0_sr_blend_us_iqcorr": (0, True, True, deemph.TAU_US_75, True,
                                    True),
       "mode1_mono_eu": (1, False, False, deemph.TAU_EU_50, False, False)}
CLI_RUNS = [("mode0_sr_blend_us_iqcorr", k) for k in KS] + [
    ("mode1_mono_eu", 3)]
_CLI_CASES = {}


def _cli_case(name):
    if name in _CLI_CASES:
        return _CLI_CASES[name]
    mode, stereo, blend, tau, rds, tracker = CLI[name]
    cfg = get_mode(mode)
    fault = tuple(sorted(FAULT.items())) if tracker else ()
    blocks = blocks_of(mode, fault)[:, :1].contiguous()     # C=1
    params = rx.make_params(cfg, with_rds=rds, device=DEV)

    def fresh():
        st = rx.init_state(cfg, (1,), with_rds=rds, with_iqcorr=tracker,
                           device=DEV)
        return st, deemph.init_deemph_state((1,), stereo=stereo, device=DEV)

    opts = dict(stereo=stereo, blend=blend,
                de_a=deemph.deemph_coeff(cfg.audio_fs, tau), keep_rds=rds)
    ref = _eager_cli(params, *fresh(), cfg, blocks, with_rds=rds, **opts)
    _CLI_CASES[name] = dict(cfg=cfg, blocks=blocks, params=params,
                            fresh=fresh, opts=opts, rds=rds, ref=ref)
    return _CLI_CASES[name]


@pytest.mark.parametrize("name,k", CLI_RUNS)
def test_cli_body_equals_the_eager_chunk_loop(name, k):
    cli_case = _cli_case(name)
    cfg, blocks = cli_case["cfg"], cli_case["blocks"]
    runner = graph.cli_runner(cli_case["params"], *cli_case["fresh"](), cfg,
                              with_rds=cli_case["rds"], **cli_case["opts"])
    parts = [runner.run(blocks[lo:lo + k])
             for lo in range(0, N_BLOCKS, k)]
    got = tuple(torch.cat(f) for f in zip(*parts))
    want, want_carry = cli_case["ref"]
    assert_tree_equal(got, want, f"CLI body chunk {k}")
    assert_tree_equal(runner.read(), want_carry, f"CLI carry chunk {k}")
    assert got[0].dtype == torch.int16
    assert got[0].shape[-1] == cfg.audio_per_block * (
        2 if cli_case["opts"]["stereo"] else 1)

"""The wideband tool's chunk loop (``tools/wideband.run_chunks``) on the
CPU: chunks of 3 over 5 steps of one band (both buffer slots and a
ragged last chunk), each a run of the wideband step's chunk runner, give
bit for bit the eager ``run_wideband_blocks``' outputs and the RSSI sum
the tool squelches on; the runner's end state is the eager one.  The
capture is tests/test_torch_graph_wideband.py's band 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dy4tpu_torch.pipeline import graph  # noqa: E402
from dy4tpu_torch.pipeline import receiver as rx  # noqa: E402
from dy4tpu_torch.pipeline import wideband as wb  # noqa: E402
from dy4tpu_torch.tools import wideband as tool  # noqa: E402
from test_torch_graph_wideband import STEPS, WCase  # noqa: E402
from torch_graph_cases import DEV, assert_tree_equal  # noqa: E402

K = 3


def test_tool_chunk_loop_equals_eager():
    case = WCase("default")
    blocks = case.blocks[:, 0].contiguous()
    state = wb.wideband_init(case.cfg, case.chan)
    ref_state, ref = wb.run_wideband_blocks(case.params, case.chan, state,
                                            blocks, case.cfg)
    runner = graph.wideband_runner(case.params, case.chan, state, case.cfg)
    rssi_sum, chunks = tool.run_chunks(runner, blocks.numpy(), K, DEV)
    assert [c.mono.shape[0] for c in chunks] == [K, STEPS - K]
    for f in rx.StepOutputs._fields:
        theirs = getattr(ref.rx, f)
        if theirs is None:
            assert all(getattr(c, f) is None for c in chunks), f
            continue
        ours = np.concatenate([getattr(c, f) for c in chunks])
        np.testing.assert_array_equal(ours, theirs.numpy(), err_msg=f)
    want = np.float64(0.0)
    for lo in range(0, STEPS, K):
        part = ref.rssi[lo:lo + K]
        want = want + part.mean(0).numpy() * part.shape[0]
    assert rssi_sum.dtype == np.float64
    np.testing.assert_array_equal(rssi_sum, want)
    assert_tree_equal(runner.read(), ref_state, "end state")

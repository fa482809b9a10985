"""Helper of the port's end-to-end CPU tests: several captures through one
batched receiver run.

The port's plain PLL is a torch loop over time whose cost does not grow
with the channel count, so a test file's captures ride one batch: each is
one channel, padded to the longest with u8 128 (the zero signal).  The
receiver is causal, so channel c's first n_c blocks are its capture's
own, whatever follows them.
"""

import numpy as np
import torch

from dy4tpu_torch.pipeline import receiver as rx


def run_batch(cfg, captures, state=None, init_kwargs=None, states_at=(),
              **step_kwargs):
    """``captures``: u8 arrays of n_c * block_size.  Returns
    ``run_blocks``' outputs [max n_c, len(captures), ...] on the CPU;
    ``step_kwargs`` go to ``receiver_step``.

    ``state``: the batch's state before the captures' first block (a
    checkpoint, or a state ``convert.state_from_numpy`` made), else
    ``init_state(cfg, (len(captures),), **init_kwargs)``.  With
    ``states_at`` (block counts), returns ``(outputs, {k: the state after
    the first k blocks})``."""
    bs = cfg.block_size
    n = max(len(x) for x in captures) // bs
    blocks = np.full((n, len(captures), bs), 128, np.uint8)
    for ch, x in enumerate(captures):
        blocks[:len(x) // bs, ch] = x.reshape(-1, bs)
    blocks = torch.from_numpy(blocks)
    params = rx.make_params(cfg, device="cpu")
    if state is None:
        state = rx.init_state(cfg, (len(captures),), device="cpu",
                              **(init_kwargs or {}))
    kept, parts = {0: state}, []
    cuts = sorted({0, n, *states_at})
    for a, b in zip(cuts, cuts[1:]):
        state, outs = rx.run_blocks(params, state, blocks[a:b], cfg,
                                    **step_kwargs)
        parts.append(outs)
        kept[b] = state
    outs = rx.StepOutputs(*(None if f[0] is None else torch.cat(f)
                            for f in zip(*parts)))
    if not states_at:
        return outs
    return outs, {k: kept[k] for k in states_at}

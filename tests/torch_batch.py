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


def run_batch(cfg, captures, **step_kwargs):
    """``captures``: u8 arrays of n_c * block_size.  Returns
    ``run_blocks``' outputs [max n_c, len(captures), ...] on the CPU;
    ``step_kwargs`` go to ``receiver_step``."""
    bs = cfg.block_size
    n = max(len(x) for x in captures) // bs
    blocks = np.full((n, len(captures), bs), 128, np.uint8)
    for ch, x in enumerate(captures):
        blocks[:len(x) // bs, ch] = x.reshape(-1, bs)
    params = rx.make_params(cfg, device="cpu")
    state = rx.init_state(cfg, (len(captures),), device="cpu")
    _, outs = rx.run_blocks(params, state, torch.from_numpy(blocks), cfg,
                            **step_kwargs)
    return outs

"""Training data: the deterministic synthetic token stream.

Port of skypilot_tpu/train/data.py `synthetic_data` for one process: the
same counter-based seeding, so both packages see the same tokens, and a
run resumed at `start_step` sees exactly the batches the lost run would
have seen next.  Batches come as torch tensors on `device`.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device


def synthetic_data(global_batch_size: int, seq_len: int, vocab_size: int,
                   seed: int = 0, start_step: int = 0,
                   device: DeviceLike = 'cuda'
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite deterministic LM batches on `device`: int32 inputs and
    next-token targets, an all-ones f32 mask."""
    dev = resolve_device(device)
    step = start_step
    while True:
        rng = np.random.default_rng((seed, 0, step))
        tokens = rng.integers(1, vocab_size,
                              (global_batch_size, seq_len + 1),
                              dtype=np.int32)
        step += 1
        batch = {'inputs': tokens[:, :-1], 'targets': tokens[:, 1:],
                 'mask': np.ones((global_batch_size, seq_len), np.float32)}
        yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
               for k, v in batch.items()}

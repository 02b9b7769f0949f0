"""PyTorch/CUDA port of skypilot_tpu's serving path for NVIDIA Hopper.

The package mirrors the JAX package's paths (`ops/`, `models/`,
`infer/`) so each counterpart is easy to find.  It imports torch and
numpy only; nothing of JAX and nothing of `skypilot_tpu`.  The two
attention kernels of the paged serving path are hand-written CUDA C++
for sm_90a (`csrc/`), built with nvcc at first use and bound with
ctypes (`ops/_build.py`).

Every entry point takes an explicit `device`, which defaults to
'cuda': without a card it raises unless the caller asks for the CPU,
where the kernels' plain PyTorch versions run instead.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = 'cuda') -> torch.device:
    """The torch.device to run on; raises for CUDA when no card is
    present (there is no silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            'PyTorch versions on the CPU')
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev

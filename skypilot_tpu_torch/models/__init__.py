"""Model registry of the port: name -> (torch module, config).

Llama family only in this slice (models/llama.py); the other families
of skypilot_tpu.models come later.
"""
from __future__ import annotations

from typing import Any, Tuple

from skypilot_tpu_torch import DeviceLike, resolve_device


def get_model(name: str, device: DeviceLike = 'cuda',
              **overrides: Any) -> Tuple[Any, Any]:
    """Return (nn.Module with uninitialized weights on `device`, config)."""
    from skypilot_tpu_torch.models import llama
    config = get_config(name, **overrides)
    return llama.Llama(config, resolve_device(device)), config


def get_config(name: str, **overrides: Any) -> Any:
    """The config `get_model` would build, without building the model."""
    from skypilot_tpu_torch.models import llama
    if name not in llama.CONFIGS:
        raise ValueError(f'Unknown model {name!r}; '
                         f'available: {available_models()}')
    return llama.get_config(name, **overrides)


def num_params(config: Any) -> int:
    from skypilot_tpu_torch.models import llama
    return llama.num_params(config)


def available_models():
    from skypilot_tpu_torch.models import llama
    return sorted(llama.CONFIGS)

"""Model registry of the port: name -> (torch module, config).

Families: llama-* / llama3* / mistral (models/llama.py), mixtral-* MoE
(models/moe.py), gemma-* (models/gemma.py), gpt2-* (models/gpt2.py),
qwen* (models/qwen.py), as skypilot_tpu.models resolves them, in its
lookup order (deepseek, moe, llama, gemma, gpt2, qwen).  deepseek-* is
not ported yet: its names raise a ValueError that says what they wait
for.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from skypilot_tpu_torch import DeviceLike, resolve_device

_NOT_PORTED = ('deepseek',)


def _families():
    """(config module, model class, config class) in lookup order."""
    from skypilot_tpu_torch.models import gemma, gpt2, llama, moe, qwen
    return ((moe, moe.Mixtral, moe.MoEConfig),
            (llama, llama.Llama, llama.LlamaConfig),
            (gemma, gemma.Gemma, gemma.GemmaConfig),
            (gpt2, gpt2.Gpt2, gpt2.Gpt2Config),
            (qwen, qwen.Qwen, qwen.QwenConfig))


def _family_of_config(config: Any):
    """The family whose config class `config` is."""
    for fam in _families():
        if type(config) is fam[2]:
            return fam
    raise ValueError(f'not a config of a ported family: {config!r}')


def get_config(name: str, **overrides: Any) -> Any:
    """The config `get_model` would build, without building the model."""
    if name.split('-')[0] in _NOT_PORTED:
        raise ValueError(
            f'model {name!r}: the deepseek family is not ported yet '
            "(ROADMAP.md queue 1: 'The other families'); its absorbed "
            'decode needs kernel 4 at head width 576 over one KV head '
            "(ROADMAP.md queue 2: 'Head widths other than 64 and 128')")
    for mod, _, _ in _families():
        if name in mod.CONFIGS:
            return mod.get_config(name, **overrides)
    raise ValueError(f'Unknown model {name!r}; '
                     f'available: {available_models()}')


def build(config: Any, device: DeviceLike = 'cuda') -> Any:
    """The model of `config`'s family, with uninitialized weights on
    `device`; on the 'meta' device it has shapes and no storage (for
    checks that need no values)."""
    dev = torch.device(device)
    if dev.type != 'meta':
        dev = resolve_device(dev)
    return _family_of_config(config)[1](config, dev)


def get_model(name: str, device: DeviceLike = 'cuda',
              **overrides: Any) -> Tuple[Any, Any]:
    """Return (nn.Module with uninitialized weights on `device`, config)."""
    config = get_config(name, **overrides)
    return build(config, device), config


def num_params(config: Any) -> int:
    """Analytic parameter count, by the config's family."""
    return _family_of_config(config)[0].num_params(config)


def active_params(config: Any) -> int:
    """Parameters a forward multiplies per token: num_params, less the
    experts a token is not routed through (MoE)."""
    mod = _family_of_config(config)[0]
    return getattr(mod, 'active_params', mod.num_params)(config)


def flops_per_token_parts(config: Any) -> Tuple[float, float]:
    """(base, attn_per_ctx): the forward cost of one decoded token is
    base + attn_per_ctx * context; base is 2 * active params, and
    attn_per_ctx prices the QK^T and PV products over n_heads heads of
    head_dim a live context position (the reference's)."""
    base = 2.0 * active_params(config)
    attn_per_ctx = 2.0 * config.n_layers * config.n_heads \
        * 2 * config.head_dim
    return base, attn_per_ctx


def flops_per_token(config: Any, context: int) -> float:
    """Forward flops to decode one token whose attention spans `context`
    live positions."""
    base, attn = flops_per_token_parts(config)
    return base + attn * context


def available_models():
    from skypilot_tpu_torch.models import gemma, gpt2, llama, moe, qwen
    return (sorted(llama.CONFIGS) + sorted(moe.CONFIGS)
            + sorted(gemma.CONFIGS) + sorted(gpt2.CONFIGS)
            + sorted(qwen.CONFIGS))

"""Qwen2 family, in PyTorch.

Port of skypilot_tpu/models/qwen.py.  Qwen2 is the Llama block with
three config-driven deltas, so everything else (the cache plans, the
kernels, remat, LoRA, int8 weights and caches) is models/llama.py's:
  - biases on the q/k/v projections, never on o_proj
    (`attention_bias=True`, read by `llama.Attention`);
  - the small configs tie the head to the token embedding
    (`tie_embeddings`: f32 logits from tok_embed), the larger ones untie;
  - rope_theta 1e6, normal(0.02) embeddings, explicit head_dim.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from skypilot_tpu_torch.models import llama


@dataclasses.dataclass(frozen=True)
class QwenConfig(llama.LlamaConfig):
    """LlamaConfig with the reference's Qwen2 defaults and fields;
    `head_dim` is a field here (the reference's), not dim // n_heads."""
    vocab_size: int = 152064
    dim: int = 3584
    n_layers: int = 28
    n_heads: int = 28
    n_kv_heads: int = 4
    ffn_dim: int = 18944
    max_seq_len: int = 32768
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    head_dim: int = 128
    attention_bias: bool = True      # the Qwen2 signature
    tie_embeddings: bool = False


CONFIGS: Dict[str, QwenConfig] = {
    'qwen-tiny': QwenConfig('qwen-tiny', vocab_size=512, dim=128,
                            n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=32, ffn_dim=256, max_seq_len=512,
                            tie_embeddings=True),
    'qwen2-0.5b': QwenConfig('qwen2-0.5b', vocab_size=151936, dim=896,
                             n_layers=24, n_heads=14, n_kv_heads=2,
                             head_dim=64, ffn_dim=4864,
                             tie_embeddings=True),
    'qwen2-7b': QwenConfig('qwen2-7b'),
    'qwen2-72b': QwenConfig('qwen2-72b', dim=8192, n_layers=80,
                            n_heads=64, n_kv_heads=8, head_dim=128,
                            ffn_dim=29568),
}


def get_config(name: str, **overrides: Any) -> QwenConfig:
    if name not in CONFIGS:
        raise ValueError(f'Unknown qwen config {name!r}; '
                         f'available: {sorted(CONFIGS)}')
    return dataclasses.replace(CONFIGS[name], **overrides)


class Qwen(llama.Llama):
    """Llama blocks with q/k/v biases; tied or untied f32 head."""
    embed_std = 0.02


def num_params(config: QwenConfig) -> int:
    """Analytic parameter count (QKV biases included)."""
    cfg = config
    qkv_out = cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads)
    per_layer = (cfg.dim * qkv_out + qkv_out            # qkv + biases
                 + cfg.n_heads * cfg.head_dim * cfg.dim  # o_proj
                 + 3 * cfg.dim * cfg.ffn_dim             # gated mlp
                 + 2 * cfg.dim)                          # 2 norms
    total = cfg.vocab_size * cfg.dim + cfg.n_layers * per_layer + cfg.dim
    if not cfg.tie_embeddings:
        total += cfg.dim * cfg.vocab_size
    return total

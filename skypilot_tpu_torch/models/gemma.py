"""Gemma family, in PyTorch.

Port of skypilot_tpu/models/gemma.py.  Gemma is the Llama block with
config-driven deltas, so the cache plans, the kernels, remat, LoRA, int8
weights and caches are models/llama.py's:
  - a GeGLU MLP: tanh-approximate GELU on the gate, times up
    (`activation='gelu'`, read by `llama.MLP`);
  - RMSNorm whose weight is an offset from 1, initialised to 0 and added
    in f32 (`GemmaRMSNorm`, in the blocks and the final norm);
  - the embedding lookup in `dtype`, then times sqrt(dim) in f32, then
    back to `dtype` (the reference's rounding order; under int8 weights
    after the dequantize);
  - a head tied to tok_embed (f32 logits), with an optional final-logit
    softcap, cap * tanh(logits / cap), on every logits path (`head`:
    the prefill, decode, verify, mixed and draft forwards, the decode
    graphs);
  - head_dim decoupled from dim: 256 for every config but the tiny one,
    which the serving kernels 4 and 5 and the flash kernels 1-3 take at
    that width.
Gemma trains through the shared `train_forward` (remat 'nothing' or
'save_attn', LoRA adapters, `train_only`), its loss over the softcapped
tied head, whole or chunk by chunk (train/trainer.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from skypilot_tpu_torch.models import llama


@dataclasses.dataclass(frozen=True)
class GemmaConfig(llama.LlamaConfig):
    """LlamaConfig with the reference's Gemma defaults and fields;
    `head_dim` is a field here (the reference's), not dim // n_heads."""
    vocab_size: int = 256128
    dim: int = 3072
    n_layers: int = 28
    n_heads: int = 16
    n_kv_heads: int = 16
    ffn_dim: int = 24576
    max_seq_len: int = 8192
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    head_dim: int = 256
    activation: str = 'gelu'
    # Gemma-2's convention: logits -> cap * tanh(logits / cap); None = off.
    final_logit_softcap: Optional[float] = None

    tie_embeddings = True


CONFIGS: Dict[str, GemmaConfig] = {
    'gemma-tiny': GemmaConfig('gemma-tiny', vocab_size=512, dim=128,
                              n_layers=2, n_heads=2, n_kv_heads=1,
                              head_dim=64, ffn_dim=256, max_seq_len=512),
    'gemma-2b': GemmaConfig('gemma-2b', dim=2048, n_layers=18,
                            n_heads=8, n_kv_heads=1, head_dim=256,
                            ffn_dim=16384),
    'gemma-7b': GemmaConfig('gemma-7b'),
}


def get_config(name: str, **overrides: Any) -> GemmaConfig:
    if name not in CONFIGS:
        raise ValueError(f'Unknown gemma config {name!r}; '
                         f'available: {sorted(CONFIGS)}')
    return dataclasses.replace(CONFIGS[name], **overrides)


class GemmaRMSNorm(llama.RMSNorm):
    """RMSNorm with the weight stored as an offset from 1: (1 + w) in f32
    scales the normalised input, as the reference's `plus_one`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), self.weight.shape,
                          1.0 + self.weight.float(), self.eps).to(self.dtype)


class GemmaBlock(llama.Block):
    norm_cls = GemmaRMSNorm


class Gemma(llama.Llama):
    """Llama blocks with GeGLU and plus-one norms; embeddings scaled by
    sqrt(dim); a tied f32 head, softcapped when the config says so."""
    block_cls = GemmaBlock
    norm_cls = GemmaRMSNorm
    embed_std = 0.02
    norm_init = 0.0

    def embed(self, tokens: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = self._token_rows(tokens).to(dt)
        return (x.float() * self.cfg.dim ** 0.5).to(dt)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        logits = super().head(x)
        cap = self.cfg.final_logit_softcap
        return cap * torch.tanh(logits / cap) if cap else logits


def num_params(config: GemmaConfig) -> int:
    """Analytic parameter count (tied head: the embedding counted once)."""
    cfg = config
    per_layer = (cfg.dim * cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads)
                 + cfg.n_heads * cfg.head_dim * cfg.dim
                 + 3 * cfg.dim * cfg.ffn_dim + 2 * cfg.dim)
    return cfg.vocab_size * cfg.dim + cfg.n_layers * per_layer + cfg.dim

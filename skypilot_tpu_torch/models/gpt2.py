"""GPT-2 family, in PyTorch.

Port of skypilot_tpu/models/gpt2.py: LayerNorm with scale and bias
(computed in f32, cast back), learned positional embeddings added at the
embedding (no rope), one fused biased q/k/v projection, a biased o_proj,
multi-head attention (n_kv_heads == n_heads, so the kernels run at a
group of 1), a tanh-GELU MLP with biases, and a head tied to tok_embed
(f32 logits).  The blocks run through the Llama model's shared forwards
(models/llama.py `hidden`, `train_forward`): the same cache plans, the
same kernels, the same remat.

The config carries the fields the shared forwards read and GPT-2 has no
use for as fixed properties: n_kv_heads (= n_heads), head_dim,
sliding_window (None), remat_policy ('nothing', the reference's only
policy for this family), lora_rank (0: the reference has no LoRA here).

`pos_embed` has max_seq_len rows: a position past them has no
embedding, so an engine whose max_seq_len exceeds the rows of the
weights it loads raises at construction (infer/engine.py
`build_model`).  Pad queries of a slot forward may sit past max_seq_len
- 1 (their writes are dropped and their outputs never read); their
lookup is clamped to the last row.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch.models import llama


@dataclasses.dataclass(frozen=True)
class Gpt2Config:
    name: str
    vocab_size: int = 50257
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    attention_impl: str = 'flash'
    kv_cache_dtype: str = 'auto'     # 'auto' | 'int8' (llama.py)
    # Paged serving KV cache (llama.py PagedCache); 0 = contiguous rows.
    kv_page_size: int = 0
    kv_n_pages: int = 0
    quantize: Optional[str] = None   # None | 'int8' (llama.py)

    def __post_init__(self):
        llama.check_config(self)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def n_kv_heads(self) -> int:
        return self.n_heads

    sliding_window = None
    remat_policy = 'nothing'
    lora_rank = 0
    tie_embeddings = True


CONFIGS: Dict[str, Gpt2Config] = {
    'gpt2-tiny': Gpt2Config('gpt2-tiny', vocab_size=512, dim=128,
                            n_layers=2, n_heads=2, ffn_dim=256,
                            max_seq_len=256),
    'gpt2': Gpt2Config('gpt2'),
    'gpt2-medium': Gpt2Config('gpt2-medium', dim=1024, n_layers=24,
                              n_heads=16, ffn_dim=4096),
    'gpt2-large': Gpt2Config('gpt2-large', dim=1280, n_layers=36,
                             n_heads=20, ffn_dim=5120),
    'gpt2-xl': Gpt2Config('gpt2-xl', dim=1600, n_layers=48, n_heads=25,
                          ffn_dim=6400),
}


def get_config(name: str, **overrides: Any) -> Gpt2Config:
    if name not in CONFIGS:
        raise ValueError(f'Unknown gpt2 config {name!r}; '
                         f'available: {sorted(CONFIGS)}')
    return dataclasses.replace(CONFIGS[name], **overrides)


class LayerNorm(nn.Module):
    """LayerNorm with scale (`weight`) and bias, in f32, cast back to
    `dtype` (the reference's LayerNorm)."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = llama._param((dim,), param_dtype, device)
        self.bias = llama._param((dim,), param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.dtype)


class Gpt2Attention(llama.Attention):
    """One fused biased projection to (3, H, hd), a biased o_proj."""

    def __init__(self, cfg: Gpt2Config, device: torch.device):
        nn.Module.__init__(self)
        self.cfg = cfg
        h, hd, d = cfg.n_heads, cfg.head_dim, cfg.dim
        shapes = {'qkv_proj': (3 * h * hd, d), 'o_proj': (d, h * hd)}
        for name, shape in shapes.items():
            llama._weight(self, name, shape, cfg.param_dtype, cfg, device)
        llama._add_biases(self, shapes, cfg, device)

    def qkv(self, x: torch.Tensor, rope: None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q [B, H, S, hd] (contiguous), k and v [B, H, S, hd] of the normed
        input; no rope (positions were added at the embedding)."""
        cfg = self.cfg
        b, s, _ = x.shape
        qkv = llama._project(self, 'qkv_proj', x.to(cfg.dtype)).view(
            b, s, 3, cfg.n_heads, cfg.head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return q.contiguous(), k, v


class Gpt2Mlp(nn.Module):
    """Biased up and down projections around a tanh GELU."""

    def __init__(self, cfg: Gpt2Config, device: torch.device):
        super().__init__()
        self.cfg = cfg
        shapes = {'up_proj': (cfg.ffn_dim, cfg.dim),
                  'down_proj': (cfg.dim, cfg.ffn_dim)}
        for name, shape in shapes.items():
            llama._weight(self, name, shape, cfg.param_dtype, cfg, device)
        llama._add_biases(self, shapes, cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = llama._project(self, 'up_proj', x.to(self.cfg.dtype))
        return llama._project(self, 'down_proj',
                              F.gelu(up, approximate='tanh'))


class Gpt2Block(llama.Block):
    """ln_1, attention, ln_2, MLP (the port names them as llama's:
    attention_norm and mlp_norm)."""

    def __init__(self, cfg: Gpt2Config, device: torch.device):
        nn.Module.__init__(self)
        args = (cfg.dim, cfg.norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.attention_norm = LayerNorm(*args)
        self.attention = Gpt2Attention(cfg, device)
        self.mlp_norm = LayerNorm(*args)
        self.mlp = Gpt2Mlp(cfg, device)


class Gpt2(llama.Llama):
    """Decoder-only transformer with learned positions; tied f32 head."""
    block_cls = Gpt2Block
    norm_cls = LayerNorm
    embed_std = 0.02

    def __init__(self, cfg: Gpt2Config, device: torch.device):
        super().__init__(cfg, device)
        self.pos_embed = llama._param((cfg.max_seq_len, cfg.dim),
                                      cfg.param_dtype, device)

    def _init_std(self, name: str) -> float:
        """The reference's: positions normal(0.01); both residual-writing
        projections (o_proj, down_proj) scaled by 1/sqrt(2 * n_layers)."""
        if name == 'pos_embed':
            return 0.01
        if name.endswith('down_proj'):
            name = 'o_proj'
        return super()._init_std(name)

    def embed(self, tokens: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
        """(token rows + position rows) in param_dtype, then cfg.dtype."""
        pos = F.embedding(positions.clamp(max=self.cfg.max_seq_len - 1),
                          self.pos_embed)
        return (self._token_rows(tokens) + pos).to(self.cfg.dtype)

    def rope(self, positions: torch.Tensor) -> None:
        return None


def num_params(config: Gpt2Config) -> int:
    cfg = config
    per_layer = (4 * cfg.dim * cfg.dim + 3 * cfg.dim + cfg.dim   # attn
                 + 2 * cfg.dim * cfg.ffn_dim + cfg.ffn_dim + cfg.dim
                 + 4 * cfg.dim)                                  # 2 LN
    return (cfg.vocab_size * cfg.dim + cfg.max_seq_len * cfg.dim
            + cfg.n_layers * per_layer + 2 * cfg.dim)

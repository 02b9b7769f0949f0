"""Mixture-of-Experts family (Mixtral), in PyTorch.

Port of skypilot_tpu/models/moe.py on one device: the Llama attention
and norms (models/llama.py, so the kernels, caches, remat and LoRA on
q/k/v/o are shared) with the MLP replaced by a top-k routed expert FFN
(`MoEMLP`):
  - an f32 router (weight [E, D]; int8 under weight-only int8, as the
    reference quantizes its kernel), softmax, top-k, the top-k gates
    renormalised;
  - the Switch load-balance loss `router_aux_coef * E * sum(me * ce)`,
    summed over layers by `train_forward(return_aux=True)` for the
    trainer (the reference sows it and `sum_aux_losses` adds it up);
  - capacity `max(1, int(capacity_factor * T * k / E))` over the T tokens
    of the call, filled in choice-major order (every token's first
    choice, then every second), the overflow dropped: so the idle rows
    of a decode step and the padded positions of a prefill chunk compete
    for capacity as they do in the reference's engine;
  - the expert FFN as batched products over [E, C, D] (the reference
    computes them as XLA einsums, outside any kernel), expert weights
    stacked [E, D, F] / [E, F, D] as the reference's bare params (float
    under int8 weights, as the reference leaves them);
  - the gate-weighted combine in cfg.dtype.

Dispatch is one sort-based algorithm for both `moe_dispatch` values: the
reference documents 'dense' (one-hot einsums) and 'sparse' (argsort and
scatter) as the same routing, drops and outputs, and tests them equal.
It has static shapes and no host sync, so the S = 1 decode forward with
MoE layers is captured in a CUDA graph (infer/graphs.py): the dropped
(token, choice) pairs go to a spare row E * C of the [E * C + 1, D]
dispatch buffer, and the combine gathers each token's k expert outputs
back and adds them in choice order (no atomics: replay equals eager bit
for bit).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch.models import llama


@dataclasses.dataclass(frozen=True)
class MoEConfig(llama.LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2
    # capacity per expert = capacity_factor * tokens * k / E.
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.02
    # 'dense' or 'sparse': the reference's two dispatch formulations of
    # one routing; the port runs one sort-based dispatch for both.
    moe_dispatch: str = 'dense'

    def __post_init__(self):
        super().__post_init__()
        if self.moe_dispatch not in ('dense', 'sparse'):
            raise ValueError(f"moe_dispatch must be 'dense' or 'sparse', got "
                             f'{self.moe_dispatch!r}')


CONFIGS: Dict[str, MoEConfig] = {
    'mixtral-tiny': MoEConfig(
        'mixtral-tiny', vocab_size=512, dim=256, n_layers=2, n_heads=2,
        n_kv_heads=1, ffn_dim=512, max_seq_len=512, n_experts=4,
        experts_per_token=2),
    'mixtral-8x7b': MoEConfig(
        'mixtral-8x7b', vocab_size=32000, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, ffn_dim=14336, max_seq_len=32768,
        rope_theta=1e6, n_experts=8, experts_per_token=2),
    'mixtral-8x22b': MoEConfig(
        'mixtral-8x22b', vocab_size=32768, dim=6144, n_layers=56,
        n_heads=48, n_kv_heads=8, ffn_dim=16384, max_seq_len=65536,
        rope_theta=1e6, n_experts=8, experts_per_token=2),
}


def get_config(name: str, **overrides: Any) -> MoEConfig:
    if name not in CONFIGS:
        raise ValueError(f'Unknown MoE config {name!r}; '
                         f'available: {sorted(CONFIGS)}')
    return dataclasses.replace(CONFIGS[name], **overrides)


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Expert capacity for a call over `tokens` tokens."""
    return max(1, int(cfg.capacity_factor * tokens * cfg.experts_per_token
                      / cfg.n_experts))


def route(cfg: MoEConfig, router_logits: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(renormalised top-k gates [T, k] f32, experts [T, k], aux loss) of
    f32 router logits [T, E]."""
    probs = torch.softmax(router_logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    # Switch: mean gate fraction times mean dispatch fraction, by E.
    me = probs.mean(0)
    ce = F.one_hot(experts, cfg.n_experts).sum(1).float().mean(0)
    aux = cfg.router_aux_coef * cfg.n_experts * (me * ce).sum()
    return gates, experts, aux


def dispatch_slots(experts: torch.Tensor, cap: int, n_experts: int
                   ) -> torch.Tensor:
    """Row of each (token, choice) in the [E * cap + 1, D] dispatch buffer
    ([k, T], choice-major): expert * cap + its place among that expert's
    assignments in choice-major order, or the spare row E * cap once the
    expert is full."""
    k_t = experts.t().reshape(-1)                       # [k*T] choice-major
    order = torch.argsort(k_t, stable=True)
    sorted_e = k_t[order]
    first = torch.searchsorted(sorted_e, sorted_e, side='left')
    place = torch.arange(k_t.numel(), device=k_t.device) - first
    rows = torch.where(place < cap, sorted_e * cap + place,
                       n_experts * cap)
    # Back from expert order to choice-major order.
    return torch.empty_like(rows).scatter_(0, order, rows).view(
        experts.shape[1], experts.shape[0])


class MoEMLP(nn.Module):
    """Top-k routed expert FFN with capacity; `forward` returns (out, the
    layer's aux loss)."""

    def __init__(self, cfg: MoEConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.dim, cfg.ffn_dim
        llama._weight(self, 'router', (e, d), cfg.param_dtype, cfg, device)
        self.gate_proj = llama._param((e, d, f), cfg.param_dtype, device)
        self.up_proj = llama._param((e, d, f), cfg.param_dtype, device)
        self.down_proj = llama._param((e, f, d), cfg.param_dtype, device)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, s, d = x.shape
        n_exp, k, dt = cfg.n_experts, cfg.experts_per_token, cfg.dtype
        t = b * s
        cap = capacity(cfg, t)
        xf = x.reshape(t, d)
        logits = F.linear(xf.float(), llama._use(self, 'router',
                                                 torch.float32))
        gates, experts, aux = route(cfg, logits)
        rows = dispatch_slots(experts, cap, n_exp)          # [k, T]
        buf = xf.new_zeros((n_exp * cap + 1, d))
        # Every kept pair owns its row; the dropped ones all land on the
        # spare row, which nothing reads.
        buf[rows.reshape(-1)] = xf.repeat(k, 1)
        h = buf[:-1].view(n_exp, cap, d).to(dt)
        gate = torch.bmm(h, self.gate_proj.to(dt))
        up = torch.bmm(h, self.up_proj.to(dt))
        out = torch.bmm(F.silu(gate) * up, self.down_proj.to(dt))
        out = torch.cat([out.reshape(n_exp * cap, d),
                         out.new_zeros((1, d))])
        keep = (rows < n_exp * cap).t()                     # [T, k]
        weight = (gates * keep).to(dt)
        picked = out[rows.t()]                              # [T, k, D]
        y = picked[:, 0] * weight[:, 0, None]
        for c in range(1, k):
            y = y + picked[:, c] * weight[:, c, None]
        return y.view(b, s, d), aux


class MoEBlock(llama.Block):
    """attention_norm, the shared attention, mlp_norm, the routed MLP."""

    def __init__(self, cfg: MoEConfig, device: torch.device):
        nn.Module.__init__(self)
        args = (cfg.dim, cfg.norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.attention_norm = llama.RMSNorm(*args)
        self.attention = llama.Attention(cfg, device)
        self.mlp_norm = llama.RMSNorm(*args)
        self.moe_mlp = MoEMLP(cfg, device)

    def _rest(self, x, out):
        x = x + self.attention.output(out)
        y, aux = self.moe_mlp(self.mlp_norm(x))
        return x + y, aux


class Mixtral(llama.Llama):
    """Decoder-only MoE transformer; normal(1.0) embeddings, untied f32
    lm_head."""
    block_cls = MoEBlock


def num_params(config: MoEConfig) -> int:
    cfg = config
    attn = cfg.dim * cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads) \
        + cfg.n_heads * cfg.head_dim * cfg.dim
    moe = cfg.n_experts * 3 * cfg.dim * cfg.ffn_dim \
        + cfg.dim * cfg.n_experts
    per_layer = attn + moe + 2 * cfg.dim
    return (cfg.vocab_size * cfg.dim * 2
            + cfg.n_layers * per_layer + cfg.dim)


def active_params(config: MoEConfig) -> int:
    """Parameters a token multiplies: the inactive experts subtracted."""
    inactive = max(0, config.n_experts - config.experts_per_token)
    return num_params(config) - config.n_layers * inactive * 3 \
        * config.dim * config.ffn_dim

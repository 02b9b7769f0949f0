"""Grouped-query attention that never broadcasts K/V to H heads.

Port of skypilot_tpu/ops/grouped_attention.py (float caches only; the
int8 helpers come with the int8 KV-cache slice).  These are the plain
versions the CUDA kernels are held against: `gather_pages` assembles a
row's pages into a contiguous view, `grouped_attention` runs the
masked softmax with the G = H/kvh query heads that share a kv head
folded into one contraction.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def grouped_attention(q: torch.Tensor, keys: torch.Tensor,
                      values: torch.Tensor, mask: Optional[torch.Tensor],
                      *, scale: float,
                      probs_dtype: torch.dtype) -> torch.Tensor:
    """Masked softmax attention with unbroadcast grouped K/V.

    q [B, H, Sq, dk], keys [B, kvh, Sk, dk], values [B, kvh, Sk, dv]
    with H % kvh == 0; mask bool broadcastable to [B, 1, Sq, Sk] (None
    = no mask).  Scores accumulate in f32; the probabilities are cast to
    `probs_dtype` before the PV product, as the reference does.
    Returns [B, Sq, H, dv] in probs_dtype.
    """
    b, h, sq, _ = q.shape
    kvh = keys.shape[1]
    if h % kvh:
        raise ValueError(
            f'query heads ({h}) not divisible by kv heads ({kvh})')
    g = h // kvh
    qg = q.float().reshape(b, kvh, g, sq, q.shape[-1])
    scores = torch.einsum('bngqd,bnkd->bngqk', qg, keys.float()) * scale
    if mask is not None:
        # [B|1, 1, Sq, Sk] -> [B|1, 1, 1, Sq, Sk]: over kv heads and group.
        scores = torch.where(mask[:, :, None], scores,
                             scores.new_tensor(NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum('bngqk,bnkd->bngqd', probs.to(probs_dtype),
                       values.to(probs_dtype))
    return out.reshape(b, h, sq, values.shape[-1]).transpose(1, 2)


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool [n_pages, kvh, ps, d] + table [B, n_read] ->
    [B, kvh, n_read * ps, d]: position j of the result is the row's
    cache slot j.  Entries a row never allocated point at the null page
    0; their content is garbage that the caller's mask hides."""
    b, n_read = table.shape
    _, kvh, ps, d = pool.shape
    g = pool[table.reshape(-1).long()].reshape(b, n_read, kvh, ps, d)
    return g.permute(0, 2, 1, 3, 4).reshape(b, kvh, n_read * ps, d)

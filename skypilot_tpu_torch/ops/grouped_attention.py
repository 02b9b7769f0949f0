"""Grouped-query attention that never broadcasts K/V to H heads.

Port of skypilot_tpu/ops/grouped_attention.py.  These are the plain
versions the CUDA kernels are held against: `gather_pages` assembles a
row's pages into a contiguous view, `grouped_attention` runs the
masked softmax with the G = H/kvh query heads that share a kv head
folded into one contraction, `quantize_int8_rows` is the int8 KV
cache's write, and `int8_grouped_attention` is its read as the two
kernels compute it (int8 cast to f32, f32 dots, scales folded in).

`quantized_grouped_attention` is the reference's other int8 read, the
one its 'xla' path takes: queries and value-scaled probabilities
quantized to int16 per row, and exact int16 x int8 dots accumulated in
int32, wrapping as XLA's int32 dot does.  The two reads differ by about
1e-3 in the logits; each is held to its own reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
_INT8_MAX = 127.0
_INT16_MAX = 32767.0
# Smallest absmax a row's scale is taken from: an all-zero row gets a
# tiny positive scale, never 0.
_SCALE_FLOOR = 1e-8


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


def quantize_int8_rows(x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 absmax quantization over the last axis:
    x [..., d] -> (q int8 [..., d], scale f32 [..., 1]), x ~= q * scale.
    Bit for bit the reference's: in f32, scale = max(absmax, 1e-8) / 127,
    q = round(x / scale) (a division, half to even), clipped to +-127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True),
                        min=_SCALE_FLOOR) / _INT8_MAX
    q = torch.clamp(torch.round(xf / scale), -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), scale


def check_int8_scales(keys: torch.Tensor, values: torch.Tensor,
                      key_scale: Optional[torch.Tensor],
                      value_scale: Optional[torch.Tensor],
                      what: str) -> bool:
    """Whether the cache is int8 (scales given); raises ValueError unless
    both scales or neither are given and, with them, K/V are int8 and
    each scale is f32 of K/V's shape with a last axis of 1."""
    if (key_scale is None) != (value_scale is None):
        raise ValueError(f'{what}: key_scale and value_scale must be '
                         'passed together (int8 cache) or not at all')
    if key_scale is None:
        return False
    if keys.dtype != torch.int8 or values.dtype != torch.int8:
        raise ValueError(f'{what}: scales need int8 K/V, got '
                         f'{keys.dtype}/{values.dtype}')
    want = tuple(keys.shape[:-1]) + (1,)
    for name, t in (('key_scale', key_scale), ('value_scale', value_scale)):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f'{what}: {name} must be float32 {want}, got '
                             f'{t.dtype} {tuple(t.shape)}')
    return True


def int8_grouped_attention(q: torch.Tensor, keys: torch.Tensor,
                           values: torch.Tensor, key_scale: torch.Tensor,
                           value_scale: torch.Tensor,
                           mask: Optional[torch.Tensor], *, scale: float,
                           probs_dtype: torch.dtype) -> torch.Tensor:
    """Masked grouped attention over an int8 cache, as the paged-decode
    and ragged-prefill kernels compute it (their quant branch).

    q [B, H, Sq, dk]; keys/values [B, kvh, Sk, d] holding int8 values
    (any dtype); key_scale/value_scale [B, kvh, Sk, 1] f32; mask as
    `grouped_attention`.  In f32: scores (q . k) * scale * key_scale,
    masked to -1e30; p = exp(score - max) and the denominator l sums
    the unscaled p; the PV product takes p * value_scale; l == 0 gives
    a zero output.  Returns [B, Sq, H, d] in probs_dtype.
    """
    b, h, sq, _ = q.shape
    kvh = keys.shape[1]
    if h % kvh:
        raise ValueError(
            f'query heads ({h}) not divisible by kv heads ({kvh})')
    g = h // kvh
    qg = q.float().reshape(b, kvh, g, sq, q.shape[-1])
    scores = torch.einsum('bngqd,bnkd->bngqk', qg, keys.float()) * scale
    scores = scores * key_scale.float()[:, :, None, None, :, 0]
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores,
                             scores.new_tensor(NEG_INF))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    pv = p * value_scale.float()[:, :, None, None, :, 0]
    out = torch.einsum('bngqk,bnkd->bngqd', pv, values.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.to(probs_dtype).reshape(b, h, sq, values.shape[-1]) \
        .transpose(1, 2)


def _quantize_int16_rows(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int16 absmax quantization over the last axis, the
    activation side of the reference's integer dots (queries, value-scaled
    probabilities): x [..., d] -> (q int16, scale f32 [..., 1]), in f32,
    scale = max(absmax, 1e-8) / 32767, q = round(x / scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True),
                        min=_SCALE_FLOOR) / _INT16_MAX
    q = torch.clamp(torch.round(xf / scale), -_INT16_MAX, _INT16_MAX)
    return q.to(torch.int16), scale


def _int_dot(equation: str, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """The exact integer einsum of int16 `a` and int8 `b`, accumulated in
    int32 with two's-complement wraparound as XLA's int32 dot does;
    returned as f32 (the reference's `.astype(float32)`).

    On the CPU the sums run in int64.  CUDA matmuls take no integer
    type, so there they run in float64, exact while every partial sum
    stays below 2^53 (4096 positions x 32767 x 127 is about 1.7e10)."""
    if a.is_cuda:
        acc = torch.einsum(equation, a.double(), b.double()).to(torch.int64)
    else:
        acc = torch.einsum(equation, a.long(), b.long())
    wrapped = torch.remainder(acc + 2 ** 31, 2 ** 32) - 2 ** 31
    return wrapped.to(torch.int32).float()


def quantized_grouped_attention(q: torch.Tensor, keys_q: torch.Tensor,
                                key_scale: torch.Tensor,
                                values_q: torch.Tensor,
                                value_scale: torch.Tensor,
                                mask: Optional[torch.Tensor], *,
                                scale: float,
                                probs_dtype: torch.dtype) -> torch.Tensor:
    """`grouped_attention` against an int8 cache as the reference's XLA
    path computes it (skypilot_tpu/ops/grouped_attention.py).

    q [B, H, Sq, dk] float; keys_q [B, kvh, Sk, dk] and values_q
    [B, kvh, Sk, dv] int8; key_scale / value_scale [B, kvh, Sk, 1] f32;
    mask as `grouped_attention`.  q is quantized to int16 per row and
    dotted exactly with the int8 keys (int32 accumulation); the score is
    that dot times q's scale, the key scale and `scale`, masked to
    -1e30, then softmax.  The probabilities times the value scale are
    quantized to int16 per row and dotted exactly with the int8 values,
    times their scale.  An int32 sum that passes 2^31 wraps, as in the
    reference: a near-uniform row over more than about 516 positions of
    int8 values near 127 does (32767 x 127 x 517 > 2^31).
    Returns [B, Sq, H, dv] in probs_dtype.  MHA, grouped and kvh == 1
    (latent) branches as in the reference.
    """
    b, h, sq, _ = q.shape
    kvh = keys_q.shape[1]
    if h % kvh:
        raise ValueError(
            f'query heads ({h}) not divisible by kv heads ({kvh})')
    dv = values_q.shape[-1]
    if kvh == h:
        qq, qs = _quantize_int16_rows(q)
        scores = _int_dot('bhqd,bhkd->bhqk', qq, keys_q)
        scores = scores * qs * key_scale[:, :, None, :, 0] * scale
        if mask is not None:
            scores = torch.where(mask, scores, scores.new_tensor(NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        pscaled = probs * value_scale[:, :, None, :, 0]
        pq, ps = _quantize_int16_rows(pscaled)
        out = _int_dot('bhqk,bhkd->bhqd', pq, values_q) * ps
    elif kvh == 1:
        qq, qs = _quantize_int16_rows(q)
        scores = _int_dot('bhqd,bkd->bhqk', qq, keys_q[:, 0])
        ks = key_scale[:, 0, :, 0][:, None, None, :]
        scores = scores * qs * ks * scale
        if mask is not None:
            scores = torch.where(mask, scores, scores.new_tensor(NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        pscaled = probs * value_scale[:, 0, :, 0][:, None, None, :]
        pq, ps = _quantize_int16_rows(pscaled)
        out = _int_dot('bhqk,bkd->bhqd', pq, values_q[:, 0]) * ps
    else:
        g = h // kvh
        qg = q.reshape(b, kvh, g, sq, q.shape[-1])
        qq, qs = _quantize_int16_rows(qg)
        scores = _int_dot('bngqd,bnkd->bngqk', qq, keys_q)
        scores = scores * qs * key_scale[:, :, None, None, :, 0] * scale
        if mask is not None:
            scores = torch.where(mask[:, :, None], scores,
                                 scores.new_tensor(NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        pscaled = probs * value_scale[:, :, None, None, :, 0]
        pq, ps = _quantize_int16_rows(pscaled)
        out = _int_dot('bngqk,bnkd->bngqd', pq, values_q) * ps
        out = out.reshape(b, h, sq, dv)
    return out.to(probs_dtype).transpose(1, 2)

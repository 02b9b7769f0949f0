"""Flash attention for training: the CUDA kernels and their plain versions.

Port of skypilot_tpu/ops/flash_attention.py.  Three kernels, as in the
reference: the forward (`csrc/flash_fwd.cu`, out and the per-row
logsumexp), and the FlashAttention-2 backward as a dq pass and a dk/dv
pass (`csrc/flash_bwd.cu`) that share the saved logsumexp and
delta = rowsum(dO * O).  Each wrapper (`flash_fwd`, `flash_bwd_dq`,
`flash_bwd_dkv`) launches its kernel on CUDA tensors and takes the
plain version (`flash_fwd_plain`, `flash_bwd_plain`) only for CPU
tensors; a CUDA tensor the kernel cannot take raises.  `flash_attention`
is the differentiable op (a torch.autograd.Function over the three).

Layout [batch, heads, seq, head_dim] ("BHSD").  K/V may carry fewer
heads than q (GQA): they are read unbroadcast, and dk/dv come back at
the kv heads.  Causal masking follows the reference's kernels: query row
r sits at position r + `offset` against kv column positions, and a
`window` keeps each query's last `window` positions.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build

NEG_INF = -1e30

# Kernel launches since each count was last set to 0 (chip_smoke.py
# reads and resets them around the training run).
fwd_launches = 0
dq_launches = 0
dkv_launches = 0

_SUPPORTED_D = (64, 128, 256)
_SUPPORTED_DTYPES = (torch.bfloat16, torch.float16)
_GEOMETRY = [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p]
# flash_fwd_launch(q, k, v, out, lse, B, H, kvh, Sq, Skv, d, causal,
#                  window, offset, scale, dtype, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + _GEOMETRY
# flash_bwd_dq_launch(q, k, v, do, lse, delta, dq, <geometry>)
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + _GEOMETRY
# flash_bwd_dkv_launch(q, k, v, do, lse, delta, dk, dv, <geometry>)
_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + _GEOMETRY


def _group_counts(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, int]:
    """(kv_heads, group) for GQA inputs; validates divisibility."""
    heads, kvh = q.shape[1], k.shape[1]
    if heads % kvh:
        raise ValueError(
            f'query heads ({heads}) not divisible by kv heads ({kvh})')
    return kvh, heads // kvh


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _causal_mask(sq: int, skv: int, offset: int, window: Optional[int],
                 device) -> torch.Tensor:
    """bool [Sq, Skv], the mask the kernels compute (the reference's
    kernels' mask): query row r at position r + offset sees columns
    c <= r + offset (and, with a window, c >= r + offset - window + 1)."""
    rows = offset + torch.arange(sq, device=device)[:, None]
    cols = torch.arange(skv, device=device)[None, :]
    keep = rows >= cols
    if window is not None:
        keep &= cols >= rows - window + 1
    return keep


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool, window: Optional[int] = None,
                    offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) with the reference's semantics (`_mha_fwd_xla`): GQA
    contracted grouped, masked scores at -1e30, an l == 0 guard; out in
    q's dtype, lse [B, H, Sq] f32."""
    b, h, sq, d = q.shape
    kvh, g = _group_counts(q, k)
    qg = q.float().reshape(b, kvh, g, sq, d)
    s = torch.einsum('bngqd,bnkd->bngqk', qg, k.float()) * scale
    if causal:
        mask = _causal_mask(sq, k.shape[2], offset, window, q.device)
        s = torch.where(mask, s, s.new_tensor(NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum('bngqk,bnkd->bngqd', p / l_safe, v.float())
    out = out.to(q.dtype).reshape(b, h, sq, v.shape[-1])
    lse = (m + torch.log(l_safe))[..., 0].reshape(b, h, sq)
    return out, lse


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    *, scale: float, causal: bool,
                    window: Optional[int] = None, offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 (dq, dk, dv) from the saved lse and delta = rowsum(dO * O),
    the reference's FlashAttention-2 recompute (`_bwd_block_math`,
    `_flash_bwd_xla`) over whole rows: P = exp(S - lse),
    dS = P * (dO V^T - delta) * scale.  dk/dv sum over the G query heads
    of each kv head and come back at [B, kvh, Skv, d]."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    kvh, g = _group_counts(q, k)
    qg = q.float().reshape(b, kvh, g, sq, d)
    dog = do.float().reshape(b, kvh, g, sq, do.shape[-1])
    kf = k.float()
    vf = v.float()
    s = torch.einsum('bngqd,bnkd->bngqk', qg, kf) * scale
    if causal:
        keep = _causal_mask(sq, skv, offset, window, q.device)
        s = torch.where(keep, s, s.new_tensor(NEG_INF))
    p = torch.exp(s - lse.float().reshape(b, kvh, g, sq, 1))
    dp = torch.einsum('bngqd,bnkd->bngqk', dog, vf)
    ds = p * (dp - delta.float().reshape(b, kvh, g, sq, 1)) * scale
    dq = torch.einsum('bngqk,bnkd->bngqd', ds, kf).reshape(b, h, sq, d)
    dk = torch.einsum('bngqk,bngqd->bnkd', ds, qg)
    dv = torch.einsum('bngqk,bngqd->bnkd', p, dog)
    return dq, dk, dv


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None, causal: bool = True,
                  window: Optional[int] = None,
                  offset: int = 0) -> torch.Tensor:
    """Plain softmax attention (the reference's `mha_reference`),
    differentiable through torch.autograd; GQA contracted grouped."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    b, h, sq, d = q.shape
    kvh, g = _group_counts(q, k)
    qg = q.float().reshape(b, kvh, g, sq, d)
    s = torch.einsum('bngqd,bnkd->bngqk', qg, k.float()) * scale
    if causal:
        mask = _causal_mask(sq, k.shape[2], offset, window, q.device)
        s = torch.where(mask, s, s.new_tensor(NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum('bngqk,bnkd->bngqd', p, v.float())
    return out.reshape(b, h, sq, v.shape[-1]).to(q.dtype)


_UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
# One f32 operation, with headroom for tensor-core accumulation that does
# not round to nearest.
_U32 = 2.0 ** -23


def rounding_bounds(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    *, scale: float, causal: bool,
                    window: Optional[int] = None,
                    offset: int = 0) -> dict:
    """Per-element bounds on |kernel - plain| for the 16-bit kernels,
    the plain versions run at f32 on the same values (same lse and delta
    for the backward).  Keys 'out', 'lse', 'dq', 'dk', 'dv'.

    With u the unit roundoff of q's type, g(n) = n * 2^-23 for an n-term
    f32 sum, per query row r:
      ds_r = g(d) scale |q_r| max_j |k_j|      bound on a score's error
                                               (Cauchy-Schwarz)
      lse   ds_r + g(Skv) + 2^-22 |lse_r|
      out   u |out| + (u + 2 ds_r + 2 g(Skv)) A_r,   A = P |V|
            (out rounded once; P rounded for the PV product; P and l off
            by the score error; the f32 sums)
      dq    c_r (|dS| |K|)_r + e_r (P |K|)_r
      dk    sum over r of the group: (c_r |dS_r|)^T |Q| + (e_r P_r)^T |Q|
      dv    sum over r of the group: ((u + ds_r + g(G Sq) + 4 2^-23) P_r)^T
            |dO|
    where c_r = u + ds_r + g(n) + 4 * 2^-23 (dS rounded to the input type
    for its product, P off by the score error, n-term f32 sums) and
    e_r = scale g(d) |dO_r| max_j |v_j| (the error of dP = dO v in f32).
    Computed in f32 on q's device."""
    u = _UNIT_ROUNDOFF[q.dtype]
    b, h, sq, d = q.shape
    skv = k.shape[2]
    kvh, g = _group_counts(q, k)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    out, lse_p = flash_fwd_plain(qf, kf, vf, scale=scale, causal=causal,
                                 window=window, offset=offset)
    attn_abs = flash_fwd_plain(qf, kf, vf.abs(), scale=scale, causal=causal,
                               window=window, offset=offset)[0]
    kmax = kf.norm(dim=-1).amax(-1)                       # [B, kvh]
    vmax = vf.norm(dim=-1).amax(-1)
    kmax = kmax.repeat_interleave(g, dim=1)[..., None]    # [B, H, 1]
    vmax = vmax.repeat_interleave(g, dim=1)[..., None]
    ds_err = d * _U32 * scale * qf.norm(dim=-1) * kmax    # [B, H, Sq]
    bounds = {
        'lse': ds_err + skv * _U32 + 2 * _U32 * lse_p.abs(),
        'out': u * out.abs() + (u + 2 * ds_err[..., None]
                                + 2 * skv * _U32) * attn_abs,
    }
    del out, attn_abs
    qg = qf.reshape(b, kvh, g, sq, d)
    dog = dof.reshape(b, kvh, g, sq, d)
    s = torch.einsum('bngqd,bnkd->bngqk', qg, kf) * scale
    if causal:
        keep = _causal_mask(sq, skv, offset, window, q.device)
        s = torch.where(keep, s, s.new_tensor(NEG_INF))
    p = torch.exp(s - lse.float().reshape(b, kvh, g, sq, 1))
    del s
    dp = torch.einsum('bngqd,bnkd->bngqk', dog, vf)
    ds_abs = (p * (dp - delta.float().reshape(b, kvh, g, sq, 1))).abs_()
    ds_abs *= scale
    del dp
    rows5 = lambda x: x.reshape(b, kvh, g, sq, 1)
    c_q = rows5(u + ds_err + skv * _U32 + 4 * _U32)
    c_k = rows5(u + ds_err + g * sq * _U32 + 4 * _U32)
    e = rows5(scale * d * _U32 * dof.norm(dim=-1) * vmax)
    kabs, qabs, doabs = kf.abs(), qg.abs(), dog.abs()
    bounds['dq'] = (c_q * torch.einsum('bngqk,bnkd->bngqd', ds_abs, kabs)
                    + e * torch.einsum('bngqk,bnkd->bngqd', p, kabs)
                    ).reshape(b, h, sq, d)
    bounds['dk'] = (torch.einsum('bngqk,bngqd->bnkd', c_k * ds_abs, qabs)
                    + torch.einsum('bngqk,bngqd->bnkd', e * p, qabs))
    bounds['dv'] = torch.einsum('bngqk,bngqd->bnkd', c_k * p, doabs)
    return bounds


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _check_geometry(q, k, v, *, causal, window, offset):
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f'bad geometry q {tuple(q.shape)}, k '
                         f'{tuple(k.shape)}, v {tuple(v.shape)}')
    _group_counts(q, k)
    if window is not None and not causal:
        raise ValueError('window requires causal=True')
    if offset < 0:
        raise ValueError(f'offset must be >= 0, got {offset}')
    if causal and q.shape[2] != k.shape[2]:
        # The reference's kernel aligns the causal diagonal top-left and
        # its XLA forward bottom-right; they agree only here.
        raise ValueError(f'causal attention needs seq_q == seq_kv, got '
                         f'{q.shape[2]} and {k.shape[2]}')


def _check_cuda(what: str, tensors, q: torch.Tensor) -> None:
    for name, t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} must be on q's CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{what}: {name} must be contiguous and '
                             '16-byte aligned')
    d = q.shape[3]
    if d not in _SUPPORTED_D:
        raise ValueError(f'{what} kernel takes head_dim in {_SUPPORTED_D}, '
                         f'got {d}')
    if q.dtype not in _SUPPORTED_DTYPES:
        raise ValueError(f'{what} kernel runs on the tensor cores and takes '
                         f'bfloat16 or float16, got {q.dtype}')


def _geometry(q, k, *, causal, window, offset, scale):
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    return (b, h, kvh, sq, skv, d, int(causal),
            0 if window is None else int(window), int(offset), float(scale),
            _build.dtype_code(q.dtype),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool, window: Optional[int] = None,
              offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, Sq, d] in q's dtype, lse [B, H, Sq] f32).

    q [B, H, Sq, d], k/v [B, kvh, Skv, d].  On CUDA the kernel takes
    bfloat16 or float16 (one dtype for q, k and v), head_dim 64, 128 or
    256, contiguous tensors."""
    global fwd_launches
    _check_geometry(q, k, v, causal=causal, window=window, offset=offset)
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, scale=scale, causal=causal,
                               window=window, offset=offset)
    _check_cuda('flash_fwd', (('q', q), ('k', k), ('v', v)), q)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f'flash_fwd kernel needs one dtype, got '
                         f'{q.dtype}/{k.dtype}/{v.dtype}')
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.launcher('flash_fwd', _FWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), *_geometry(q, k, causal=causal, window=window,
                                        offset=offset, scale=scale))
    _build.check(err, 'flash_fwd_launch')
    fwd_launches += 1
    return out, lse


def _check_bwd(what, q, k, v, do, lse, delta, *, causal, window, offset):
    _check_geometry(q, k, v, causal=causal, window=window, offset=offset)
    b, h, sq, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f'{what}: do {tuple(do.shape)} must match q '
                         f'{tuple(q.shape)}')
    for name, t in (('lse', lse), ('delta', delta)):
        if tuple(t.shape) != (b, h, sq):
            raise ValueError(f'{what}: {name} must be [{b}, {h}, {sq}], got '
                             f'{tuple(t.shape)}')
    if not q.is_cuda:
        return False
    _check_cuda(what, (('q', q), ('k', k), ('v', v), ('do', do),
                       ('lse', lse), ('delta', delta)), q)
    if not q.dtype == k.dtype == v.dtype == do.dtype:
        raise ValueError(f'{what} kernel needs one dtype for q, k, v and '
                         f'do, got {q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}')
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f'{what}: lse and delta must be float32')
    return True


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 *, scale: float, causal: bool, window: Optional[int] = None,
                 offset: int = 0) -> torch.Tensor:
    """dq [B, H, Sq, d] f32 (the FlashAttention-2 dq pass)."""
    global dq_launches
    kw = dict(causal=causal, window=window, offset=offset)
    if not _check_bwd('flash_bwd_dq', q, k, v, do, lse, delta, **kw):
        return flash_bwd_plain(q, k, v, do, lse, delta, scale=scale, **kw)[0]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    fn = _build.launcher('flash_bwd', _DQ_ARGTYPES,
                         symbol='flash_bwd_dq_launch')
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             *_geometry(q, k, scale=scale, **kw))
    _build.check(err, 'flash_bwd_dq_launch')
    dq_launches += 1
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  *, scale: float, causal: bool,
                  window: Optional[int] = None, offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, kvh, Skv, d] f32, each summed over the G query heads
    of its kv head inside the kernel (deterministic, no atomics)."""
    global dkv_launches
    kw = dict(causal=causal, window=window, offset=offset)
    if not _check_bwd('flash_bwd_dkv', q, k, v, do, lse, delta, **kw):
        return flash_bwd_plain(q, k, v, do, lse, delta, scale=scale,
                               **kw)[1:]
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    fn = _build.launcher('flash_bwd', _DKV_ARGTYPES,
                         symbol='flash_bwd_dkv_launch')
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_geometry(q, k, scale=scale, **kw))
    _build.check(err, 'flash_bwd_dkv_launch')
    dkv_launches += 1
    return dk, dv


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------
def _normalize_window(window: Optional[int], causal: bool, sq: int,
                      skv: int) -> Optional[int]:
    """The reference's `_fwd_impl` rules: a window needs causal and
    seq_q == seq_kv, and a window covering the sequence is none."""
    if window is None:
        return None
    if not causal:
        raise ValueError('window requires causal=True')
    if sq != skv:
        raise ValueError(f'window requires seq_q == seq_kv ({sq} vs {skv}).')
    return None if window >= sq else window


class FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse), as the reference's `_vjp_fwd`;
    backward runs the dq pass, then the dk/dv pass.  `plain` runs the
    plain versions on any device (the kernels' oracle on the card)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, plain):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        fwd = flash_fwd_plain if plain else flash_fwd
        out, lse = fwd(q, k, v, scale=scale, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, window, plain)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, window, plain = ctx.args
        do = do.contiguous()
        # Plain torch, as the reference computes it outside its kernels.
        delta = (do.float() * out.float()).sum(-1)
        kw = dict(scale=scale, causal=causal, window=window)
        if plain:
            dq, dk, dv = flash_bwd_plain(q, k, v, do, lse, delta, **kw)
        else:
            dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, causal: bool = True,
                    window: Optional[int] = None, *,
                    plain: bool = False) -> torch.Tensor:
    """Differentiable flash attention over [B, H, S, d] inputs, k/v at
    kvh heads dividing H.  `window`: each query attends to its last
    `window` positions (causal, seq_q == seq_kv).  On CUDA tensors the
    kernels run unless `plain`; on CPU tensors the plain versions."""
    window = _normalize_window(window, causal, q.shape[2], k.shape[2])
    _check_geometry(q, k, v, causal=causal, window=window, offset=0)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, float(scale), bool(causal), window,
                                bool(plain))

"""Ragged chunked-prefill attention: the CUDA kernel and its plain version.

Port of skypilot_tpu/ops/ragged_prefill.py (single shard,
`_ragged_prefill_impl`), float caches and int8 caches with f32 scale
caches (the kernel's `quant` branch).  `ragged_prefill_attention`
launches `csrc/ragged_prefill.cu` on CUDA tensors and takes the plain
version (`ragged_prefill_attention_plain`: walk the table's pages of
the cache, build the causal/window/kv_mask mask, then
`grouped_attention`, or `int8_grouped_attention` with scales) only for
CPU tensors.  There is no fallback from
one to the other: a CUDA tensor the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import grouped_attention as ga

# Kernel launches since the count was last set to 0, float caches and
# int8 caches apart (chip_smoke.py reads and resets them around each
# serving run).
launches = 0
launches_int8 = 0

_SUPPORTED_D = (64, 128, 256)
_SUPPORTED_DTYPES = (torch.bfloat16, torch.float16)
# The kernel holds a row's page table in shared memory.
_MAX_PAGES = 4096
# ragged_prefill_launch(pointers..., ints..., scale, dtype code, stream).
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# ragged_prefill_int8_launch: the same with the two scale caches after
# the caches.
_ARGTYPES_INT8 = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _base_rows(base: Union[int, torch.Tensor], b: int,
               device: torch.device) -> torch.Tensor:
    """int or [B]/scalar tensor -> int32 [B] on `device`."""
    base = torch.as_tensor(base, dtype=torch.int32, device=device)
    return base.reshape(-1).expand(b).contiguous()


def ragged_prefill_attention_plain(q: torch.Tensor, keys: torch.Tensor,
                                   values: torch.Tensor,
                                   table: torch.Tensor,
                                   base: Union[int, torch.Tensor],
                                   kv_mask: torch.Tensor, *, scale: float,
                                   probs_dtype: torch.dtype, page_size: int,
                                   window: Optional[int] = None,
                                   key_scale: Optional[torch.Tensor] = None,
                                   value_scale: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """The kernel's function in plain PyTorch.  Shapes as
    `ragged_prefill_attention`."""
    b, _, s, _ = q.shape
    _, kvh, max_len, d = keys.shape
    ps = page_size
    n_read = table.shape[1]
    base = _base_rows(base, b, q.device)
    # Cache positions of the walk: page j covers table[b, j]*ps + [0, ps).
    pos = (table.long()[:, :, None] * ps
           + torch.arange(ps, device=q.device)).reshape(b, n_read * ps)
    idx = pos[:, None, :, None].expand(b, kvh, n_read * ps, d)
    k = torch.gather(keys, 2, idx)
    v = torch.gather(values, 2, idx)
    if key_scale is not None:
        sidx = idx[..., :1]
        key_scale = torch.gather(key_scale, 2, sidx)
        value_scale = torch.gather(value_scale, 2, sidx)
    qpos = base.long()[:, None] + torch.arange(s, device=q.device)
    keep = pos[:, None, :] <= qpos[:, :, None]          # [B, S, n_read*ps]
    if window is not None:
        keep &= pos[:, None, :] >= qpos[:, :, None] - window + 1
    keep &= torch.gather(kv_mask, 1, pos)[:, None, :]
    if key_scale is None:
        return ga.grouped_attention(q, k, v, keep[:, None], scale=scale,
                                    probs_dtype=probs_dtype)
    return ga.int8_grouped_attention(q, k, v, key_scale, value_scale,
                                     keep[:, None], scale=scale,
                                     probs_dtype=probs_dtype)


def ragged_prefill_attention(q: torch.Tensor, keys: torch.Tensor,
                             values: torch.Tensor, table: torch.Tensor,
                             base: Union[int, torch.Tensor],
                             kv_mask: torch.Tensor, *, scale: float,
                             probs_dtype: torch.dtype, page_size: int,
                             window: Optional[int] = None,
                             key_scale: Optional[torch.Tensor] = None,
                             value_scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """One prefill chunk's attention over the contiguous cache.

    q:        [B, H, S, d] chunk queries; query i sits at cache position
              base + i.
    keys /
    values:   [B, kvh, L, d] contiguous cache, L % page_size == 0.
    table:    [B, n_read] int32 logical-page walk (identity for the
              contiguous prefill cache).
    base:     int or [B] int32 cache-cursor base of each row.
    kv_mask:  bool [B, L] validity of each cache position.
    key_scale /
    value_scale: [B, kvh, L, 1] f32 absmax scales of an int8 cache (both
              or neither).

    Returns [B, S, H, d] in probs_dtype.  On CUDA the kernel takes
    bfloat16 or float16 (one dtype for q, a float cache and
    probs_dtype; an int8 cache with q of either).
    """
    b, h, s, d = q.shape
    _, kvh, max_len, dk = keys.shape
    ps = page_size
    if ps <= 0 or max_len % ps:
        raise ValueError(f'cache length ({max_len}) must be a positive '
                         f'multiple of page_size ({ps})')
    if h % kvh or dk != d:
        raise ValueError(f'bad geometry q {tuple(q.shape)}, cache '
                         f'{tuple(keys.shape)}')
    if table.shape[1] * ps > max_len:
        raise ValueError(f'table walks {table.shape[1]} pages of {ps} '
                         f'positions, beyond the cache length ({max_len})')
    quant = ga.check_int8_scales(keys, values, key_scale, value_scale,
                                 'ragged_prefill_attention')
    if not q.is_cuda:
        return ragged_prefill_attention_plain(
            q, keys, values, table, base, kv_mask, scale=scale,
            probs_dtype=probs_dtype, page_size=ps, window=window,
            key_scale=key_scale, value_scale=value_scale)
    return _launch(q, keys, values, table, base, kv_mask, scale=scale,
                   probs_dtype=probs_dtype, page_size=ps, window=window,
                   scales=(key_scale, value_scale) if quant else None)


def _launch(q, keys, values, table, base, kv_mask, *, scale, probs_dtype,
            page_size, window, scales):
    global launches, launches_int8
    b, h, s, d = q.shape
    _, kvh, max_len, _ = keys.shape
    ps = page_size
    n_read = table.shape[1]
    base = _base_rows(base, b, q.device)
    tensors = (q, keys, values, table, kv_mask) + (scales or ())
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError('ragged_prefill_attention: every tensor must be '
                         "on q's CUDA device")
    if d not in _SUPPORTED_D or 64 % ps:
        raise ValueError(f'ragged_prefill_attention kernel takes head_dim '
                         f'in {_SUPPORTED_D} and a page_size dividing 64, '
                         f'got {d} and {ps}')
    if n_read > _MAX_PAGES:
        raise ValueError(f'ragged_prefill_attention kernel walks at most '
                         f'{_MAX_PAGES} pages, got {n_read}')
    cache_dtype = q.dtype if scales is None else torch.int8
    if not (q.dtype == probs_dtype and keys.dtype == cache_dtype
            and values.dtype == cache_dtype):
        raise ValueError('ragged_prefill_attention kernel needs q, cache '
                         'and probs_dtype of one dtype (an int8 cache with '
                         f'scales), got {q.dtype}/{keys.dtype}/'
                         f'{probs_dtype}')
    if q.dtype not in _SUPPORTED_DTYPES:
        raise ValueError(f'ragged_prefill_attention kernel runs on the '
                         f'tensor cores and takes bfloat16 or float16, got '
                         f'{q.dtype}')
    if table.dtype != torch.int32 or table.shape[0] != b:
        raise ValueError(f'table must be int32 [B, n_read], got '
                         f'{table.dtype} {tuple(table.shape)}')
    if kv_mask.dtype != torch.bool or tuple(kv_mask.shape) != (b, max_len):
        raise ValueError(f'kv_mask must be bool [{b}, {max_len}], got '
                         f'{kv_mask.dtype} {tuple(kv_mask.shape)}')
    named = [('q', q), ('keys', keys), ('values', values),
             ('table', table), ('kv_mask', kv_mask)]
    if scales is not None:
        named += [('key_scale', scales[0]), ('value_scale', scales[1])]
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f'ragged_prefill_attention: {name} must be '
                             'contiguous')
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (table.data_ptr(), base.data_ptr(), kv_mask.data_ptr(),
            out.data_ptr(), b, h, s, d, kvh, max_len, n_read, ps,
            0 if window is None else int(window), float(scale),
            _build.dtype_code(q.dtype), stream)
    if scales is None:
        fn = _build.launcher('ragged_prefill', _ARGTYPES)
        err = fn(q.data_ptr(), keys.data_ptr(), values.data_ptr(), *tail)
        _build.check(err, 'ragged_prefill_launch')
        launches += 1
    else:
        fn = _build.launcher('ragged_prefill', _ARGTYPES_INT8,
                             'ragged_prefill_int8_launch')
        err = fn(q.data_ptr(), keys.data_ptr(), values.data_ptr(),
                 scales[0].data_ptr(), scales[1].data_ptr(), *tail)
        _build.check(err, 'ragged_prefill_int8_launch')
        launches_int8 += 1
    return out

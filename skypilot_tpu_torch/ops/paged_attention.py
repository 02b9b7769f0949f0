"""Paged decode attention: the CUDA kernel and its plain version.

Port of skypilot_tpu/ops/paged_attention.py (single shard,
`_paged_decode_attention_impl`; float pools).  `paged_decode_attention`
launches `csrc/paged_decode.cu` on CUDA tensors and takes the plain
version (`paged_decode_attention_plain`: gather the pages, then
`grouped_attention`) only for CPU tensors.  There is no fallback from
one to the other: a CUDA tensor the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes

import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import grouped_attention as ga

# Kernel launches since the count was last set to 0 (chip_smoke.py reads
# and resets it around the serving run).
launches = 0

_SUPPORTED_D = (64, 128)
_SUPPORTED_PS = (8, 16, 32)
# paged_decode_launch(pointers..., ints..., scale, dtype code, stream).
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def paged_decode_attention_plain(q: torch.Tensor, page_key: torch.Tensor,
                                 page_value: torch.Tensor,
                                 table: torch.Tensor, mask: torch.Tensor,
                                 *, scale: float,
                                 probs_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather, then grouped
    attention.  Shapes as `paged_decode_attention`."""
    keys = ga.gather_pages(page_key, table)
    values = ga.gather_pages(page_value, table)
    return ga.grouped_attention(q, keys, values, mask, scale=scale,
                                probs_dtype=probs_dtype)


def paged_decode_attention(q: torch.Tensor, page_key: torch.Tensor,
                           page_value: torch.Tensor, table: torch.Tensor,
                           mask: torch.Tensor, *, scale: float,
                           probs_dtype: torch.dtype) -> torch.Tensor:
    """Decode attention straight from the paged KV pools.

    q:          [B, H, S, d] queries (S = 1 decode).
    page_key /
    page_value: [n_pages, kvh, page_size, d] pools; page 0 is the null
                page that unallocated table entries point at.
    table:      [B, n_read] int32 block table under the read window.
    mask:       bool [B, 1, S|1, n_read * page_size] visibility.

    Returns [B, S, H, d] in probs_dtype.
    """
    if not q.is_cuda:
        return paged_decode_attention_plain(
            q, page_key, page_value, table, mask, scale=scale,
            probs_dtype=probs_dtype)
    return _launch(q, page_key, page_value, table, mask, scale=scale,
                   probs_dtype=probs_dtype)


def _launch(q, page_key, page_value, table, mask, *, scale, probs_dtype):
    global launches
    b, h, s, d = q.shape
    n_pages, kvh, ps, dp = page_key.shape
    n_read = table.shape[1]
    read_len = n_read * ps
    tensors = (q, page_key, page_value, table, mask)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError('paged_decode_attention: every tensor must be on '
                         "q's CUDA device")
    if h % kvh or dp != d or page_value.shape != page_key.shape:
        raise ValueError(
            f'paged_decode_attention: bad geometry q {tuple(q.shape)}, '
            f'pools {tuple(page_key.shape)}/{tuple(page_value.shape)}')
    if d not in _SUPPORTED_D or ps not in _SUPPORTED_PS:
        raise ValueError(f'paged_decode_attention kernel takes head_dim '
                         f'in {_SUPPORTED_D} and page_size in '
                         f'{_SUPPORTED_PS}, got {d} and {ps}')
    if not (q.dtype == page_key.dtype == page_value.dtype == probs_dtype):
        raise ValueError('paged_decode_attention kernel needs q, pools and '
                         'probs_dtype of one dtype, got '
                         f'{q.dtype}/{page_key.dtype}/{probs_dtype}')
    if table.dtype != torch.int32 or table.shape[0] != b:
        raise ValueError(f'table must be int32 [B, n_read], got '
                         f'{table.dtype} {tuple(table.shape)}')
    if mask.dtype != torch.bool or mask.dim() != 4 \
            or mask.shape[-1] != read_len:
        raise ValueError(f'mask must be bool [B, 1, S|1, {read_len}], '
                         f'got {mask.dtype} {tuple(mask.shape)}')
    for name, t in (('q', q), ('page_key', page_key),
                    ('page_value', page_value), ('table', table)):
        if not t.is_contiguous():
            raise ValueError(f'paged_decode_attention: {name} must be '
                             'contiguous')
    mask3 = mask[:, 0].expand(b, s, read_len).contiguous()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    fn = _build.launcher('paged_decode', _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), page_key.data_ptr(), page_value.data_ptr(),
             table.data_ptr(), mask3.data_ptr(), out.data_ptr(), b, h, s, d,
             kvh, ps, n_read, float(scale), _build.dtype_code(q.dtype),
             stream)
    _build.check(err, 'paged_decode_launch')
    launches += 1
    return out

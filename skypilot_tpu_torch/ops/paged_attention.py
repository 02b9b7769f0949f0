"""Paged decode attention: the CUDA kernel and its plain version.

Port of skypilot_tpu/ops/paged_attention.py (single shard,
`_paged_decode_attention_impl`), float pools and int8 pools with f32
scale pools (the kernel's `quant` branch).  `paged_decode_attention`
launches `csrc/paged_decode.cu` on CUDA tensors and takes the plain
version (`paged_decode_attention_plain`: gather the pages, then
`grouped_attention`, or `int8_grouped_attention` with scales) only for
CPU tensors.  There is no fallback from one to the other: a CUDA tensor
the kernel cannot take raises.

The kernel splits each row's page walk into chunks (`decode_split`
picks their length), one block a (row, kv head, chunk), and the last
block of a (row, kv head) merges the chunks' partial softmaxes.  Its
scratch (the partials, and one counter a (row, kv head) that the merging
block resets to 0) is kept per device and stream (`_workspace`), so a
call allocates and clears nothing beyond its output.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import grouped_attention as ga

# Kernel launches since the count was last set to 0, float pools and
# int8 pools apart (chip_smoke.py reads and resets them around each
# serving run), and the same split by the queries a row, S (1: decode;
# k + 1: a speculative verify; the mixed step's query width).  A CUDA
# graph's replay adds the launches captured in it (`add_launches`).
launches = 0
launches_int8 = 0
launches_by_s: Dict[int, int] = {}
launches_int8_by_s: Dict[int, int] = {}

_SUPPORTED_D = (64, 128, 256)
_SUPPORTED_PS = (8, 16, 32)
# paged_decode_launch(pointers..., ints..., scale, dtype code, stream,
# workspace, counters, chunk pages).
_SPLIT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p] + _SPLIT_ARGS)
# paged_decode_int8_launch: the same with the two scale pools after the
# pools.
_ARGTYPES_INT8 = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                  + _SPLIT_ARGS)

# The kernel's blocks: 4 query rows each (`kRows` in csrc/paged_decode.cu),
# a chunk of at most SPLIT_POSITIONS positions of one row's walk: of
# 128-1024, 512 was about the fastest at chip_smoke.py's decode shape on
# an NVIDIA H100 80GB HBM3 at 700 W (scripts/decode_compare.py --chunks;
# PERF.md section 6).
ROWS_PER_BLOCK = 4
SPLIT_POSITIONS = 512
H100_SMS = 132


def decode_split(n_read: int, page_size: int, units: int,
                 sms: int = H100_SMS) -> Tuple[int, int]:
    """(pages a chunk, chunks a row) for the kernel's split page walk.

    `units` = B * kvh * row groups of ROWS_PER_BLOCK query rows: the
    blocks a chunk count multiplies.  A chunk holds at most
    SPLIT_POSITIONS positions (so that one long row does not set the
    kernel's time) and at least one page; within that, chunks are made
    short enough for the grid to hold two blocks an SM where one page a
    chunk would.  Every chunk holds at least one page of the walk (the
    last one the rest); an empty walk is one empty chunk."""
    if n_read <= 0:
        return 1, 1
    cap = max(1, SPLIT_POSITIONS // page_size)
    want = -(-2 * sms // max(1, units))
    chunk = max(1, min(cap, n_read // want))
    return chunk, -(-n_read // chunk)


# The kernel's scratch a (device, stream): [f32 partials, int32 merge
# counters], the counters all 0 between launches (each launch's merging
# blocks reset theirs).  Grown, never shrunk; the counters' first
# allocation holds 4096, so their address stays fixed at serving sizes.
_scratch: Dict[Tuple[torch.device, int], List[torch.Tensor]] = {}


def _workspace(device, stream: int, n_work: int,
               n_counters: int) -> List[torch.Tensor]:
    ws = _scratch.setdefault((device, stream), [None, None])
    if ws[0] is None or ws[0].numel() < n_work:
        ws[0] = torch.empty(max(n_work, 1), dtype=torch.float32,
                            device=device)
    if ws[1] is None or ws[1].numel() < n_counters:
        ws[1] = torch.zeros(max(n_counters, 4096), dtype=torch.int32,
                            device=device)
    return ws


def scratch(device, stream: int) -> List[torch.Tensor]:
    """The kernel's scratch tensors on (device, stream), as a CUDA graph
    captured on that stream holds them (kept alive beside the graph, so
    that growing the scratch never frees memory a graph still writes)."""
    return [t for t in _scratch.get((device, stream), ()) if t is not None]


def launches_by_branch() -> Dict[str, Dict[int, int]]:
    """A copy of the launch counts by S: {'float': ..., 'int8': ...}."""
    return {'float': dict(launches_by_s), 'int8': dict(launches_int8_by_s)}


def add_launches(counts: Dict[str, Dict[int, int]]) -> None:
    """Add launches made outside `_launch`, by branch and S (as
    `launches_by_branch` gives them): a CUDA graph's replay of the
    launches captured in it, or, negative, the capture's own calls of
    the wrapper, which launch nothing (infer/graphs.py)."""
    global launches, launches_int8
    for s, n in counts.get('float', {}).items():
        launches += n
        launches_by_s[s] = launches_by_s.get(s, 0) + n
    for s, n in counts.get('int8', {}).items():
        launches_int8 += n
        launches_int8_by_s[s] = launches_int8_by_s.get(s, 0) + n


def paged_decode_attention_plain(q: torch.Tensor, page_key: torch.Tensor,
                                 page_value: torch.Tensor,
                                 table: torch.Tensor, mask: torch.Tensor,
                                 *, scale: float, probs_dtype: torch.dtype,
                                 key_scale: Optional[torch.Tensor] = None,
                                 value_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather the pages (and the
    scale pages), then grouped attention.  Shapes as
    `paged_decode_attention`."""
    keys = ga.gather_pages(page_key, table)
    values = ga.gather_pages(page_value, table)
    if key_scale is None:
        return ga.grouped_attention(q, keys, values, mask, scale=scale,
                                    probs_dtype=probs_dtype)
    return ga.int8_grouped_attention(
        q, keys, values, ga.gather_pages(key_scale, table),
        ga.gather_pages(value_scale, table), mask, scale=scale,
        probs_dtype=probs_dtype)


def paged_decode_attention(q: torch.Tensor, page_key: torch.Tensor,
                           page_value: torch.Tensor, table: torch.Tensor,
                           mask: torch.Tensor, *, scale: float,
                           probs_dtype: torch.dtype,
                           key_scale: Optional[torch.Tensor] = None,
                           value_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Decode attention straight from the paged KV pools.

    q:          [B, H, S, d] queries: S = 1 a decode step, S > 1 a
                speculative verify window or a mixed prefill/decode step
                (query s of a row sees what `mask[:, 0, s]` reveals).
    page_key /
    page_value: [n_pages, kvh, page_size, d] pools; page 0 is the null
                page that unallocated table entries point at.
    table:      [B, n_read] int32 block table under the read window.
    mask:       bool [B, 1, S|1, n_read * page_size] visibility.
    key_scale /
    value_scale: [n_pages, kvh, page_size, 1] f32 absmax scale pools of
                int8 pools (both or neither).

    Returns [B, S, H, d] in probs_dtype.
    """
    quant = ga.check_int8_scales(page_key, page_value, key_scale,
                                 value_scale, 'paged_decode_attention')
    if not q.is_cuda:
        return paged_decode_attention_plain(
            q, page_key, page_value, table, mask, scale=scale,
            probs_dtype=probs_dtype, key_scale=key_scale,
            value_scale=value_scale)
    return _launch(q, page_key, page_value, table, mask, scale=scale,
                   probs_dtype=probs_dtype,
                   scales=(key_scale, value_scale) if quant else None)


def _launch(q, page_key, page_value, table, mask, *, scale, probs_dtype,
            scales, chunk_pages: Optional[int] = None):
    """Launch the kernel; `chunk_pages` overrides `decode_split`'s chunk
    (the card tests use it to reach other splits)."""
    global launches, launches_int8
    b, h, s, d = q.shape
    n_pages, kvh, ps, dp = page_key.shape
    n_read = table.shape[1]
    read_len = n_read * ps
    tensors = (q, page_key, page_value, table, mask) + (scales or ())
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
    pool_dtype = q.dtype if scales is None else torch.int8
    if not (q.dtype == probs_dtype and page_key.dtype == pool_dtype
            and page_value.dtype == pool_dtype):
        raise ValueError('paged_decode_attention kernel needs q, pools and '
                         'probs_dtype of one dtype (int8 pools with '
                         'scales), got '
                         f'{q.dtype}/{page_key.dtype}/{probs_dtype}')
    if table.dtype != torch.int32 or table.shape[0] != b:
        raise ValueError(f'table must be int32 [B, n_read], got '
                         f'{table.dtype} {tuple(table.shape)}')
    if mask.dtype != torch.bool or mask.dim() != 4 \
            or mask.shape[-1] != read_len:
        raise ValueError(f'mask must be bool [B, 1, S|1, {read_len}], '
                         f'got {mask.dtype} {tuple(mask.shape)}')
    named = [('q', q), ('page_key', page_key), ('page_value', page_value),
             ('table', table)]
    if scales is not None:
        named += [('key_scale', scales[0]), ('value_scale', scales[1])]
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f'paged_decode_attention: {name} must be '
                             'contiguous')
    # A view of the serving path's contiguous [B, 1, S, read_len] mask,
    # built once a forward (models/llama.py `_slot_mask`); a copy only
    # for a broadcast S.
    mask3 = mask[:, 0].expand(b, s, read_len).contiguous()
    if mask3.data_ptr() % 8:   # the kernel reads mask rows 8 bytes a load
        mask3 = mask3.clone()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    units = b * kvh * -(-(h // kvh * s) // ROWS_PER_BLOCK)
    if chunk_pages is None:
        chunk, n_split = decode_split(
            n_read, ps, units,
            torch.cuda.get_device_properties(q.device).multi_processor_count)
    else:
        chunk, n_split = chunk_pages, max(1, -(-n_read // chunk_pages))
    work, counters = _workspace(
        q.device, stream, units * n_split * ROWS_PER_BLOCK * (d + 2), units)
    tail = (table.data_ptr(), mask3.data_ptr(), out.data_ptr(), b, h, s, d,
            kvh, ps, n_read, float(scale), _build.dtype_code(q.dtype),
            stream, work.data_ptr(), counters.data_ptr(), chunk)
    if scales is None:
        fn = _build.launcher('paged_decode', _ARGTYPES)
        err = fn(q.data_ptr(), page_key.data_ptr(), page_value.data_ptr(),
                 *tail)
        _build.check(err, 'paged_decode_launch')
        launches += 1
        launches_by_s[s] = launches_by_s.get(s, 0) + 1
    else:
        fn = _build.launcher('paged_decode', _ARGTYPES_INT8,
                             'paged_decode_int8_launch')
        err = fn(q.data_ptr(), page_key.data_ptr(), page_value.data_ptr(),
                 scales[0].data_ptr(), scales[1].data_ptr(), *tail)
        _build.check(err, 'paged_decode_int8_launch')
        launches_int8 += 1
        launches_int8_by_s[s] = launches_int8_by_s.get(s, 0) + 1
    return out

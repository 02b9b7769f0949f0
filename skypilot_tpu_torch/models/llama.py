"""Llama family for serving and training, in PyTorch.

Port of skypilot_tpu/models/llama.py on its serving path
(`decode=True`) and its cacheless training forward: RMSNorm, split-half
rope, grouped-query attention (against a KV cache, or over the whole
sequence through the flash-attention kernels), the gated MLP (SiLU, or
`activation='gelu'`) and the untied f32 head.  The
mixed precision follows the reference: activations and matmuls in
`dtype`, RMSNorm and rope in f32, attention scores in f32, logits in
f32 (the head runs in f32, so its weight is kept in f32).

Where the reference chooses its attention path through trace-time
thread-locals (`slot_mode`, `kv_read_bucket`, `decode_kernel`,
`prefill_kernel`), the port takes explicit arguments: the cache object
says which path runs (`PrefillCache`: the batch-1 chunked prefill at a
global cursor; `PagedCache`: a slot forward against the page pool;
`SlotCache`: a slot forward against the contiguous [B, kvh, max_len,
hd] slot rows of an unpaged engine, the reference's default), `kernel`
picks the CUDA kernels ('fused'), their plain
versions ('plain') or the reference's XLA read in plain PyTorch
('xla'; see `resolve_kernel`), and `read_len` caps the cache reads.
Caches are updated in place.  With `kv_cache_dtype='int8'` every cache
holds int8 K/V rows with f32 absmax scales per (kv head, position)
beside them, quantized on write (`ops/grouped_attention.py`
`quantize_int8_rows`); the kernels read them through their int8
branches, 'xla' through the reference's `quantized_grouped_attention`.
With `quantize='int8'` (weight-only int8 serving) every matmul weight
and the token embedding are int8 with f32 per-output-row scales (the
embedding: one per model column), as the reference's
`quantize_params_int8`; each is dequantized to `param_dtype` just before
its use, one weight at a time (`dequantize_int8`, the reference's
`maybe_dequantize_params`).  A slot forward takes S >= 1 queries a
row: one decode token, or a speculative verify window or a mixed
prefill/decode step (the reference's `_verify_positions` and
`_verify_mask`; `_slot_positions`, `_slot_mask`).  The training
forward (`Llama.train_forward`) takes no cache; it reruns each block in
the backward pass (`remat`, through torch.utils.checkpoint), whole as
the reference's `nothing_saveable` policy does, or around the attention
with `remat_policy='save_attn'`.  With `lora_rank` > 0 every forward
(training, prefill, paged and contiguous slot forwards) adds the LoRA
delta of each targeted projection (`LoraAdapter`, the reference's
`maybe_lora`); under weight-only int8 the adapters stay float, as the
reference's `quantize_params_int8` leaves them.

The other families (models/qwen.py, gpt2.py, moe.py, gemma.py) subclass
`Llama` and `Block` and share these forwards: q/k/v biases
(`attention_bias`), a head tied to the embedding (`tie_embeddings`),
learned positions and no rope (gpt2), a routed MLP whose aux loss
`train_forward(return_aux=True)` sums (Mixtral), plus-one norms, a
scaled embedding and a softcapped head (gemma).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as checkpoint_lib

from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.ops import grouped_attention as ga
from skypilot_tpu_torch.ops import paged_attention as pa
from skypilot_tpu_torch.ops import ragged_prefill as rp

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float16': torch.float16}
# The gated MLP's activations (`LlamaConfig.activation`).
_ACTIVATIONS = {'silu': F.silu,
                'gelu': lambda g: F.gelu(g, approximate='tanh')}


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """torch dtype from a torch dtype or its name ('bfloat16', ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) not in _DTYPES:
        raise ValueError(f'unsupported dtype {dtype!r}')
    return _DTYPES[str(dtype)]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    name: str
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # Sliding-window attention (Mistral): each token sees its last
    # `sliding_window` positions.  None = full causal.
    sliding_window: Optional[int] = None
    # Paged serving KV cache: a pool of [kv_n_pages, kvh, kv_page_size,
    # hd] pages, page 0 the reserved null page.
    kv_page_size: int = 0
    kv_n_pages: int = 0
    # KV cache storage: 'auto' = `dtype`, 'int8' = int8 rows with f32
    # per-(kv head, position) absmax scales in sibling tensors.
    kv_cache_dtype: str = 'auto'
    # Weight-only int8 serving: None = float weights, 'int8' = int8
    # matmul weights and embedding with f32 scales beside them.
    quantize: Optional[str] = None
    # Training forward: rerun each block in the backward pass ('nothing'
    # is saved but the block's input, the reference's default policy);
    # attention through the flash kernels or the plain `mha_reference`.
    remat: bool = True
    remat_policy: str = 'nothing'
    attention_impl: str = 'flash'
    # LoRA finetuning: rank 0 = off.  Adapters are additive siblings of
    # their projections (`<proj>_lora.a` [in, rank], `.b` [rank, out]),
    # so the base names are unchanged and a base checkpoint loads into a
    # LoRA model (train/checkpoint.py restore_params_partial); train
    # only the adapters with the trainer's `train_only='lora'`.  The
    # MLP projections (gate/up/down_proj) are opt-in targets.
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ('q_proj', 'k_proj', 'v_proj',
                                     'o_proj')
    # The gated MLP's activation on the gate: 'silu' (Llama's SwiGLU) or
    # 'gelu' (tanh-approximate, Gemma's GeGLU); the reference reads the
    # same field where a config has it.
    activation: str = 'silu'

    def __post_init__(self):
        check_config(self)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def check_config(cfg: Any) -> None:
    """Validate a family's frozen config and normalise it in place:
    dtype names become torch dtypes, a JSON list of lora_targets a
    tuple."""
    if cfg.kv_cache_dtype not in ('auto', 'int8'):
        raise ValueError(f"kv_cache_dtype must be 'auto' or 'int8', "
                         f'got {cfg.kv_cache_dtype!r}')
    if cfg.quantize not in (None, 'int8'):
        raise ValueError(f"quantize must be None or 'int8', got "
                         f'{cfg.quantize!r}.')
    if cfg.lora_rank < 0:
        raise ValueError(f'lora_rank must be >= 0, got {cfg.lora_rank}')
    if getattr(cfg, 'activation', 'silu') not in _ACTIVATIONS:
        raise ValueError(f'activation must be one of {sorted(_ACTIVATIONS)}, '
                         f'got {cfg.activation!r}')
    if 'lora_targets' in cfg.__dataclass_fields__:
        object.__setattr__(cfg, 'lora_targets', tuple(cfg.lora_targets))
    object.__setattr__(cfg, 'dtype', as_dtype(cfg.dtype))
    object.__setattr__(cfg, 'param_dtype', as_dtype(cfg.param_dtype))


CONFIGS: Dict[str, LlamaConfig] = {
    'llama-tiny': LlamaConfig('llama-tiny', vocab_size=512, dim=256,
                              n_layers=2, n_heads=2, n_kv_heads=1,
                              ffn_dim=512, max_seq_len=512),
    'llama3-8b': LlamaConfig('llama3-8b'),
    'llama3-70b': LlamaConfig('llama3-70b', dim=8192, n_layers=80,
                              n_heads=64, n_kv_heads=8, ffn_dim=28672),
    'llama3.2-1b': LlamaConfig('llama3.2-1b', dim=2048, n_layers=16,
                               n_heads=32, n_kv_heads=8, ffn_dim=8192),
    'llama2-7b': LlamaConfig('llama2-7b', vocab_size=32000, dim=4096,
                             n_layers=32, n_heads=32, n_kv_heads=32,
                             ffn_dim=11008, rope_theta=10000.0,
                             max_seq_len=4096),
    'mistral-7b': LlamaConfig('mistral-7b', vocab_size=32000, dim=4096,
                              n_layers=32, n_heads=32, n_kv_heads=8,
                              ffn_dim=14336, rope_theta=10000.0,
                              max_seq_len=32768, sliding_window=4096),
}


def get_config(name: str, **overrides: Any) -> LlamaConfig:
    if name not in CONFIGS:
        raise ValueError(f'Unknown llama config {name!r}; '
                         f'available: {sorted(CONFIGS)}')
    return dataclasses.replace(CONFIGS[name], **overrides)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def _kv_zeros(cfg: LlamaConfig, shape: Tuple[int, ...],
              device: torch.device):
    """(key, value, key_scale, value_scale) zeros of one cache: K/V of
    `shape` in cfg.dtype, or int8 with f32 scales of shape[:-1] + (1,)
    (None for a float cache)."""
    if cfg.kv_cache_dtype != 'int8':
        return (torch.zeros(shape, dtype=cfg.dtype, device=device),
                torch.zeros(shape, dtype=cfg.dtype, device=device),
                None, None)
    sshape = shape[:-1] + (1,)
    return (torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device))


@dataclasses.dataclass
class PrefillCache:
    """Contiguous chunked-prefill cache, [L, B, kvh, max_len, hd] each,
    written at the global `cursor` (advanced once per forward); an int8
    cache has f32 scales [L, B, kvh, max_len, 1] beside K and V."""
    key: torch.Tensor
    value: torch.Tensor
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None
    cursor: int = 0

    @classmethod
    def zeros(cls, cfg: LlamaConfig, batch: int,
              device: torch.device) -> 'PrefillCache':
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.max_seq_len,
                 cfg.head_dim)
        return cls(*_kv_zeros(cfg, shape, device))


@dataclasses.dataclass
class SlotCache:
    """Contiguous slot-decode cache of an unpaged engine (page_size 0,
    the reference's default): K/V [L, B, kvh, max_len, hd], one row per
    slot, each written at its own depth; an int8 cache has f32 scales
    [L, B, kvh, max_len, 1] beside K and V."""
    key: torch.Tensor
    value: torch.Tensor
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None

    @classmethod
    def zeros(cls, cfg: LlamaConfig, batch: int,
              device: torch.device) -> 'SlotCache':
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.max_seq_len,
                 cfg.head_dim)
        return cls(*_kv_zeros(cfg, shape, device))

    def nbytes(self) -> int:
        """Bytes of the K/V rows and their scales."""
        return sum(t.nbytes for t in (self.key, self.value, self.key_scale,
                                      self.value_scale) if t is not None)


@dataclasses.dataclass
class PagedCache:
    """Paged decode cache: K/V pools [L, n_pages, kvh, ps, hd] shared by
    every slot, and each slot's block table [B, max_len // ps] int32
    (page 0 = the reserved null page); an int8 cache has f32 scale
    pools [L, n_pages, kvh, ps, 1] beside K and V."""
    key: torch.Tensor
    value: torch.Tensor
    table: torch.Tensor
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None

    @classmethod
    def zeros(cls, cfg: LlamaConfig, batch: int,
              device: torch.device) -> 'PagedCache':
        ps, n_pages = cfg.kv_page_size, cfg.kv_n_pages
        if ps <= 0 or cfg.max_seq_len % ps:
            raise ValueError(f'kv_page_size ({ps}) must be > 0 and divide '
                             f'max_seq_len ({cfg.max_seq_len})')
        if n_pages < 2:
            raise ValueError(f'kv_n_pages must be >= 2 (page 0 is the '
                             f'reserved null page), got {n_pages}')
        shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, ps, cfg.head_dim)
        key, value, key_scale, value_scale = _kv_zeros(cfg, shape, device)
        return cls(key, value,
                   torch.zeros((batch, cfg.max_seq_len // ps),
                               dtype=torch.int32, device=device),
                   key_scale, value_scale)

    def nbytes(self) -> int:
        """Bytes of the K/V pools and their scale pools."""
        return sum(t.nbytes for t in (self.key, self.value, self.key_scale,
                                      self.value_scale) if t is not None)


def _layer_scales(cache: Union[PrefillCache, PagedCache, SlotCache],
                  layer: int
                  ) -> Dict[str, Optional[torch.Tensor]]:
    """The kernels' key_scale/value_scale arguments for one layer (None
    for a float cache)."""
    if cache.key_scale is None:
        return dict(key_scale=None, value_scale=None)
    return dict(key_scale=cache.key_scale[layer],
                value_scale=cache.value_scale[layer])


def resolve_kernel(kernel: str, device: torch.device, *,
                   paged: bool = True) -> str:
    """The attention path of a forward on `device`:
      'fused'  the kernels' wrappers: the CUDA kernels on CUDA tensors,
               their plain versions on CPU tensors (as the reference runs
               its fused path in interpret mode off the TPU);
      'plain'  the kernels' plain versions on any device (what the
               kernels are held to on the card);
      'xla'    the reference's XLA read in plain PyTorch: the same
               function as the kernels for a float cache; for an int8
               cache `quantized_grouped_attention` (int16 x int8 dots),
               about 1e-3 off the kernels' int8 formulation.
    'auto' is 'fused' on a CUDA device with a paged cache, else 'xla'.
    An unpaged cache (`paged` False) has no kernel, as in the reference:
    'fused' and 'plain' raise there."""
    if kernel not in ('auto', 'fused', 'plain', 'xla'):
        raise ValueError(f"kernel must be 'auto', 'fused', 'plain' or "
                         f"'xla', got {kernel!r}")
    if kernel == 'auto':
        on_cuda = torch.device(device).type == 'cuda'
        return 'fused' if on_cuda and paged else 'xla'
    if kernel != 'xla' and not paged:
        raise ValueError(f"kernel={kernel!r} needs a paged KV cache "
                         '(kv_page_size > 0): an unpaged cache runs no '
                         "kernel, only 'xla'")
    return kernel


def _read_len(read_len: Optional[int], max_len: int) -> int:
    """The reference's read window: `read_len` capped at max_len."""
    return read_len if (read_len is not None and read_len < max_len) \
        else max_len


def _read_window(read_len: Optional[int], max_len: int, ps: int) -> int:
    """The read window in pages, rounded up."""
    return -(-_read_len(read_len, max_len) // ps)


class PrefillPlan(NamedTuple):
    """Per-forward inputs of the chunked-prefill attention, shared by
    every layer: for the kernels ('fused', 'plain') the identity page
    walk, the validity row and the base; for 'xla' the read window and
    its causal visibility."""
    tbl: Optional[torch.Tensor]   # [B, n_read] int32
    vis: Optional[torch.Tensor]   # [B, max_len] bool
    base: Optional[torch.Tensor]  # [B] int32, the cache cursor
    read_len: int
    mask: Optional[torch.Tensor]  # [B|1, 1, S, read_len] bool


def prefill_plan(cache: PrefillCache, kv_mask: Optional[torch.Tensor],
                 b: int, s: int, *, cfg: LlamaConfig,
                 read_len: Optional[int], kernel: str) -> PrefillPlan:
    idx = cache.cursor
    max_len = cfg.max_seq_len
    if idx + s > max_len:
        raise ValueError(f'chunk [{idx}, {idx + s}) overruns max_seq_len '
                         f'{max_len}')
    dev = cache.key.device
    if kernel == 'xla':
        # The reference's read: the first read_len slots, causal against
        # the cursor (columns >= idx + s are dead, so the cap is exact).
        n = _read_len(read_len, max_len)
        slots = torch.arange(n, device=dev)
        rows = idx + torch.arange(s, device=dev)
        causal = slots[None, :] <= rows[:, None]
        if cfg.sliding_window is not None:
            causal &= slots[None, :] >= rows[:, None] - cfg.sliding_window + 1
        mask = causal[None, None]
        if kv_mask is not None:
            mask = mask & kv_mask[:, None, None, :n]
        return PrefillPlan(None, None, None, n, mask)
    n_read = _read_window(read_len, max_len, cfg.kv_page_size)
    tbl = torch.arange(n_read, dtype=torch.int32,
                       device=dev).expand(b, n_read).contiguous()
    vis = kv_mask if kv_mask is not None else torch.ones(
        (b, max_len), dtype=torch.bool, device=dev)
    if vis.shape[1] < max_len:
        # Padded columns sit past the chunk: causally dead either way.
        vis = F.pad(vis, (0, max_len - vis.shape[1]))
    base = torch.full((b,), idx, dtype=torch.int32, device=dev)
    return PrefillPlan(tbl, vis.contiguous(), base, n_read * cfg.kv_page_size,
                       None)


def run_cached_attention(layer: int, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, cache: PrefillCache,
                         plan: PrefillPlan, *, cfg: LlamaConfig,
                         kernel: str) -> torch.Tensor:
    """Chunked-prefill attention at the global cursor (the contiguous,
    global-cursor branch of the reference's run_cached_attention): write
    the chunk's K/V at `cache.cursor`, then attend over the cache with
    the causal mask against the cursor base.  The kernels ('fused',
    'plain') walk the cache as identity pages (columns past the cursor +
    chunk are causally dead, so the page-rounded window is exact); 'xla'
    is the reference's read (`models/llama.py:740-743`): the first
    read_len slots through `grouped_attention`, or
    `quantized_grouped_attention` for an int8 cache.  An int8 cache
    stores quantize_int8_rows of the rotated K and of V, in cfg.dtype as
    the reference quantizes them.  Returns [B, S, H, hd]."""
    s, hd = q.shape[2], q.shape[3]
    idx = cache.cursor
    k, v = k.to(cfg.dtype), v.to(cfg.dtype)
    if cache.key_scale is not None:
        k, ks = ga.quantize_int8_rows(k)
        v, vs = ga.quantize_int8_rows(v)
        cache.key_scale[layer][:, :, idx:idx + s] = ks
        cache.value_scale[layer][:, :, idx:idx + s] = vs
    cache.key[layer][:, :, idx:idx + s] = k
    cache.value[layer][:, :, idx:idx + s] = v
    if kernel == 'xla':
        return _xla_read(q, cache, layer, plan.read_len, plan.mask, cfg=cfg)
    fn = (rp.ragged_prefill_attention if kernel == 'fused'
          else rp.ragged_prefill_attention_plain)
    return fn(q, cache.key[layer], cache.value[layer], plan.tbl, plan.base,
              plan.vis, scale=hd ** -0.5, probs_dtype=cfg.dtype,
              page_size=cfg.kv_page_size, window=cfg.sliding_window,
              **_layer_scales(cache, layer))


def _xla_read(q: torch.Tensor, cache: Union[PrefillCache, SlotCache],
              layer: int, read_len: int, mask: torch.Tensor, *,
              cfg: LlamaConfig) -> torch.Tensor:
    """The reference's epilogue over the first read_len slots of a
    contiguous cache: grouped attention, or its int8 read."""
    keys = cache.key[layer][:, :, :read_len]
    values = cache.value[layer][:, :, :read_len]
    kw = dict(scale=q.shape[-1] ** -0.5, probs_dtype=cfg.dtype)
    if cache.key_scale is None:
        return ga.grouped_attention(q, keys, values, mask, **kw)
    return ga.quantized_grouped_attention(
        q, keys, cache.key_scale[layer][:, :, :read_len], values,
        cache.value_scale[layer][:, :, :read_len], mask, **kw)


def _slot_positions(kv_mask: torch.Tensor, s: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(base [B], pos [B, S]) of a slot forward (the reference's
    `_verify_positions`): each row's write base is its highest revealed
    kv_mask slot (0 for a row with none), and query j writes at base + j.
    The engine reveals only the query-0 slot before the forward; the
    other positions stay unrevealed until the engine reveals what it
    commits, so a rejected or padded tail is rolled back by the mask
    alone and rewritten in place later.  pos may pass max_len - 1 for a
    row near the end of its budget: those writes are dropped (contiguous)
    or redirected to the null page (paged)."""
    max_len = kv_mask.shape[1]
    slots = torch.arange(max_len, device=kv_mask.device)
    base = torch.where(kv_mask, slots, 0).amax(-1)
    return base, base[:, None] + torch.arange(s, device=kv_mask.device)


def _slot_mask(kv_mask: torch.Tensor, base: torch.Tensor, s: int,
               read_len: int, window: Optional[int]) -> torch.Tensor:
    """[B, 1, S, read_len] visibility of a slot forward (the reference's
    `_verify_mask`): query j sees every revealed slot and the in-flight
    window base..base + j, under the sliding window.  At S = 1 this is
    kv_mask itself for every row with a revealed slot.  Built once a
    forward and contiguous, so the paged-decode kernel's [B, S, read_len]
    mask is a view of it in every layer, never a copy."""
    slots = torch.arange(read_len, device=kv_mask.device)
    qpos = base[:, None] + torch.arange(s, device=kv_mask.device)
    visible = kv_mask[:, None, :read_len] | (
        (slots[None, None, :] >= base[:, None, None])
        & (slots[None, None, :] <= qpos[:, :, None]))
    if window is not None:
        visible &= slots[None, None, :] >= qpos[:, :, None] - window + 1
    return visible[:, None]


class SlotPlan(NamedTuple):
    """Per-forward inputs of a paged slot forward (S >= 1 queries a row),
    shared by every layer: where each query writes, and what it reads."""
    phys: torch.Tensor      # [B, S] physical page of each query's write
    off: torch.Tensor       # [B, S] offset of the write in that page
    tbl: torch.Tensor       # [B, n_read] int32 block table under the window
    mask: torch.Tensor      # [B, 1, S, n_read * ps] bool visibility


def slot_plan(cache: PagedCache, kv_mask: torch.Tensor, s: int = 1, *,
              cfg: LlamaConfig, read_len: Optional[int]) -> SlotPlan:
    """The reference's paged slot branch (`_paged_slot_attention`, every
    S): query j of a row writes at base + j through its block table, at
    logical page min(pos // ps, pages_per_slot - 1), and at the null page
    0 once pos reaches max_len; dead rows' and pad queries' tables point
    at the null page, so their writes land there.  Reads cover the pages
    under the read window; visibility is `_slot_mask`."""
    ps = cfg.kv_page_size
    max_len = cfg.max_seq_len
    base, pos = _slot_positions(kv_mask, s)
    lp = torch.clamp(pos // ps, max=max_len // ps - 1)
    phys = torch.where(pos < max_len, cache.table.gather(1, lp).long(), 0)
    n_read = _read_window(read_len, max_len, ps)
    return SlotPlan(phys, pos % ps, cache.table[:, :n_read].contiguous(),
                    _slot_mask(kv_mask, base, s, n_read * ps,
                               cfg.sliding_window))


def paged_slot_attention(layer: int, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, cache: PagedCache,
                         plan: SlotPlan, *, cfg: LlamaConfig,
                         kernel: str) -> torch.Tensor:
    """Slot forward against the page pool (the reference's
    `_paged_slot_attention`): write each query's K/V into its page slot,
    then attend over the pages of `plan`; an int8 cache stores
    quantize_int8_rows of them, with their scales at the same slot of
    the scale pools.  S = 1 is a decode step; S > 1 a speculative
    verify (the pending token and the proposals) or a mixed step (a
    prompt chunk, or a decode token and pad queries).  Returns
    [B, S, H, hd]."""
    hd = q.shape[3]
    pk = cache.key[layer]
    pv = cache.value[layer]
    # [B, S, kvh, hd]: the layout of pool[phys, :, off, :] for [B, S]
    # indices (the two advanced indices are not adjacent).
    k = k.to(cfg.dtype).transpose(1, 2)
    v = v.to(cfg.dtype).transpose(1, 2)
    scales = _layer_scales(cache, layer)
    if cache.key_scale is not None:
        k, ks = ga.quantize_int8_rows(k)
        v, vs = ga.quantize_int8_rows(v)
        scales['key_scale'][plan.phys, :, plan.off, :] = ks
        scales['value_scale'][plan.phys, :, plan.off, :] = vs
    pk[plan.phys, :, plan.off, :] = k
    pv[plan.phys, :, plan.off, :] = v
    kw = dict(scale=hd ** -0.5, probs_dtype=cfg.dtype)
    if kernel == 'xla' and cache.key_scale is not None:
        # The reference's int8 read (`models/llama.py:505-511`): gathered
        # pages and scale pages through quantized_grouped_attention.
        return ga.quantized_grouped_attention(
            q, ga.gather_pages(pk, plan.tbl),
            ga.gather_pages(scales['key_scale'], plan.tbl),
            ga.gather_pages(pv, plan.tbl),
            ga.gather_pages(scales['value_scale'], plan.tbl), plan.mask,
            **kw)
    # For a float cache the reference's 'xla' read is the plain version.
    fn = (pa.paged_decode_attention if kernel == 'fused'
          else pa.paged_decode_attention_plain)
    return fn(q, pk, pv, plan.tbl, plan.mask, **kw, **scales)


class ContigPlan(NamedTuple):
    """Per-forward inputs of a contiguous slot forward (S >= 1)."""
    rows: torch.Tensor      # [B, 1]
    pos: torch.Tensor       # [B, S] each query's write slot
    keep: Optional[torch.Tensor]   # flat indices of the writes inside
                                   # max_len (None: all of them)
    read_len: int
    mask: torch.Tensor      # [B, 1, S, read_len] bool visibility


def contig_slot_plan(kv_mask: torch.Tensor, s: int = 1, *,
                     cfg: LlamaConfig, read_len: Optional[int]
                     ) -> ContigPlan:
    """The reference's contiguous slot branch (`models/llama.py:580` on):
    query j of a row writes at base + j (`_slot_positions`), writes past
    max_len dropped (the reference's mode='drop'; finding them costs one
    host sync a forward, at S > 1 only); visibility is `_slot_mask` over
    the first read_len slots (not page-rounded: there are no pages)."""
    max_len = cfg.max_seq_len
    base, pos = _slot_positions(kv_mask, s)
    keep = None
    if s > 1:
        keep = torch.nonzero((pos < max_len).flatten()).flatten()
    n = _read_len(read_len, max_len)
    rows = torch.arange(kv_mask.shape[0], device=kv_mask.device)[:, None]
    return ContigPlan(rows, pos, keep, n,
                      _slot_mask(kv_mask, base, s, n, cfg.sliding_window))


def contig_slot_attention(layer: int, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, cache: SlotCache,
                          plan: ContigPlan, *,
                          cfg: LlamaConfig) -> torch.Tensor:
    """Slot forward against the contiguous slot rows: write each query's
    K/V (quantize_int8_rows of them for an int8 cache) at its write
    slot, then the reference's read over the first read_len slots
    (`grouped_attention` or `quantized_grouped_attention`).  There is no
    kernel on this path, as in the reference, whose fused kernels need a
    paged cache.  Returns [B, S, H, hd]."""
    k = k.to(cfg.dtype).transpose(1, 2)        # [B, S, kvh, hd]
    v = v.to(cfg.dtype).transpose(1, 2)
    rows, pos = plan.rows.expand_as(plan.pos), plan.pos
    if plan.keep is not None:
        rows, pos = rows.flatten()[plan.keep], pos.flatten()[plan.keep]
        k, v = k.flatten(0, 1)[plan.keep], v.flatten(0, 1)[plan.keep]
    at = (rows, slice(None), pos, slice(None))
    if cache.key_scale is not None:
        k, ks = ga.quantize_int8_rows(k)
        v, vs = ga.quantize_int8_rows(v)
        cache.key_scale[layer][at] = ks
        cache.value_scale[layer][at] = vs
    cache.key[layer][at] = k
    cache.value[layer][at] = v
    return _xla_read(q, cache, layer, plan.read_len, plan.mask, cfg=cfg)


def _train_attention(cfg: LlamaConfig, *, kernel: str):
    """The training forward's attention, `attend(q, k, v)` on [B, H|kvh,
    S, hd] -> [B, S, H, hd]: causal over the whole sequence, with
    `cfg.sliding_window`.  'flash' runs `flash_attention` (its kernels'
    wrappers for kernel='fused', their plain versions otherwise),
    'reference' the plain `mha_reference` under autograd."""
    if cfg.attention_impl in ('ring', 'ulysses'):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} is context parallelism, "
            "not ported yet (ROADMAP.md queue 1: 'Parallelism')")
    if cfg.remat_policy not in ('nothing', 'save_attn'):
        raise ValueError(f'Unknown remat_policy {cfg.remat_policy!r}; '
                         "expected 'nothing' or 'save_attn'.")
    window = cfg.sliding_window
    if cfg.attention_impl == 'flash':
        plain = kernel != 'fused'

        def attend(q, k, v):
            return fa.flash_attention(q, k, v, None, True, window,
                                      plain=plain).transpose(1, 2)
    elif cfg.attention_impl == 'reference':
        def attend(q, k, v):
            return fa.mha_reference(q, k, v, window=window).transpose(1, 2)
    else:
        raise ValueError(f"attention_impl must be 'flash', 'reference', "
                         f"'ring' or 'ulysses', got {cfg.attention_impl!r}")
    return attend


# ---------------------------------------------------------------------------
# weight-only int8
# ---------------------------------------------------------------------------
def quantize_int8_weight(x: torch.Tensor, axis: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 absmax quantization of one weight over `axis`
    (its input axis; the vocab axis of the embedding): (q int8, scale
    f32, keepdim), x ~= q * scale.  Bit for bit the reference's
    `quantize_params_int8` on the same values: absmax / 127 in x's own
    dtype, floored at 1e-8 in that dtype, then f32; q = round(x / scale)
    in f32 (half to even), clipped to +-127."""
    scale = x.abs().amax(dim=axis, keepdim=True) / 127.0
    scale = torch.maximum(scale, scale.new_tensor(1e-8)).float()
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def quant_axis(name: str) -> int:
    """The axis a weight of the state_dict is scaled over: the vocab
    axis of `tok_embed` [V, D], the input axis of an [out, in] matmul
    weight."""
    return 0 if name == 'tok_embed' else 1


def quantizable(name: str, x: torch.Tensor) -> bool:
    """Whether weight-only int8 quantizes the state_dict entry `name`:
    every float matmul weight [out, in] (lm_head, gpt2's fused qkv_proj
    and Mixtral's router included) and tok_embed, as the reference's
    `quantize_params_int8` quantizes its `kernel` leaves and the
    embedding.  The norms, biases and LoRA adapters, gpt2's pos_embed and
    Mixtral's expert-stacked [E, ...] weights (bare params in the
    reference, not kernels) stay float."""
    return (x.is_floating_point() and x.dim() == 2 and not is_lora(name)
            and not name.endswith('pos_embed'))


def dequantize_int8(q8: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """q8 * scale in f32, rounded to `dtype` (the reference's
    `maybe_dequantize_params` for one weight), in one elementwise pass
    that reads int8 and writes `dtype`."""
    return torch.mul(q8, scale, out=torch.empty(q8.shape, dtype=dtype,
                                                 device=q8.device))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _weight(module: nn.Module, name: str, shape, dtype, cfg: 'LlamaConfig',
            device, scale_shape=None) -> None:
    """Register a matmul weight (or the embedding) `name` of `shape`:
    float `dtype`, or with cfg.quantize int8 beside an f32 `name_scale`
    of `scale_shape` (default [out, 1])."""
    if cfg.quantize is None:
        setattr(module, name, _param(shape, dtype, device))
        return
    setattr(module, name, _param(shape, torch.int8, device))
    setattr(module, name + '_scale',
            _param(scale_shape or (shape[0], 1), torch.float32, device))


def _use(module: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Weight `name` of `module` in `dtype`: a float weight cast, an int8
    one dequantized to cfg.param_dtype first (one weight at a time)."""
    w = getattr(module, name)
    if w.dtype == torch.int8:
        w = dequantize_int8(w, getattr(module, name + '_scale'),
                            module.cfg.param_dtype)
    return w.to(dtype)


def is_lora(name: str) -> bool:
    """Whether a state_dict name is a LoRA adapter's (`<proj>_lora.a`
    or `.b`): adapters stay float under weight-only int8, as the
    reference's `quantize_params_int8` quantizes only kernels and the
    embedding."""
    return '_lora.' in name


class LoraAdapter(nn.Module):
    """Low-rank additive delta of one projection (the reference's
    `LoraAdapter`): ((x @ a) @ b) * alpha / rank in cfg.dtype, with a
    [in, rank] and b [rank, out] in param_dtype (not transposed: used as
    x @ a @ b).  b starts at zero (`Llama.init_weights`), so a fresh
    adapter adds exactly nothing."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: LlamaConfig, device: torch.device):
        super().__init__()
        self.dtype = cfg.dtype
        self.scale = cfg.lora_alpha / cfg.lora_rank
        self.a = _param((in_features, cfg.lora_rank), cfg.param_dtype, device)
        self.b = _param((cfg.lora_rank, out_features), cfg.param_dtype,
                        device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return ((x.to(dt) @ self.a.to(dt)) @ self.b.to(dt)) * self.scale


def _add_adapters(module: nn.Module, shapes, cfg: LlamaConfig,
                  device) -> None:
    """Register `<name>_lora` for each projection of `shapes` ({name:
    [out, in]}) that cfg.lora_targets names, when cfg.lora_rank > 0."""
    if not cfg.lora_rank:
        return
    for name, (out_f, in_f) in shapes.items():
        if name in cfg.lora_targets:
            setattr(module, name + '_lora',
                    LoraAdapter(in_f, out_f, cfg, device))


def _add_biases(module: nn.Module, shapes, cfg: Any, device) -> None:
    """Register a float `<name>_bias` [out] for each projection of
    `shapes` ({name: [out, in]}); biases stay float under int8 weights,
    as the reference's `quantize_params_int8` leaves them."""
    for name, (out_f, _) in shapes.items():
        setattr(module, name + '_bias', _param((out_f,), cfg.param_dtype,
                                               device))


def _project(module: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    """Projection `name` of x in cfg.dtype, with its bias when it has one,
    plus its adapter's delta when it has one (the reference's
    `maybe_lora` over a biased DenseGeneral)."""
    dt = module.cfg.dtype
    bias = getattr(module, name + '_bias', None)
    y = F.linear(x, _use(module, name, dt),
                 None if bias is None else bias.to(dt))
    adapter = getattr(module, name + '_lora', None)
    return y if adapter is None else y + adapter(x)


class RMSNorm(nn.Module):

    def __init__(self, dim: int, eps: float, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = _param((dim,), param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), self.weight.shape, self.weight.float(),
                          self.eps).to(self.dtype)


def rope_cos_sin(positions: torch.Tensor, d: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 rotary tables [B, 1, S, d/2] for `positions` [B, S]."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=positions.device) / d))
    angles = positions[:, None, :, None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotation of [B, H, S, D] by the tables, in f32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embeddings on [B, H, S, D], split-half convention, in f32."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


class Attention(nn.Module):
    """Projection weights are [out, in] (F.linear layout).  A config with
    `attention_bias` (qwen) gives q/k/v biases, never o_proj one, read as
    the reference reads it (`getattr(cfg, 'attention_bias', False)`)."""

    def __init__(self, cfg: LlamaConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dim
        shapes = {'q_proj': (h * hd, d), 'k_proj': (kv * hd, d),
                  'v_proj': (kv * hd, d), 'o_proj': (d, h * hd)}
        for name, shape in shapes.items():
            _weight(self, name, shape, cfg.param_dtype, cfg, device)
        if getattr(cfg, 'attention_bias', False):
            _add_biases(self, {n: shapes[n] for n in ('q_proj', 'k_proj',
                                                      'v_proj')},
                        cfg, device)
        _add_adapters(self, shapes, cfg, device)

    def qkv(self, x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Rotated q [B, H, S, hd] (contiguous) and k, and v [B, kvh, S,
        hd] of the normed input x [B, S, dim]."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        x = x.to(cfg.dtype)
        q = _project(self, 'q_proj', x).view(b, s, h, hd).transpose(1, 2)
        k = _project(self, 'k_proj', x).view(b, s, kv, hd).transpose(1, 2)
        v = _project(self, 'v_proj', x).view(b, s, kv, hd).transpose(1, 2)
        return rotate(q, *rope).contiguous(), rotate(k, *rope), v

    def output(self, out: torch.Tensor) -> torch.Tensor:
        """o_proj of the attention output [B, S, H, hd] -> [B, S, dim]."""
        b, s, h, hd = out.shape
        return _project(self, 'o_proj',
                        out.reshape(b, s, h * hd).to(self.cfg.dtype))


class MLP(nn.Module):

    def __init__(self, cfg: LlamaConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        f, d = cfg.ffn_dim, cfg.dim
        shapes = {'gate_proj': (f, d), 'up_proj': (f, d),
                  'down_proj': (d, f)}
        for name, shape in shapes.items():
            _weight(self, name, shape, cfg.param_dtype, cfg, device)
        _add_adapters(self, shapes, cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.cfg.dtype)
        gate = _project(self, 'gate_proj', x)
        up = _project(self, 'up_proj', x)
        act = _ACTIVATIONS[self.cfg.activation]
        return _project(self, 'down_proj', act(gate) * up)


class Block(nn.Module):
    """A pre-norm decoder block: attention_norm, attention (`qkv`, then
    the caller's `attend`, then `output`), mlp_norm, mlp.  Other families
    give their own norms, attention and MLP in the same places (gpt2), or
    their own `_rest` (Mixtral's routed MLP).  `forward` returns (x, the
    block's router aux loss or None).  `norm_cls` is the class of both
    norms (Gemma's keeps its weight as an offset from 1)."""

    norm_cls = RMSNorm

    def __init__(self, cfg: LlamaConfig, device: torch.device):
        super().__init__()
        args = (cfg.dim, cfg.norm_eps, cfg.dtype, cfg.param_dtype, device)
        self.attention_norm = self.norm_cls(*args)
        self.attention = Attention(cfg, device)
        self.mlp_norm = self.norm_cls(*args)
        self.mlp = MLP(cfg, device)

    def forward(self, x, rope, attend
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self._rest(x, attend(*self._qkv(x, rope)))

    def _qkv(self, x, rope):
        return self.attention.qkv(self.attention_norm(x), rope)

    def _rest(self, x, out):
        """The block after its attention: o_proj, residual, the MLP."""
        x = x + self.attention.output(out)
        return x + self.mlp(self.mlp_norm(x)), None

    def forward_save_attn(self, x, rope, attend
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The block under remat_policy='save_attn': the attention norm
        and q/k/v projections, then the o_proj and MLP half, each rerun
        in the backward pass (checkpointed segments), with the attention
        between them outside any checkpoint, so its output and lse are
        kept and the backward launches no flash forward."""
        q, k, v = checkpoint_lib.checkpoint(self._qkv, x, rope,
                                            use_reentrant=False)
        return checkpoint_lib.checkpoint(self._rest, x, attend(q, k, v),
                                         use_reentrant=False)


class Llama(nn.Module):
    """Decoder-only transformer; logits [B, S, V] f32.  `forward` and
    `hidden` serve against a cache, `train_forward` trains.

    Parameters are created uninitialized on `device`, not requiring
    grad; fill them with `init_weights` (random, from a generator) or
    `load_state_dict` (e.g. from `bridge.params_from_jax`), and call
    `requires_grad_()` to train them.

    The other families (models/qwen.py, gpt2.py, moe.py) are subclasses
    that change only what differs: `block_cls` and `norm_cls`, `embed`
    (gpt2 adds learned positions, gemma scales by sqrt(dim)), `rope`
    (gpt2 has none), a tied head (`cfg.tie_embeddings`: the logits come
    from tok_embed), `head` (gemma's final-logit softcap), and the init
    values (`_init_std`, `norm_init`).  The cache plans, the remat
    policies and the attention closures of `hidden` and `train_forward`
    are shared."""

    block_cls = Block
    norm_cls = RMSNorm
    embed_std = 1.0
    norm_init = 1.0    # every norm's weight (gemma's offsets: 0)

    def __init__(self, cfg: LlamaConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        _weight(self, 'tok_embed', (cfg.vocab_size, cfg.dim),
                cfg.param_dtype, cfg, device, scale_shape=(1, cfg.dim))
        self.layers = nn.ModuleList(self.block_cls(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = self.norm_cls(cfg.dim, cfg.norm_eps, cfg.dtype,
                                        cfg.param_dtype, device)
        self.tied = bool(getattr(cfg, 'tie_embeddings', False))
        if not self.tied:
            # The head computes in f32 (reference: DenseGeneral
            # dtype=f32), so a float head's weight is kept in f32 rather
            # than cast every step.
            _weight(self, 'lm_head', (cfg.vocab_size, cfg.dim),
                    torch.float32, cfg, device)

    def _init_std(self, name: str) -> float:
        """Standard deviation of the normal draw of weight `name`: the
        embedding's `embed_std`, o_proj scaled by 1/sqrt(2 * n_layers),
        0.02 otherwise."""
        if name == 'tok_embed':
            return self.embed_std
        if name.endswith('o_proj'):
            return 0.02 / math.sqrt(2 * self.cfg.n_layers)
        return 0.02

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's initializers: normal kernels and embeddings of
        `_init_std`, norm scales of `norm_init`, zero biases.  An int8
        model draws each weight as the float model does
        (same order, shapes and dtypes, so the same generator gives the
        same values) and stores its quantization of the weight cast to
        param_dtype, one weight at a time.  LoRA adapters are drawn after
        every base weight, so a LoRA model's base weights are those of the
        model without adapters from the same generator: each `a`
        normal(1 / rank) (the reference's initializer), each `b` zeros."""
        cfg = self.cfg
        params = dict(self.named_parameters())
        for name, p in params.items():
            if name.endswith('_scale') or is_lora(name):
                continue
            if name.endswith('.weight'):
                p.fill_(self.norm_init)
                continue
            if name.endswith('bias'):
                p.zero_()
                continue
            w = p
            if p.dtype == torch.int8:
                w = torch.empty(p.shape, device=p.device, dtype=(
                    torch.float32 if name == 'lm_head' else cfg.param_dtype))
            w.normal_(0.0, self._init_std(name), generator=generator)
            if p.dtype == torch.int8:
                q, scale = quantize_int8_weight(w.to(cfg.param_dtype),
                                                quant_axis(name))
                p.copy_(q)
                params[name + '_scale'].copy_(scale)
        for name, p in params.items():
            if name.endswith('_lora.a'):
                p.normal_(0.0, 1.0 / cfg.lora_rank, generator=generator)
            elif name.endswith('_lora.b'):
                p.zero_()

    def hidden(self, tokens: torch.Tensor, positions: torch.Tensor,
               cache: Union[PrefillCache, PagedCache, SlotCache],
               kv_mask: Optional[torch.Tensor], *, kernel: str = 'auto',
               read_len: Optional[int] = None) -> torch.Tensor:
        """Final-normed hidden states [B, S, dim]; updates `cache`.
        `kernel` as `resolve_kernel`, on the tokens' device; a model with
        kv_page_size 0 serves unpaged (no kernel)."""
        cfg = self.cfg
        kernel = resolve_kernel(kernel, tokens.device,
                                paged=cfg.kv_page_size > 0)
        x = self.embed(tokens, positions)
        rope = self.rope(positions)
        # Everything the layers share is computed once per forward.
        if isinstance(cache, PagedCache):
            if kv_mask is None:
                raise ValueError('paged slot decode needs kv_mask')
            plan = slot_plan(cache, kv_mask, tokens.shape[1], cfg=cfg,
                             read_len=read_len)

            def attend(i, q, k, v):
                return paged_slot_attention(i, q, k, v, cache, plan, cfg=cfg,
                                            kernel=kernel)
        elif isinstance(cache, SlotCache):
            if kv_mask is None:
                raise ValueError('slot decode needs kv_mask')
            plan = contig_slot_plan(kv_mask, tokens.shape[1], cfg=cfg,
                                    read_len=read_len)

            def attend(i, q, k, v):
                return contig_slot_attention(i, q, k, v, cache, plan,
                                             cfg=cfg)
        else:
            plan = prefill_plan(cache, kv_mask, tokens.shape[0],
                                tokens.shape[1], cfg=cfg, read_len=read_len,
                                kernel=kernel)

            def attend(i, q, k, v):
                return run_cached_attention(i, q, k, v, cache, plan,
                                            cfg=cfg, kernel=kernel)
        for i, layer in enumerate(self.layers):
            x = layer(x, rope, lambda q, k, v, i=i: attend(i, q, k, v))[0]
        if isinstance(cache, PrefillCache):
            cache.cursor += tokens.shape[1]
        return self.final_norm(x)

    def train_forward(self, tokens: torch.Tensor,
                      positions: Optional[torch.Tensor] = None, *,
                      return_hidden: bool = False, return_aux: bool = False,
                      kernel: str = 'auto'):
        """Cacheless forward (the reference's `Llama.__call__` with
        decode=False): f32 logits [B, S, V], or with `return_hidden` the
        final-normed hidden states [B, S, dim]; with `return_aux` the
        pair (that, the sum of every layer's router aux loss, as the
        reference's `sum_aux_losses` gives it: an f32 0 for a family with
        no router).  `kernel` as `resolve_kernel`, on the tokens' device.

        Under autograd with `cfg.remat` each block reruns in the backward
        pass, by `cfg.remat_policy` ('nothing' for a family whose config
        has no such field):
          'nothing'    the whole block is one checkpoint (the reference's
                       nothing_saveable): only its input is kept, and the
                       backward reruns the flash forward too;
          'save_attn'  `Block.forward_save_attn`: the attention output
                       and lse are kept (the reference's
                       save_only_these_names('attn_out', 'attn_lse')),
                       everything else in the block reruns, and the
                       backward launches no flash forward.
        A divergence by design under 'save_attn': the flash op keeps its
        inputs q, k, v (rotated, [B, H|kvh, S, hd]) between the forward
        and the backward as well, where the reference recomputes them
        from the block input; at llama3-8b widths in bf16 that is 96 MiB
        more a layer per 8192 tokens, and the flash backward needs no
        rerun of the q/k/v projections.  With attention_impl='reference'
        the plain attention's autograd graph is kept, not its output
        alone."""
        cfg = self.cfg
        attend = _train_attention(
            cfg, kernel=resolve_kernel(kernel, tokens.device))
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self.embed(tokens, positions)
        rope = self.rope(positions)
        remat = cfg.remat and torch.is_grad_enabled()
        policy = getattr(cfg, 'remat_policy', 'nothing')
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for layer in self.layers:
            if not remat:
                x, layer_aux = layer(x, rope, attend)
            elif policy == 'save_attn':
                x, layer_aux = layer.forward_save_attn(x, rope, attend)
            else:
                x, layer_aux = checkpoint_lib.checkpoint(
                    layer, x, rope, attend, use_reentrant=False)
            if layer_aux is not None:
                aux = aux + layer_aux
        x = self.final_norm(x)
        out = x if return_hidden else self.head(x)
        return (out, aux) if return_aux else out

    def embed(self, tokens: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
        """Token embeddings in cfg.dtype; an int8 table's rows are
        gathered first, then dequantized (elementwise, so exact).
        `positions` serve the families with learned positions (gpt2)."""
        return self._token_rows(tokens).to(self.cfg.dtype)

    def _token_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """tok_embed's rows of `tokens` in param_dtype."""
        x = F.embedding(tokens, self.tok_embed)
        if x.dtype == torch.int8:
            x = dequantize_int8(x, self.tok_embed_scale, self.cfg.param_dtype)
        return x

    def rope(self, positions: torch.Tensor
             ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The rotary tables every layer of a forward shares."""
        return rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits from final-normed hidden states: both widened to f32
        against lm_head or, with a tied head, tok_embed (the reference's
        'bsd,vd->bsv' einsum in f32).  An int8 head or table is
        dequantized to param_dtype, then widened (the reference's
        DenseGeneral(dtype=f32) over its dequantized kernel)."""
        name = 'tok_embed' if self.tied else 'lm_head'
        return F.linear(x.float(), _use(self, name, torch.float32))

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                cache: Union[PrefillCache, PagedCache, SlotCache],
                kv_mask: Optional[torch.Tensor], *, kernel: str = 'auto',
                read_len: Optional[int] = None) -> torch.Tensor:
        return self.head(self.hidden(tokens, positions, cache, kv_mask,
                                     kernel=kernel, read_len=read_len))


def num_params(config: LlamaConfig) -> int:
    """Analytic parameter count."""
    cfg = config
    per_layer = (cfg.dim * cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads)
                 + cfg.n_heads * cfg.head_dim * cfg.dim
                 + 3 * cfg.dim * cfg.ffn_dim + 2 * cfg.dim)
    return (cfg.vocab_size * cfg.dim * 2
            + cfg.n_layers * per_layer + cfg.dim)

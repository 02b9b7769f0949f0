"""Inference engines over a KV cache, in PyTorch.

Port of the synchronous, chunked-prefill path of
skypilot_tpu/infer/engine.py:ContinuousBatchingEngine, unpaged (the
reference's default, page_size 0) and paged, and of its request-level
`InferenceEngine` (the server's --no-continuous):

  - unpaged, a contiguous slot cache [B, kvh, max_seq_len, hd] per layer
    lives across requests, one row per slot; every decode step advances
    all occupied slots at once, each writing its token's K/V at its own
    depth (models/llama.py contig_slot_attention).  This path runs no
    kernel, on the card as on the CPU: the reference's fused kernels
    need a paged cache, so 'auto' resolves to 'xla' and 'fused' raises;
  - paged (page_size > 0), a page pool [n_pages, kvh, page_size, hd] per
    layer with a block table per slot (page 0 the null page) takes its
    place (models/llama.py paged_slot_attention), read through the CUDA
    kernels on the card;
  - a new prompt is admitted into a free slot between decode steps and
    prefilled in chunks of `prefill_chunk` tokens, one chunk per tick,
    into a private batch-1 contiguous cache at a global cursor; at the
    end the insert copies that cache into the slot's row (unpaged) or
    scatters it into the slot's pages (paged);
  - paged, prompts share their page-aligned prefixes: admission looks
    up every full prompt page already in the pool (the allocator's
    chain-hash map, at most one page short of the prompt's end), takes
    a reference on each, hydrates the prefill cache from them and
    prefills only the rest; the insert leaves the shared pages as they
    are, and then registers the prompt's full pages for later requests;
  - with kv_cache_dtype='int8' the caches hold int8 K/V with f32
    per-(kv head, position) scales beside them, read through the
    kernels' int8 branches (or, with 'xla', the reference's int16 x int8
    read): half the bytes of a bf16 cache, so twice the context or the
    slots on one card;
  - per-slot temperature, top_k and top_p ride the step as [B] vectors,
    and each sampled row draws from its own torch.Generator seeded from
    (request seed, generated index) - independent of batch companions,
    the counterpart of the reference's fold_in(seed, generated) key;
  - with quantize='int8' (weight-only int8, `quantize_params_int8`)
    the model holds int8 weights with f32 scales and dequantizes each
    just before its use (models/llama.py).
`InferenceEngine` prefills a whole batch of right-padded prompts at once
into a contiguous cache and decodes it in lockstep; it runs no kernel,
as the reference's does not.

Attention runs through the kernels' wrappers ('fused': the CUDA kernels
on the card, their plain versions on the CPU) or the reference's XLA
read in plain PyTorch ('xla'); `resolve_kernels` picks, as the
reference's table does: 'auto' is 'fused' on CUDA with a paged cache,
else 'xla', and 'fused' without a paged cache is a ValueError.

Not ported yet (later slices): the async pipeline, speculation, mixed
prefill budgets, disaggregated handoff, live migration, the host-RAM
tier, recovery, metrics and traces.

Thread model: submit()/cancel()/wait() are thread-safe; step() must be
driven by ONE thread (the server's decode loop).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch import models as models_lib
from skypilot_tpu_torch.infer import failures
from skypilot_tpu_torch.infer import paging as paging_lib
from skypilot_tpu_torch.models.llama import (PagedCache, PrefillCache,
                                             SlotCache, quant_axis,
                                             quantize_int8_weight,
                                             resolve_kernel)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0               # 0 => disabled
    top_p: float = 1.0           # 1 => disabled
    eos_id: Optional[int] = None
    max_new_tokens: int = 64
    # With a seed, a sampled row draws from a generator seeded by
    # (seed, generated index): reproducible whatever else shares the
    # batch.  Without one the engine derives it from its own seed and
    # the request id.
    seed: Optional[int] = None


def filter_logits_rows(logits: torch.Tensor, temps: torch.Tensor,
                       top_ks: torch.Tensor, top_ps: torch.Tensor, *,
                       max_k: int, use_top_p: bool,
                       top_p_in_topk: bool = False) -> torch.Tensor:
    """Temperature-scaled logits [B, V] with every entry the per-row
    top-k / top-p filter drops at -1e30: softmax of the result is the
    distribution a sampled row draws from.  `max_k` (0 = no top-k) is a
    bound >= every row's k; `top_p_in_topk` promises that every row with
    top_p < 1 also has top_k > 0, so the nucleus is cut inside the
    top-k window instead of a full-vocab sort (same result)."""
    safe = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    scaled = logits / safe
    if max_k > 0:
        vals = torch.topk(scaled, max_k, dim=-1).values     # descending
        idx = torch.clamp(top_ks.long() - 1, 0, max_k - 1)[:, None]
        kth = torch.gather(vals, -1, idx)
        keep = (top_ks[:, None] <= 0) | (scaled >= kth)
        scaled = torch.where(keep, scaled, scaled.new_tensor(NEG_INF))
    if use_top_p:
        if top_p_in_topk and max_k > 0:
            ranks = torch.arange(max_k, device=logits.device)
            sorted_logits = torch.where(ranks[None, :] < top_ks[:, None],
                                        vals, vals.new_tensor(NEG_INF))
        else:
            sorted_logits = torch.sort(scaled, dim=-1,
                                       descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = torch.sum(cum < top_ps[:, None], dim=-1, keepdim=True)
        cutoff_idx = torch.clamp(cutoff_idx, max=sorted_logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        keep = (top_ps[:, None] >= 1.0) | (scaled >= cutoff)
        scaled = torch.where(keep, scaled, scaled.new_tensor(NEG_INF))
    return scaled


def top_k_bucket(k: int, vocab_size: int) -> int:
    """Top-k width for a batch whose largest row k is `k`: the next power
    of two, capped at the vocab (0 stays 0)."""
    if k <= 0:
        return 0
    b = 1
    while b < k:
        b *= 2
    return min(b, vocab_size)


def row_generator(seed: int, generated: int,
                  device: torch.device) -> torch.Generator:
    """The generator one sampled row draws its `generated`-th token from.
    Python's hash of an int tuple does not depend on PYTHONHASHSEED, so
    the stream is stable across processes."""
    g = torch.Generator(device=device)
    g.manual_seed(hash((int(seed), int(generated))) & 0x7FFFFFFFFFFFFFFF)
    return g


def sample_logits_rows(logits: torch.Tensor,
                       generators: Sequence[Optional[torch.Generator]],
                       temps: torch.Tensor, top_ks: torch.Tensor,
                       top_ps: torch.Tensor, *, max_k: int, use_top_p: bool,
                       top_p_in_topk: bool = False) -> torch.Tensor:
    """Per-row sampling [B, V] -> [B] int64: rows with temp <= 0 decode
    greedily (first maximum), the others draw from the filtered softmax
    with their own generator (`generators[i]`, required for those)."""
    tok = torch.argmax(logits, dim=-1)
    rows = [i for i, g in enumerate(generators) if g is not None]
    if not rows:
        return tok
    scaled = filter_logits_rows(logits, temps, top_ks, top_ps, max_k=max_k,
                                use_top_p=use_top_p,
                                top_p_in_topk=top_p_in_topk)
    probs = torch.softmax(scaled, dim=-1)
    for i in rows:
        tok[i] = torch.multinomial(probs[i], 1, generator=generators[i])[0]
    return tok


def _resolve(kind: str, what: str, *, on_cuda: bool, page_size: int) -> str:
    """The model's rule (`resolve_kernel`: the kernels need a paged KV
    cache), for the engine's choices 'auto', 'fused' and 'xla'."""
    if kind not in ('auto', 'fused', 'xla'):
        raise ValueError(f"{what} must be 'auto', 'fused' or 'xla', got "
                         f'{kind!r}')
    if kind == 'fused' and not page_size:
        raise ValueError(f"{what}='fused' requires a paged KV cache "
                         '(page_size > 0)')
    return resolve_kernel(kind, torch.device('cuda' if on_cuda else 'cpu'),
                          paged=bool(page_size))


def resolve_decode_kernel(decode_kernel: str, *, on_cuda: bool,
                          page_size: int) -> str:
    """'fused' (the kernel's wrapper) or 'xla' (the reference's read in
    plain PyTorch) for slot decode."""
    return _resolve(decode_kernel, 'decode_kernel', on_cuda=on_cuda,
                    page_size=page_size)


def resolve_kernels(decode_kernel: str = 'auto',
                    prefill_kernel: str = 'auto', *, on_cuda: bool,
                    page_size: int) -> Dict[str, str]:
    """Resolve both attention-kernel requests to {'decode': kind,
    'prefill': kind}, validated at startup: 'auto' is 'fused' on CUDA
    with a paged cache, else 'xla'; an impossible 'fused' raises."""
    return {
        'decode': resolve_decode_kernel(decode_kernel, on_cuda=on_cuda,
                                        page_size=page_size),
        'prefill': _resolve(prefill_kernel, 'prefill_kernel',
                            on_cuda=on_cuda, page_size=page_size),
    }


# -- weight-only int8 ----------------------------------------------------------
def quantize_params_int8(params: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Weight-only int8 of a port state_dict, the reference's
    `quantize_params_int8` in the port's layout: every floating tensor of
    rank >= 2 (the [out, in] matmul weights, lm_head and tok_embed)
    becomes int8 at its key with f32 scales at `<key>_scale`, one per
    output row ([out, 1]; tok_embed's over its vocab axis, [1, D]); the
    norms stay float.  Bit for bit the reference's on the same values, so
    cast to param_dtype first, as the reference's engine does."""
    out: Dict[str, torch.Tensor] = {}
    for key, x in params.items():
        if x.is_floating_point() and x.dim() >= 2:
            out[key], out[key + '_scale'] = quantize_int8_weight(
                x, quant_axis(key))
        else:
            out[key] = x
    return out


def _serving_params(params: Mapping[str, torch.Tensor],
                    cfg: Any) -> Dict[str, torch.Tensor]:
    """The state_dict a model of `cfg` loads from `params`: float weights
    cast to param_dtype (the reference's `_place`), each quantized from
    that cast when cfg.quantize, one weight at a time; int8 weights and
    their scales (an already quantized tree) as they are."""
    out: Dict[str, torch.Tensor] = {}
    for key, x in params.items():
        if x.is_floating_point() and not key.endswith('_scale'):
            x = x.to(cfg.param_dtype)
            if cfg.quantize and x.dim() >= 2:
                out.update(quantize_params_int8({key: x}))
                continue
        out[key] = x
    return out


def build_model(model: str, params: Optional[Mapping[str, torch.Tensor]],
                *, n_slots: int, max_seq_len: Optional[int],
                model_overrides: Optional[Dict[str, Any]], param_dtype: Any,
                prefill_bucket: int, page_size: int, max_pages: int,
                quantize: Optional[str], kv_cache_dtype: str, seed: int,
                device: torch.device) -> Tuple[Any, Any]:
    """The engines' model and config, as the reference's InferenceEngine
    builds them: the arguments validated, the page pool sized (every slot
    can fill its row, +1 for the null page, unless max_pages), and the
    weights loaded from `params` or drawn from `seed`."""
    if page_size < 0 or page_size & (page_size - 1):
        raise ValueError(f'page_size must be 0 (unpaged) or a power of '
                         f'two, got {page_size}')
    if page_size and max(1, prefill_bucket) % page_size:
        raise ValueError(f'page_size ({page_size}) must divide '
                         f'prefill_bucket ({prefill_bucket})')
    if max_pages and not page_size:
        raise ValueError('max_pages requires page_size > 0')
    overrides = dict(model_overrides or {})
    overrides.setdefault('param_dtype', param_dtype)
    overrides.setdefault('kv_cache_dtype', kv_cache_dtype)
    overrides['quantize'] = quantize
    if max_seq_len is not None:
        overrides['max_seq_len'] = max_seq_len
    peek = models_lib.get_config(model, **overrides)
    if page_size:
        if peek.max_seq_len % page_size:
            raise ValueError(f'page_size ({page_size}) must divide '
                             f'max_seq_len ({peek.max_seq_len})')
        overrides.setdefault('kv_page_size', page_size)
        overrides.setdefault('kv_n_pages', max_pages if max_pages else
                             n_slots * (peek.max_seq_len // page_size) + 1)
    net, config = models_lib.get_model(model, device=device, **overrides)
    net.eval()
    with torch.no_grad():
        if params is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            net.init_weights(gen)
        else:
            net.load_state_dict(_serving_params(params, config))
    return net, config


# -- paged cache ops (in place) ----------------------------------------------
def _kv_pairs(a: Any, b: Any) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(a's, b's) K, V and, for an int8 cache, scale tensors, paired."""
    pairs = [(a.key, b.key), (a.value, b.value)]
    if a.key_scale is not None:
        pairs += [(a.key_scale, b.key_scale), (a.value_scale, b.value_scale)]
    return pairs


def paged_insert(cache: PagedCache, cache1: PrefillCache,
                 table_row: np.ndarray, slot: int,
                 copy_start_page: int = 0) -> None:
    """Scatter the batch-1 contiguous prefill cache [L, 1, kvh, S, d]
    into the slot's pool pages [L, n_pages, kvh, ps, d] (in place), the
    scale siblings [.., 1] of an int8 cache likewise, and write its
    block-table row.  `table_row` [pps] lists the slot's pages and is 0
    (the null page) past them; the null page is left as it is, and so
    are the pages below `copy_start_page`: a shared prefix already in
    the pool, never rewritten (the reference sends their writes to the
    null page)."""
    ps = cache.key.shape[3]
    n_used = int(np.count_nonzero(table_row))
    phys = torch.as_tensor(table_row[copy_start_page:n_used],
                           dtype=torch.long, device=cache.key.device)
    for pool, src in _kv_pairs(cache, cache1):
        L, _, kvh, s, d = src.shape
        content = src[:, 0].reshape(L, kvh, s // ps, ps, d)
        pool[:, phys] = content[:, :, copy_start_page:n_used].transpose(
            1, 2).to(pool.dtype)
    set_table(cache, table_row, slot)


def hydrate(cache1: PrefillCache, cache: PagedCache, table_row: np.ndarray,
            shared_pages: int, shared_len: int) -> None:
    """Prefix hit (the reference's `_hydrate`): gather the slot's
    `shared_pages` leading pages of every layer from the pools, and the
    scale pools of an int8 cache, into the first `shared_len` positions
    of the batch-1 prefill cache, and set its cursor to `shared_len`, so
    the suffix chunks attend to the shared prefix without prefilling it
    again.  Positions past the prefix are left as they are: each is
    written by a suffix chunk before a row reads it, or masked off."""
    phys = torch.as_tensor(table_row[:shared_pages], dtype=torch.long,
                           device=cache.key.device)
    for pool, dst in _kv_pairs(cache, cache1):
        L, _, kvh, _, d = dst.shape
        dst[:, 0, :, :shared_len] = pool[:, phys].transpose(1, 2).reshape(
            L, kvh, shared_len, d)
    cache1.cursor = shared_len


def slot_insert(cache: SlotCache, cache1: PrefillCache, slot: int) -> None:
    """Copy the batch-1 prefill cache [L, 1, kvh, max_len, d] into the
    slot's row of the contiguous slot cache (in place), the scale rows of
    an int8 cache likewise: the reference's `make_insert_fn`."""
    for rows, src in _kv_pairs(cache, cache1):
        rows[:, slot] = src[:, 0]


def set_table(cache: PagedCache, table_row: np.ndarray, slot: int) -> None:
    """Write a slot's block-table row (in place)."""
    cache.table[slot] = torch.as_tensor(table_row, dtype=torch.int32,
                                        device=cache.table.device)


def clear_table(cache: PagedCache, slot: int) -> None:
    """Point a dead slot's table row at the null page (in place), so its
    leftover writes can never land on pages now owned by another
    request."""
    cache.table[slot] = 0


@dataclasses.dataclass
class _Slot:
    """Host-side state of one occupied decode slot."""
    request_id: int
    prompt_len: int           # true prompt length (rope base)
    pad_len: int              # bucketed prefill length (cache cursor base)
    max_new: int
    eos_id: Optional[int]
    temperature: float
    top_k: int
    top_p: float
    seed: int = 0
    generated: int = 0
    outputs: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _PendingPrefill:
    """A reserved slot whose prompt is being prefilled in chunks."""
    slot_idx: int
    rid: int
    cfg: SamplingConfig
    true_len: int
    pad: int
    tokens: np.ndarray        # [1, pad]
    mask_row: torch.Tensor    # [max_seq] bool on the device
    cache1: Optional[PrefillCache]
    pages: List[int]          # empty when unpaged
    table_row: Optional[np.ndarray]   # [pages_per_slot] int32, 0-filled
                                      # tail; None when unpaged
    done: int = 0
    shared_len: int = 0       # prefix positions already in the pool
    last_row: Optional[torch.Tensor] = None   # logits at the last token


class ContinuousBatchingEngine:
    """Slot-based continuous batching over the KV-cache model: a
    contiguous slot cache by default (page_size 0), a page pool with
    page_size > 0."""

    def __init__(self, model: str = 'llama-tiny',
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 n_slots: int = 4,
                 max_seq_len: Optional[int] = None,
                 model_overrides: Optional[Dict[str, Any]] = None,
                 param_dtype: Any = torch.bfloat16,
                 prefill_bucket: int = 64,
                 prefill_chunk: int = 0,
                 kv_read_bucket: int = 512,
                 page_size: int = 0,
                 max_pages: int = 0,
                 seed: int = 0,
                 decode_kernel: str = 'auto',
                 prefill_kernel: str = 'auto',
                 kv_cache_dtype: str = 'auto',
                 quantize: Optional[str] = None,
                 device: DeviceLike = 'cuda') -> None:
        self.device = resolve_device(device)
        self.model, self.config = build_model(
            model, params, n_slots=n_slots, max_seq_len=max_seq_len,
            model_overrides=model_overrides, param_dtype=param_dtype,
            prefill_bucket=prefill_bucket, page_size=page_size,
            max_pages=max_pages, quantize=quantize,
            kv_cache_dtype=kv_cache_dtype, seed=seed, device=self.device)
        self.loaded_real_weights = params is not None
        kernels = resolve_kernels(decode_kernel, prefill_kernel,
                                  on_cuda=self.device.type == 'cuda',
                                  page_size=page_size)
        self.decode_kernel = kernels['decode']
        self.prefill_kernel = kernels['prefill']
        self.kv_cache_dtype = self.config.kv_cache_dtype
        self._model_name = str(model)
        self.n_slots = n_slots
        self.max_seq_len = self.config.max_seq_len
        self.page_size = page_size
        self.n_pages = self.config.kv_n_pages
        self.prefill_bucket = max(1, prefill_bucket)
        self.prefill_chunk = prefill_chunk
        self.kv_read_bucket = kv_read_bucket
        self._alloc: Optional[paging_lib.PageAllocator] = None
        self._cache: Any
        if page_size:
            self._pages_per_slot = self.max_seq_len // page_size
            self._alloc = paging_lib.PageAllocator(self.n_pages, page_size)
            self._cache = PagedCache.zeros(self.config, n_slots, self.device)
        else:
            self._cache = SlotCache.zeros(self.config, n_slots, self.device)
        self._last = torch.zeros((n_slots, self.config.vocab_size),
                                 dtype=torch.float32, device=self.device)
        self._kv_mask = torch.zeros((n_slots, self.max_seq_len),
                                    dtype=torch.bool, device=self.device)
        self._slots: List[Optional[_Slot]] = [None] * n_slots
        self._prefills: List[_PendingPrefill] = []
        self._queue: Any = collections.deque()
        self._results: Dict[int, List[int]] = {}
        self._events: Dict[int, threading.Event] = {}
        self._errors: Dict[int, BaseException] = {}
        self._deadlines: Dict[int, float] = {}
        self._canceled: set = set()
        self._admitting_rid: Optional[int] = None
        self._fatal: Optional[BaseException] = None
        self._submit_lock = threading.Lock()
        self._next_rid = 0
        self._seed0 = seed
        # Prompt pages found in the pool at admission, and allocated.
        self.prefix_hit_pages = 0
        self.prefix_miss_pages = 0

    # -- request intake ----------------------------------------------------
    def _page_need(self, true_len: int,
                   cfg: SamplingConfig) -> Tuple[int, int]:
        """(pad, pages) one request holds at admission: the prompt padded
        to its prefill bucket, plus the decode budget, in pages."""
        b = self.prefill_bucket
        pad = min(((true_len + b - 1) // b) * b, self.max_seq_len)
        pad = max(pad, true_len)
        pad = min(pad, self.max_seq_len - cfg.max_new_tokens)
        pad = max(pad, true_len)
        need = 0
        if self.page_size:
            need = min(-(-(pad + cfg.max_new_tokens) // self.page_size),
                       self._pages_per_slot)
        return pad, need

    def submit(self, prompt_ids: Sequence[int],
               sampling: Optional[SamplingConfig] = None,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue one prompt; returns a request id for wait().
        `deadline_s` is a relative budget: the request expires in the
        queue once it passes, and wait() blocks at most until it."""
        cfg = sampling or SamplingConfig()
        if len(prompt_ids) == 0:
            raise ValueError('empty prompt')
        if any(not 0 <= int(t) < self.config.vocab_size
               for t in prompt_ids):
            raise ValueError(f'prompt token ids must lie in '
                             f'[0, {self.config.vocab_size})')
        if deadline_s is not None and float(deadline_s) <= 0:
            raise ValueError(f'deadline_s must be > 0, got {deadline_s}')
        if cfg.max_new_tokens < 1:
            raise ValueError(
                f'max_new_tokens must be >= 1, got {cfg.max_new_tokens}')
        if len(prompt_ids) + cfg.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f'prompt ({len(prompt_ids)}) + max_new_tokens '
                f'({cfg.max_new_tokens}) exceeds max_seq_len '
                f'{self.max_seq_len}.')
        pad, need = self._page_need(len(prompt_ids), cfg)
        if self._alloc is not None and need > self._alloc.capacity:
            raise ValueError(
                f'request needs {need} KV pages (prompt padded to {pad}, '
                f'+ max_new_tokens {cfg.max_new_tokens}, page_size '
                f'{self.page_size}) but the pool holds only '
                f'{self._alloc.capacity}')
        if cfg.seed is not None:
            try:
                cfg = dataclasses.replace(cfg,
                                          seed=int(cfg.seed) & 0x7FFFFFFF)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f'seed must be an integer: {cfg.seed!r}') from e
        with self._submit_lock:
            if self._fatal is not None:
                raise RuntimeError(
                    f'engine aborted: {self._fatal!r}') from self._fatal
            rid = self._next_rid
            self._next_rid += 1
            self._events[rid] = threading.Event()
            deadline = None
            if deadline_s is not None:
                deadline = time.monotonic() + float(deadline_s)
                self._deadlines[rid] = deadline
            self._queue.append((rid, [int(t) for t in prompt_ids], cfg,
                                deadline))
        return rid

    def cancel(self, request_id: int) -> None:
        """Drop a request wherever it is (queued, prefilling, decoding,
        or done but unread)."""
        with self._submit_lock:
            self._queue = collections.deque(
                item for item in self._queue if item[0] != request_id)
            self._results.pop(request_id, None)
            self._events.pop(request_id, None)
            self._errors.pop(request_id, None)
            self._deadlines.pop(request_id, None)
            in_engine = request_id == self._admitting_rid or any(
                p.rid == request_id for p in self._prefills) or any(
                s is not None and s.request_id == request_id
                for s in self._slots)
            if in_engine:
                self._canceled.add(request_id)

    def wait(self, request_id: int,
             timeout: Optional[float] = None) -> List[int]:
        """Block until `request_id` finishes; returns its token ids.  On
        timeout the request is canceled and TimeoutError raised (its
        deadline's DeadlineExceededError without an explicit timeout)."""
        with self._submit_lock:
            event = self._events[request_id]
            deadline = self._deadlines.get(request_id)
        from_deadline = timeout is None and deadline is not None
        if from_deadline:
            timeout = max(0.0, deadline - time.monotonic())
        if not event.wait(timeout):
            self.cancel(request_id)
            if from_deadline:
                raise failures.DeadlineExceededError(
                    f'request {request_id} missed its deadline')
            raise TimeoutError(f'request {request_id} not done')
        with self._submit_lock:
            self._events.pop(request_id, None)
            self._deadlines.pop(request_id, None)
            err = self._errors.pop(request_id, None)
            if err is not None:
                self._results.pop(request_id, None)
                raise err
            if request_id not in self._results:
                raise RuntimeError(f'engine aborted: {self._fatal!r}') \
                    from self._fatal
            return self._results.pop(request_id)

    def abort(self, error: BaseException) -> None:
        """Fatal failure: stop serving, fail every waiter fast, and hand
        in-flight pages back so page accounting ends clean."""
        with self._submit_lock:
            self._fatal = error
            self._queue.clear()
            events = list(self._events.values())
        for i, s in enumerate(self._slots):
            if s is not None:
                self._release_pages(s.pages)
                self._slots[i] = None
        for p in self._prefills:
            self._release_pages(p.pages)
        self._prefills = []
        for e in events:
            e.set()

    def _fail_request(self, rid: int, error: BaseException) -> None:
        with self._submit_lock:
            self._errors[rid] = error
            self._results.pop(rid, None)
            self._deadlines.pop(rid, None)
            event = self._events.get(rid)
        if event is not None:
            event.set()

    # -- the decode loop ---------------------------------------------------
    def _release_pages(self, pages: List[int]) -> None:
        for page in pages:
            self._alloc.release(page)

    def _admit(self, slot_idx: int, rid: int, prompt: List[int],
               cfg: SamplingConfig) -> bool:
        """Reserve `slot_idx` for `rid` and start (or, without chunking,
        finish) its prefill.  False, without consuming the slot, when the
        pool cannot cover the request right now (backpressure)."""
        true_len = len(prompt)
        pad, need = self._page_need(true_len, cfg)
        pages: List[int] = []
        shared: List[int] = []
        table_row = None
        if self._alloc is not None:
            ps = self.page_size
            # Prefix sharing: reuse every page-aligned prompt page already
            # in the pool, one page short of the prompt's end at most: its
            # last token always prefills, as its logits seed decode.
            cap = min((true_len - 1) // ps, need)
            shared = self._alloc.lookup_prefix(prompt, max_pages=cap)
            fresh = self._alloc.alloc(need - len(shared))
            if fresh is None:
                self._release_pages(shared)
                return False
            self.prefix_hit_pages += len(shared)
            self.prefix_miss_pages += len(fresh)
            pages = shared + fresh
            table_row = np.zeros((self._pages_per_slot,), np.int32)
            table_row[:len(pages)] = pages
        shared_len = len(shared) * self.page_size
        tokens = np.zeros((1, pad), np.int64)
        tokens[0, :true_len] = prompt
        try:
            mask_row = torch.zeros((self.max_seq_len,), dtype=torch.bool,
                                   device=self.device)
            mask_row[:true_len] = True
            cache1 = PrefillCache.zeros(self.config, 1, self.device)
            if shared_len:
                hydrate(cache1, self._cache, table_row, len(shared),
                        shared_len)
        except Exception:
            self._release_pages(pages)
            raise
        pending = _PendingPrefill(
            slot_idx=slot_idx, rid=rid, cfg=cfg, true_len=true_len,
            pad=pad, tokens=tokens, mask_row=mask_row, cache1=cache1,
            pages=pages, table_row=table_row, done=shared_len,
            shared_len=shared_len)
        self._prefills.append(pending)
        if self.prefill_chunk <= 0:
            try:
                while pending.done < pending.pad:
                    self._prefill_chunk_step(pending)
            except Exception:
                self._prefills.remove(pending)
                self._release_pages(pages)
                raise
            self._prefills.remove(pending)
            self._finish_prefill(pending)
        return True

    @torch.no_grad()
    def _prefill_chunk_step(self, pending: _PendingPrefill) -> None:
        """Run the next prompt chunk through the batch-1 forward; its K/V
        land at the prefill cache's cursor (global-cursor causal path,
        never the slot path)."""
        chunk = self.prefill_chunk if self.prefill_chunk > 0 \
            else pending.pad
        start = pending.done
        size = min(chunk, pending.pad - start)
        tokens = torch.as_tensor(pending.tokens[:, start:start + size],
                                 device=self.device)
        positions = torch.arange(start, start + size,
                                 device=self.device)[None]
        read_len = None
        if self.kv_read_bucket > 0:
            # Chunk reads only need columns < start + size (causal).
            gran = self.kv_read_bucket
            read_len = min(self.max_seq_len,
                           ((start + size + gran - 1) // gran) * gran)
        x = self.model.hidden(tokens, positions, pending.cache1,
                              pending.mask_row[None],
                              kernel=self.prefill_kernel,
                              read_len=read_len)
        last_idx = pending.true_len - 1
        if start <= last_idx < start + size:
            pending.last_row = self.model.head(x[0, last_idx - start])
        pending.done = start + size
        if pending.done >= pending.true_len:
            # The rest of the padded length is masked-off zeros decode
            # never reads: skip those chunks.
            pending.done = pending.pad

    def _finish_prefill(self, pending: _PendingPrefill) -> None:
        """Insert the prefilled request into its slot and make it live."""
        assert pending.last_row is not None
        slot = pending.slot_idx
        if self.page_size:
            paged_insert(self._cache, pending.cache1, pending.table_row,
                         slot, pending.shared_len // self.page_size)
            # Publish the prompt's full pages, so that later requests with
            # the same page-aligned prefix prefill it once.
            self._alloc.register_prefix(
                pending.tokens[0, :pending.true_len].tolist(), pending.pages)
        else:
            slot_insert(self._cache, pending.cache1, slot)
        pending.cache1 = None
        self._last[slot] = pending.last_row
        self._kv_mask[slot] = pending.mask_row
        cfg = pending.cfg
        seed = cfg.seed if cfg.seed is not None else (
            hash((self._seed0, pending.rid)) & 0x7FFFFFFF)
        self._slots[slot] = _Slot(
            request_id=pending.rid, prompt_len=pending.true_len,
            pad_len=pending.pad, max_new=cfg.max_new_tokens,
            eos_id=cfg.eos_id, temperature=cfg.temperature,
            top_k=cfg.top_k, top_p=cfg.top_p, seed=seed,
            pages=pending.pages)

    def _commit_token(self, slot_idx: int, tok: int) -> bool:
        """Append one token; complete the slot on eos or budget."""
        s = self._slots[slot_idx]
        s.outputs.append(tok)
        s.generated += 1
        if (s.eos_id is not None and tok == s.eos_id) or \
                s.generated >= s.max_new:
            self._complete(slot_idx)
            return True
        return False

    def _complete(self, slot_idx: int) -> None:
        slot = self._slots[slot_idx]
        self._release_pages(slot.pages)
        if self.page_size:
            clear_table(self._cache, slot_idx)
        rid = slot.request_id
        with self._submit_lock:
            was_canceled = rid in self._canceled
            self._canceled.discard(rid)
            event = None
            if not was_canceled:
                self._results[rid] = slot.outputs
                event = self._events.get(rid)
            self._deadlines.pop(rid, None)
        self._slots[slot_idx] = None
        if event is not None:
            event.set()

    def _evict_canceled(self) -> None:
        with self._submit_lock:
            snapshot = set(self._canceled)
        for i, s in enumerate(self._slots):
            if s is not None and s.request_id in snapshot:
                self._release_pages(s.pages)
                if self.page_size:
                    clear_table(self._cache, i)
                self._slots[i] = None
        keep = []
        for p in self._prefills:
            if p.rid in snapshot:
                self._release_pages(p.pages)
            else:
                keep.append(p)
        self._prefills = keep
        with self._submit_lock:
            self._canceled -= snapshot

    def _schedule_front(self) -> None:
        """Cancellation eviction, FIFO admission into free slots, and one
        prefill chunk for every pending prompt."""
        self._evict_canceled()
        reserved = {p.slot_idx for p in self._prefills}
        free = [i for i, s in enumerate(self._slots)
                if s is None and i not in reserved]
        now = time.monotonic()
        while free:
            with self._submit_lock:
                item = self._queue.popleft() if self._queue else None
                if item is not None:
                    self._admitting_rid = item[0]
            if item is None:
                break
            rid, prompt, cfg, deadline = item
            try:
                if deadline is not None and now > deadline:
                    self._fail_request(rid, failures.DeadlineExceededError(
                        f'request {rid} expired in queue before '
                        'admission'))
                    continue
                admitted = self._admit(free[0], rid, prompt, cfg)
            except Exception as e:  # pylint: disable=broad-except
                # Admission touches only this request's private state.
                self._fail_request(rid, failures.wrap_abort(rid, e))
                continue
            finally:
                with self._submit_lock:
                    self._admitting_rid = None
            if admitted:
                free.pop(0)
                continue
            # Backpressure: requeue at the front, let decode drain pages.
            with self._submit_lock:
                if rid in self._canceled:
                    self._canceled.discard(rid)
                else:
                    self._queue.appendleft(item)
            break
        still_pending = []
        for pending in self._prefills:
            try:
                self._prefill_chunk_step(pending)
            except Exception as e:  # pylint: disable=broad-except
                self._release_pages(pending.pages)
                self._fail_request(pending.rid,
                                   failures.wrap_abort(pending.rid, e))
                continue
            if pending.done >= pending.pad:
                self._finish_prefill(pending)
            else:
                still_pending.append(pending)
        self._prefills = still_pending

    def _decode_inputs(self, occupied: List[int]) -> Dict[str, Any]:
        """Host-side inputs of the next decode step for `occupied`."""
        b = self.n_slots
        cursors = np.zeros((b,), np.int64)
        rope = np.zeros((b,), np.int64)
        active = np.zeros((b,), bool)
        temps = np.zeros((b,), np.float32)
        top_ks = np.zeros((b,), np.int64)
        top_ps = np.ones((b,), np.float32)
        generators: List[Optional[torch.Generator]] = [None] * b
        for i in occupied:
            s = self._slots[i]
            cursors[i] = s.pad_len + s.generated
            rope[i] = s.prompt_len + s.generated
            active[i] = True
            temps[i] = s.temperature
            top_ks[i] = s.top_k
            top_ps[i] = s.top_p
            if s.temperature > 0:
                generators[i] = row_generator(s.seed, s.generated,
                                              self.device)
        max_k = top_k_bucket(int(top_ks.max()), self.config.vocab_size)
        use_top_p = bool((top_ps < 1.0).any())
        if self.kv_read_bucket > 0:
            live = int(cursors[occupied].max()) + 1
            gran = self.kv_read_bucket
            bucket = min(self.max_seq_len, ((live + gran - 1) // gran) * gran)
        else:
            bucket = self.max_seq_len
        dev = self.device
        return dict(
            cursors=torch.as_tensor(cursors, device=dev),
            rope=torch.as_tensor(rope, device=dev),
            active=torch.as_tensor(active, device=dev),
            temps=torch.as_tensor(temps, device=dev),
            top_ks=torch.as_tensor(top_ks, device=dev),
            top_ps=torch.as_tensor(top_ps, device=dev),
            generators=generators, max_k=max_k, use_top_p=use_top_p,
            top_p_in_topk=bool(use_top_p and max_k > 0 and
                               (top_ks[top_ps < 1.0] > 0).all()),
            bucket=bucket)

    def _decode_forward(self, inp: Dict[str, Any], kernel: str
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
        """Sample every slot's next token from the last logits, reveal
        each active slot's write position in a copy of the kv mask, and
        run the one-token forward.  Returns (tokens [B], logits [B, V],
        the revealed mask); the K/V of the step are written in place."""
        tok = sample_logits_rows(
            self._last, inp['generators'], inp['temps'], inp['top_ks'],
            inp['top_ps'], max_k=inp['max_k'], use_top_p=inp['use_top_p'],
            top_p_in_topk=inp['top_p_in_topk'])
        rows = torch.arange(self.n_slots, device=self.device)
        kv_mask = self._kv_mask.clone()
        kv_mask[rows, inp['cursors']] |= inp['active']
        logits = self.model(tok[:, None], inp['rope'][:, None], self._cache,
                            kv_mask, kernel=kernel,
                            read_len=inp['bucket'])
        return tok, logits[:, 0], kv_mask

    @torch.no_grad()
    def decode_logits(self, kernel: str) -> torch.Tensor:
        """The logits [B, V] the next decode step computes for the
        occupied slots, with `kernel` ('fused' or 'xla'), committing
        nothing: the step rewrites the same K/V when it runs.  For holding
        the kernels against their plain versions on the serving path."""
        occupied = [i for i, s in enumerate(self._slots) if s is not None]
        if not occupied:
            raise RuntimeError('no occupied slot to decode')
        return self._decode_forward(self._decode_inputs(occupied),
                                    kernel)[1]

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler tick: admission and prefill chunks, then one
        decode step for all occupied slots.  False when fully idle."""
        self._schedule_front()
        occupied = [i for i, s in enumerate(self._slots) if s is not None]
        if not occupied:
            return bool(self._prefills) or bool(self._queue)
        rids = [self._slots[i].request_id for i in occupied]
        inp = self._decode_inputs(occupied)
        tok, self._last, self._kv_mask = self._decode_forward(
            inp, self.decode_kernel)
        toks = tok.cpu().numpy()
        for i, rid in zip(occupied, rids):
            s = self._slots[i]
            if s is not None and s.request_id == rid:
                self._commit_token(i, int(toks[i]))
        return True

    def run_until_idle(self) -> None:
        while self.step():
            pass

    # -- outlook -------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def is_idle(self) -> bool:
        return not self._queue and not self._prefills \
            and all(s is None for s in self._slots)

    def allocator_leak_report(self) -> Optional[str]:
        """None when the page pool is clean (or unpaged), else what
        leaked."""
        return None if self._alloc is None else self._alloc.leak_report()

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: Optional[SamplingConfig] = None
                 ) -> List[List[int]]:
        """Submit `prompts` (more than n_slots queue) and drive the loop
        until all finish."""
        rids = [self.submit(p, sampling) for p in prompts]
        pending = set(rids)
        while pending:
            if not self.step():
                break
            with self._submit_lock:
                pending = {r for r in rids
                           if r in self._events
                           and not self._events[r].is_set()}
        return [self.wait(r, timeout=0.001) for r in rids]


class InferenceEngine:
    """Request-level batching over a contiguous KV cache: the reference's
    `InferenceEngine`, which the server runs with --no-continuous.

    `generate` takes up to max_batch_size prompts at once: it right-pads
    them to a bucketed length s_max and prefills the batch at
    max_batch_size into a contiguous `PrefillCache` at its global
    cursor; each decode step then writes every row's token at the cursor
    s_max + step with rope position length + step, the kv mask revealing
    it for the rows still active, and each row stops at its eos.  No
    kernel runs, by the reference's design (its fused kernels need a
    paged cache); with page_size > 0 `generate` raises, as the
    reference's does.  Greedy rows take the first maximum; a sampled row
    i draws its token t from `row_generator(hash((seed, i)), t)`, seeded
    from the request's seed or else from the engine's and the call's."""

    def __init__(self, model: str = 'llama-tiny',
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 max_batch_size: int = 4,
                 max_seq_len: Optional[int] = None,
                 model_overrides: Optional[Dict[str, Any]] = None,
                 param_dtype: Any = torch.bfloat16,
                 prefill_bucket: int = 64,
                 quantize: Optional[str] = None,
                 kv_cache_dtype: str = 'auto',
                 page_size: int = 0,
                 seed: int = 0,
                 device: DeviceLike = 'cuda') -> None:
        self.device = resolve_device(device)
        self.model, self.config = build_model(
            model, params, n_slots=max_batch_size, max_seq_len=max_seq_len,
            model_overrides=model_overrides, param_dtype=param_dtype,
            prefill_bucket=prefill_bucket, page_size=page_size, max_pages=0,
            quantize=quantize, kv_cache_dtype=kv_cache_dtype, seed=seed,
            device=self.device)
        self.page_size = page_size
        self.max_batch = max_batch_size
        self.max_seq_len = self.config.max_seq_len
        self.prefill_bucket = max(1, prefill_bucket)
        self._seed0 = seed
        self._generation = 0

    def _bucketed(self, s_max: int) -> int:
        b = self.prefill_bucket
        return min(((s_max + b - 1) // b) * b, self.max_seq_len)

    @torch.no_grad()
    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: Optional[SamplingConfig] = None
                 ) -> List[List[int]]:
        """Continuations of up to max_batch_size prompts of (possibly)
        different lengths, one token-id list each."""
        if self.page_size:
            raise RuntimeError(
                'paged KV cache (page_size > 0) requires slot-mode '
                'serving — use ContinuousBatchingEngine')
        cfg = sampling or SamplingConfig()
        n = len(prompts)
        if n == 0:
            return []
        if n > self.max_batch:
            raise ValueError(
                f'{n} prompts > max_batch_size={self.max_batch}.')
        lengths = np.array([len(p) for p in prompts], np.int64)
        if (lengths <= 0).any():
            raise ValueError('empty prompt')
        if any(not 0 <= int(t) < self.config.vocab_size
               for p in prompts for t in p):
            raise ValueError(f'prompt token ids must lie in '
                             f'[0, {self.config.vocab_size})')
        lmax = int(lengths.max())
        if lmax + cfg.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f'prompt ({lmax}) + max_new_tokens ({cfg.max_new_tokens}) '
                f'exceeds max_seq_len {self.max_seq_len}.')
        # The padded length is bucketed (near max_seq_len it is clamped
        # to leave room for the new tokens).
        s_max = max(min(self._bucketed(lmax),
                        self.max_seq_len - cfg.max_new_tokens), lmax)
        b = self.max_batch
        dev = self.device
        tokens = np.zeros((b, s_max), np.int64)
        kv_mask = torch.zeros((b, self.max_seq_len), dtype=torch.bool,
                              device=dev)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = [int(t) for t in p]
            kv_mask[i, :len(p)] = True
        full_lengths = np.zeros((b,), np.int64)
        full_lengths[:n] = lengths
        lengths_t = torch.as_tensor(full_lengths, device=dev)
        cache = PrefillCache.zeros(self.config, b, dev)
        x = self.model.hidden(torch.as_tensor(tokens, device=dev),
                              torch.arange(s_max, device=dev).expand(
                                  b, s_max), cache, kv_mask)
        rows = torch.arange(b, device=dev)
        last = self.model.head(x[rows, (lengths_t - 1).clamp(min=0)])
        del x
        self._generation += 1
        seed = (int(cfg.seed) if cfg.seed is not None
                else hash((self._seed0, self._generation))) & 0x7FFFFFFF
        temps = torch.full((b,), cfg.temperature, dtype=torch.float32,
                           device=dev)
        top_ks = torch.full((b,), cfg.top_k, dtype=torch.int64, device=dev)
        top_ps = torch.full((b,), cfg.top_p, dtype=torch.float32,
                            device=dev)
        max_k = top_k_bucket(cfg.top_k, self.config.vocab_size)
        outputs: List[List[int]] = [[] for _ in range(n)]
        done = np.zeros((b,), bool)
        done[n:] = True
        for t in range(cfg.max_new_tokens):
            gens = [row_generator(hash((seed, i)), t, dev)
                    if cfg.temperature > 0 else None for i in range(b)]
            tok = sample_logits_rows(
                last, gens, temps, top_ks, top_ps, max_k=max_k,
                use_top_p=cfg.top_p < 1.0,
                top_p_in_topk=cfg.top_k > 0 and cfg.top_p < 1.0)
            active = torch.as_tensor(~done, device=dev)
            toks = tok.cpu().numpy()
            for i in range(n):
                if not done[i]:
                    outputs[i].append(int(toks[i]))
                    if cfg.eos_id is not None and \
                            int(toks[i]) == cfg.eos_id:
                        done[i] = True
            if done.all() or t + 1 == cfg.max_new_tokens:
                break
            # The step's token lands at the cursor s_max + t, revealed for
            # the rows that were active when it was sampled.
            kv_mask[:, s_max + t] = active
            last = self.model(tok[:, None], (lengths_t + t)[:, None], cache,
                              kv_mask)[:, 0]
        return outputs

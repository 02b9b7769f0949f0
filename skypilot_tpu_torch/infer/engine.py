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
    just before its use (models/llama.py);
  - with spec_k > 0 each step is a speculative verify
    (infer/speculative.py): every live row feeds its pending token and
    k proposals (n-gram self-drafting, or a draft model's greedy steps)
    through one S = k + 1 slot forward, acceptance keeps the longest
    prefix the target agrees with plus one sampled token, and only
    those are revealed in the kv mask; a slot's first token is sampled
    at prefill end, with the draw plain decode's first step makes;
  - with prefill_mix_budget > 0 a prompt is not prefilled on dedicated
    ticks: admission reserves the slot, and up to the budget of prompt
    tokens a step ride the decode step's slot forward (S = the budget,
    at least 2; with speculation, the k + 1 verify window), written
    straight into the slot's cache row or pages; decode rows feed their
    token at query 0 and commit one token.  A plain decode step is the
    same step function at S = 1 with no prompt riding it;
  - with async_pipeline (the default, as the reference's) each tick is
    double-buffered: the host front (admission, prefill chunks) runs
    while the step dispatched last tick runs on the device, then that
    step is joined and its tokens committed, then the next step is
    dispatched (`_step_async`).  There is no fetch thread: a dispatch
    enqueues a non-blocking copy of the step's tokens into pinned host
    memory and records a CUDA event behind it, and the join waits on
    the event.  async_pipeline=False is the synchronous tick
    (`_step_sync`);
  - on the card, with the paged-decode kernel, the S = 1 paged decode
    forward (no prompt riding the step) is replayed from one CUDA graph
    per read bucket (infer/graphs.py), the counterpart of the
    reference's compiled step; verify and mixed steps, the unpaged
    cache and a draft model's steps run eagerly.
`InferenceEngine` prefills a whole batch of right-padded prompts at once
into a contiguous cache and decodes it in lockstep; it runs no kernel,
as the reference's does not.

Attention runs through the kernels' wrappers ('fused': the CUDA kernels
on the card, their plain versions on the CPU) or the reference's XLA
read in plain PyTorch ('xla'); `resolve_kernels` picks, as the
reference's table does: 'auto' is 'fused' on CUDA with a paged cache,
else 'xla', and 'fused' without a paged cache is a ValueError.

Not ported yet (later slices): disaggregated handoff, live migration,
the host-RAM tier, recovery, metrics and traces.

Weights come from `params` (a state_dict), from `checkpoint_dir` (the
params item of the latest step of a port checkpoint,
train/checkpoint.py `load_params_for_serving`; a LoRA checkpoint serves
with the same `lora_rank` in `model_overrides`, and its adapters apply
in every forward, the captured decode graphs too), or at random from
`seed`.

Thread model: submit()/cancel()/wait() are thread-safe; step() must be
driven by ONE thread (the server's decode loop).  The readers of engine
state (`decode_logits`, `mixed_logits`, `verify_logits`,
`speculation_info`, `allocator_leak_report`) take the step lock and
join the step in flight first, so they may run on another thread.
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
from skypilot_tpu_torch.infer import graphs as graphs_lib
from skypilot_tpu_torch.infer import paging as paging_lib
from skypilot_tpu_torch.infer import speculative as spec_lib
from skypilot_tpu_torch.models.llama import (PagedCache, PrefillCache,
                                             SlotCache, quant_axis,
                                             quantizable,
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
    `quantize_params_int8` in the port's layout: every entry
    `llama.quantizable` names (the [out, in] matmul weights, lm_head, the
    router and tok_embed) becomes int8 at its key with f32 scales at
    `<key>_scale`, one per output row ([out, 1]; tok_embed's over its
    vocab axis, [1, D]); the norms, biases, LoRA adapters, pos_embed and
    expert stacks stay float (the reference quantizes only kernels and
    the embedding).  Bit for bit the reference's on the same values, so
    cast to param_dtype first, as the reference's engine does."""
    out: Dict[str, torch.Tensor] = {}
    for key, x in params.items():
        if quantizable(key, x):
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
            if cfg.quantize and quantizable(key, x):
                out.update(quantize_params_int8({key: x}))
                continue
        out[key] = x
    return out


def build_model(model: str, params: Optional[Mapping[str, torch.Tensor]],
                *, n_slots: int, max_seq_len: Optional[int],
                model_overrides: Optional[Dict[str, Any]], param_dtype: Any,
                prefill_bucket: int, page_size: int, max_pages: int,
                quantize: Optional[str], kv_cache_dtype: str, seed: int,
                device: torch.device,
                checkpoint_dir: Optional[str] = None) -> Tuple[Any, Any]:
    """The engines' model and config, as the reference's InferenceEngine
    builds them: the arguments validated, the page pool sized (every slot
    can fill its row, +1 for the null page, unless max_pages), and the
    weights loaded from `params`, else from `checkpoint_dir`, else drawn
    from `seed`."""
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
    from_checkpoint = params is None and checkpoint_dir is not None
    if from_checkpoint:
        from skypilot_tpu_torch.train import checkpoint as ckpt_lib
        params = ckpt_lib.load_params_for_serving(
            ckpt_lib.make_manager(checkpoint_dir))
    if params is not None:
        _check_positions(params, config)
    with torch.no_grad():
        if params is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            net.init_weights(gen)
        elif from_checkpoint:
            try:
                net.load_state_dict(_serving_params(params, config))
            except RuntimeError as e:
                raise ValueError(f'checkpoint param tree does not match '
                                 f'model {config.name!r} (serve a LoRA '
                                 'checkpoint with its lora_rank in the '
                                 f'model overrides): {e}') from e
        else:
            net.load_state_dict(_serving_params(params, config))
    return net, config


def _check_positions(params: Mapping[str, torch.Tensor], cfg: Any) -> None:
    """A family with learned positions (gpt2) sizes pos_embed by
    max_seq_len: weights with another number of rows cannot serve this
    engine's max_seq_len (the reference's checkpoint hint)."""
    pos = params.get('pos_embed')
    if pos is not None and pos.shape[0] != cfg.max_seq_len:
        raise ValueError(
            f'model {cfg.name!r} has learned positions for '
            f'{pos.shape[0]} tokens (pos_embed), but the engine serves '
            f'max_seq_len {cfg.max_seq_len}: this family sizes pos_embed by '
            'max_seq_len; serve with the same max_seq_len the model was '
            'trained with')


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`.  To a card it goes through
    pinned memory and a non-blocking copy: a copy from pageable memory
    waits for the stream, and so for the step in flight."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != 'cuda':
        return t
    return t.pin_memory().to(device, non_blocking=True)


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
    phys = to_device(table_row[copy_start_page:n_used].astype(np.int64),
                     cache.key.device)
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
    phys = to_device(table_row[:shared_pages].astype(np.int64),
                     cache.key.device)
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
    cache.table[slot] = to_device(table_row.astype(np.int32),
                                  cache.table.device)


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
    prompt_ids: List[int] = dataclasses.field(default_factory=list)


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
    seed: int = 0             # the request's sampling seed
    # Mixed-batch prefill (prefill_mix_budget > 0): no prefill cache; the
    # prompt's chunks ride decode steps into the slot's row or pages.
    mixed: bool = False


class _InflightStep:
    """One dispatched decode step whose tokens are not committed yet (the
    reference's `_InflightStep`, without its metrics and chaos points).

    The dispatch fills every field: `host` is the step's tokens ([B], or
    a verify's [B, k + 1] tokens with the counts as a last column) on the
    host, complete once `event` has passed (a CUDA event recorded behind
    a non-blocking copy into pinned memory; None on the CPU, where the
    tensor is complete when the dispatch returns).  The consume half, on
    the thread that drives step(), commits them.  `rids` snapshots each
    occupied slot's request at dispatch, so a slot canceled or evicted
    before the join takes none of the step's tokens; `mix` lists the
    (pending, chunk length) of each prompt that rode the step, advanced
    at consume time."""

    __slots__ = ('mode', 'host', 'event', 'occupied', 'rids', 'mix',
                 'proposed', 't_enter', 't_dispatched')

    def __init__(self, mode: str, host: torch.Tensor, event: Any,
                 occupied: List[int], rids: List[int],
                 mix: List[Tuple['_PendingPrefill', int]], t_enter: float,
                 proposed: int = 0) -> None:
        self.mode = mode                  # 'plain' | 'mixed' | 'spec'
        self.host = host
        self.event = event
        self.occupied = occupied
        self.rids = rids
        self.mix = mix
        self.proposed = proposed          # a verify's proposed tokens
        self.t_enter = t_enter
        self.t_dispatched = time.perf_counter()


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
                 spec_k: int = 0,
                 draft_model: Optional[str] = None,
                 draft_params: Optional[Mapping[str, torch.Tensor]] = None,
                 draft_overrides: Optional[Dict[str, Any]] = None,
                 prefill_mix_budget: int = 0,
                 async_pipeline: bool = True,
                 checkpoint_dir: Optional[str] = None,
                 draft_checkpoint_dir: Optional[str] = None,
                 device: DeviceLike = 'cuda') -> None:
        if spec_k < 0:
            raise ValueError(f'spec_k must be >= 0, got {spec_k}')
        if draft_model is not None and spec_k <= 0:
            raise ValueError('draft_model requires spec_k > 0')
        prefill_mix_budget = int(prefill_mix_budget)
        if prefill_mix_budget < 0:
            raise ValueError(f'prefill_mix_budget must be >= 0, got '
                             f'{prefill_mix_budget}')
        self.device = resolve_device(device)
        self.model, self.config = build_model(
            model, params, n_slots=n_slots, max_seq_len=max_seq_len,
            model_overrides=model_overrides, param_dtype=param_dtype,
            prefill_bucket=prefill_bucket, page_size=page_size,
            max_pages=max_pages, quantize=quantize,
            kv_cache_dtype=kv_cache_dtype, seed=seed, device=self.device,
            checkpoint_dir=checkpoint_dir)
        self.loaded_real_weights = (params is not None
                                    or checkpoint_dir is not None)
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
        # Mixed-batch stepping: up to this many prompt tokens ride each
        # decode step (0: dedicated prefill ticks); its query width is
        # the budget, at least 2 (S = 1 is the decode layout).
        self.prefill_mix_budget = prefill_mix_budget
        self._mix_s = max(2, prefill_mix_budget) if prefill_mix_budget \
            else 0
        # Speculative decoding: k proposals a row a step, from a draft
        # model or (without one) n-gram self-drafting.
        self.spec_k = spec_k
        self._draft: Optional[spec_lib.DraftRunner] = None
        if spec_k and draft_model is not None:
            self._draft = spec_lib.DraftRunner(
                draft_model, draft_params,
                target_vocab_size=self.config.vocab_size, n_slots=n_slots,
                max_seq_len=self.max_seq_len, spec_k=spec_k,
                model_overrides=draft_overrides, param_dtype=param_dtype,
                prefill_bucket=prefill_bucket,
                kv_cache_dtype=kv_cache_dtype, page_size=page_size,
                kernels=kernels, seed=seed, device=self.device,
                checkpoint_dir=draft_checkpoint_dir)
        self.spec_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_committed = 0
        # The decode pipeline: with async_pipeline each tick dispatches
        # step N + 1 after joining step N, so the host front overlaps the
        # step in flight; depth is exactly 1 (`_inflight`).  The step lock
        # serialises step() with the readers of engine state.
        self.async_pipeline = bool(async_pipeline)
        self._inflight: Optional[_InflightStep] = None
        self._pipe_steps_overlapped = 0
        self._step_lock = threading.RLock()
        # The S = 1 paged decode forward, replayed from CUDA graphs.
        self._graphs: Optional[graphs_lib.DecodeGraphs] = None
        if self.device.type == 'cuda' and self.decode_kernel == 'fused':
            self._graphs = graphs_lib.DecodeGraphs(self.model, self._cache)

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
        in-flight pages back so page accounting ends clean; the step in
        flight is abandoned, never committed."""
        with self._step_lock:
            self._pipeline_abandon()
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
            pending = _PendingPrefill(
                slot_idx=slot_idx, rid=rid, cfg=cfg, true_len=true_len,
                pad=pad, tokens=tokens, mask_row=mask_row, cache1=None,
                pages=pages, table_row=table_row, done=shared_len,
                shared_len=shared_len,
                seed=cfg.seed if cfg.seed is not None else (
                    hash((self._seed0, rid)) & 0x7FFFFFFF))
            if self.prefill_mix_budget > 0:
                self._admit_mixed(pending)
                return True
            pending.cache1 = PrefillCache.zeros(self.config, 1, self.device)
            if shared_len:
                hydrate(pending.cache1, self._cache, table_row, len(shared),
                        shared_len)
        except Exception:
            self._release_pages(pages)
            raise
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

    def _admit_mixed(self, pending: _PendingPrefill) -> None:
        """Mixed-batch admission: no prefill cache and no insert; the
        prompt's chunks ride decode steps (`_dispatch_mixed`,
        `_dispatch_spec`) and write straight into the slot's cache row or
        pool pages.  This only reserves the slot and resets its kv-mask
        row; a shared prefix arrives revealed (its pages are in the pool),
        so nothing is hydrated.  The slot's block-table row is written
        when its first chunk rides (`_mix_rows`): until then the row's
        table is the null page's, so a step in which it rides no chunk
        writes its pad queries there and not into the shared prefix's
        last page (the reference writes the table here, and such a step
        writes over the prefix's last position)."""
        pending.mixed = True
        self._kv_mask[pending.slot_idx] = False
        self._kv_mask[pending.slot_idx, :pending.shared_len] = True
        self._prefills.append(pending)

    @torch.no_grad()
    def _prefill_chunk_step(self, pending: _PendingPrefill) -> None:
        """Run the next prompt chunk through the batch-1 forward; its K/V
        land at the prefill cache's cursor (global-cursor causal path,
        never the slot path)."""
        chunk = self.prefill_chunk if self.prefill_chunk > 0 \
            else pending.pad
        start = pending.done
        size = min(chunk, pending.pad - start)
        tokens = to_device(pending.tokens[:, start:start + size],
                           self.device)
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
        self._go_live(pending)
        if self.spec_k:
            cfg = pending.cfg
            self._spec_seed_slot(pending, int(sample_logits_rows(
                pending.last_row[None],
                [row_generator(pending.seed, 0, self.device)
                 if cfg.temperature > 0 else None],
                **self._filter_args(np.array([cfg.temperature], np.float32),
                                    np.array([cfg.top_k]),
                                    np.array([cfg.top_p], np.float32)))[0]))

    def _go_live(self, pending: _PendingPrefill) -> None:
        """A live slot for a pending whose prompt is all in the cache."""
        cfg = pending.cfg
        self._slots[pending.slot_idx] = _Slot(
            request_id=pending.rid, prompt_len=pending.true_len,
            pad_len=pending.pad, max_new=cfg.max_new_tokens,
            eos_id=cfg.eos_id, temperature=cfg.temperature,
            top_k=cfg.top_k, top_p=cfg.top_p, seed=pending.seed,
            pages=pending.pages,
            prompt_ids=pending.tokens[0, :pending.true_len].tolist())

    def _finish_mixed(self, pending: _PendingPrefill,
                      seed_tok: Optional[int]) -> None:
        """Promote a mixed pending whose prompt is all in the cache to a
        live slot: its K/V was written in place by the steps it rode, and
        `_last` holds its last prompt token's logits (plain) or its first
        token was drawn in the verify that wrote its last chunk
        (`seed_tok`, speculation)."""
        self._go_live(pending)
        if self.page_size:
            self._alloc.register_prefix(
                self._slots[pending.slot_idx].prompt_ids, pending.pages)
        if self.spec_k:
            self._spec_seed_slot(pending, seed_tok)

    def _spec_seed_slot(self, pending: _PendingPrefill, tok: int) -> None:
        """Speculation's bootstrap at prefill end: the verify feeds the
        pending token first, so a new slot commits its first token now;
        with a draft model the prompt is prefilled into the draft's slot
        too."""
        if self._draft is not None:
            self._draft.admit(pending.slot_idx, pending.tokens,
                              pending.mask_row, pending.pad)
        self._commit_token(pending.slot_idx, tok)

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
                if p.mixed and self.page_size:
                    # A mixed pending may have written its table row.
                    clear_table(self._cache, p.slot_idx)
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
            if pending.mixed:
                # Mixed pendings advance inside decode steps.
                still_pending.append(pending)
                continue
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

    def _decode_rows(self, occupied: List[int]) -> Dict[str, Any]:
        """Host vectors [B] of a decode step for `occupied`: each row
        writes its next token at pad_len + generated, at rope position
        prompt_len + generated, a sampled row with its generator for that
        token; and the rows' sampling settings."""
        b = self.n_slots
        h = self._row_inputs(occupied)
        h.update(cursors=np.zeros((b,), np.int64),
                 rope=np.zeros((b,), np.int64), generators=[None] * b)
        for i in occupied:
            s = self._slots[i]
            h['cursors'][i] = s.pad_len + s.generated
            h['rope'][i] = s.prompt_len + s.generated
            if s.temperature > 0:
                h['generators'][i] = row_generator(s.seed, s.generated,
                                                   self.device)
        return h

    def _device_inputs(self, h: Dict[str, Any], names: Sequence[str],
                       live: int) -> Dict[str, Any]:
        """A step's inputs from host vectors `h`: the named ones on the
        device, the filter arguments, the generators and the read window
        of a step whose last query sits at live - 1."""
        out = {name: to_device(h[name], self.device) for name in names}
        out.update(filt=self._filter_args(h['temps'], h['top_ks'],
                                          h['top_ps']),
                   generators=h['generators'], bucket=self._read_bucket(live))
        return out

    @torch.no_grad()
    def decode_logits(self, kernel: str, graph: bool = False
                      ) -> torch.Tensor:
        """The logits [B, V] the next decode step computes for the
        occupied slots, with `kernel` ('fused', 'plain' or 'xla'),
        committing nothing: the step rewrites the same K/V when it runs.
        With `graph` they come from the replay of the read bucket's CUDA
        graph, as a step's do (kernel 'fused' on the card only; raises
        elsewhere), else from the eager forward.  For holding the kernels
        against their plain versions, and the replay against the eager
        forward, on the serving path.  Joins the step in flight first."""
        with self._step_lock:
            self._pipeline_join()
            occupied, _ = self._work()
            if not occupied:
                raise RuntimeError('no occupied slot to decode')
            if graph and (self._graphs is None or kernel != 'fused'):
                raise ValueError('decode graphs run the fused kernels on '
                                 'the card only')
            return self._mixed_forward(self._mixed_inputs(occupied, [], 1),
                                       kernel, graph=graph)[1]

    # -- mixed prefill/decode batches -----------------------------------
    def _mix_assignments(self, mixed: List[_PendingPrefill],
                         s_cap: int) -> List[int]:
        """FIFO split of a step's prefill-token budget over the mixed
        pendings: earlier admissions drain first; a row never takes more
        than s_cap tokens (the step's query width) or what its prompt
        still needs."""
        left = self.prefill_mix_budget
        takes: List[int] = []
        for p in mixed:
            take = max(0, int(min(left, s_cap, p.true_len - p.done)))
            takes.append(take)
            left -= take
        return takes

    def _mix_rows(self, mixed: List[_PendingPrefill],
                  s_cap: int) -> List[Tuple[_PendingPrefill, int]]:
        """(pending, tokens) of each mixed pending that rides this step;
        a paged pending's block-table row is written at its first ride."""
        mix = [(p, take) for p, take in
               zip(mixed, self._mix_assignments(mixed, s_cap)) if take > 0]
        for p, _ in mix:
            if self.page_size and p.done == p.shared_len:
                set_table(self._cache, p.table_row, p.slot_idx)
        return mix

    def _read_bucket(self, live: int) -> int:
        """The read window of a step whose last query sits at live - 1."""
        if self.kv_read_bucket <= 0:
            return self.max_seq_len
        gran = self.kv_read_bucket
        return min(self.max_seq_len, ((live + gran - 1) // gran) * gran)

    def _row_inputs(self, occupied: List[int]) -> Dict[str, Any]:
        """Host vectors [B] of the occupied slots' sampling settings."""
        b = self.n_slots
        inp = dict(temps=np.zeros((b,), np.float32),
                   top_ks=np.zeros((b,), np.int64),
                   top_ps=np.ones((b,), np.float32),
                   active=np.zeros((b,), bool))
        for i in occupied:
            s = self._slots[i]
            inp['temps'][i] = s.temperature
            inp['top_ks'][i] = s.top_k
            inp['top_ps'][i] = s.top_p
            inp['active'][i] = True
        return inp

    def _filter_args(self, temps: np.ndarray, top_ks: np.ndarray,
                     top_ps: np.ndarray) -> Dict[str, Any]:
        """sample_logits_rows' per-row vectors (on the device) and its
        static arguments, from host vectors."""
        max_k = top_k_bucket(int(top_ks.max()), self.config.vocab_size)
        use_top_p = bool((top_ps < 1.0).any())
        dev = self.device
        return dict(
            temps=to_device(temps, dev), top_ks=to_device(top_ks, dev),
            top_ps=to_device(top_ps, dev), max_k=max_k,
            use_top_p=use_top_p,
            top_p_in_topk=bool(use_top_p and max_k > 0 and
                               (top_ks[top_ps < 1.0] > 0).all()))

    def _mixed_inputs(self, occupied: List[int],
                      mixed: List[_PendingPrefill], s: int
                      ) -> Dict[str, Any]:
        """Inputs of one step of query width `s`: a decode row feeds its
        next token at query 0, and the mixed pending rows take up to the
        budget of prompt tokens, each chunk at its cache cursor (slot =
        rope position = done for a prompt row).  A plain decode step is
        s = 1 with no mixed pending."""
        b = self.n_slots
        h = self._decode_rows(occupied)
        h.update(tokens=np.zeros((b, s), np.int64),
                 n_commit=np.zeros((b,), np.int64),
                 last_pos=np.zeros((b,), np.int64),
                 update_last=np.ones((b,), bool))
        # `_last` keeps only a prompt row's whose chunk does not end it.
        h['n_commit'][occupied] = 1
        mix = self._mix_rows(mixed, s)
        for p, take in mix:
            i = p.slot_idx
            h['cursors'][i] = h['rope'][i] = p.done
            h['tokens'][i, :take] = p.tokens[0, p.done:p.done + take]
            h['n_commit'][i] = take
            h['update_last'][i] = p.done + take >= p.true_len
            h['last_pos'][i] = take - 1 if h['update_last'][i] else 0
        # Query s - 1 attends through position cursor + s - 1.
        work = occupied + [p.slot_idx for p, _ in mix]
        inp = self._device_inputs(
            h, ('active', 'cursors', 'rope', 'tokens', 'n_commit',
                'last_pos', 'update_last'), int(h['cursors'][work].max()) + s)
        inp['mix'] = mix
        return inp

    def _mixed_forward(self, inp: Dict[str, Any], kernel: str,
                       graph: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
        """The one-token step at S = the step's width: decode rows sample
        from the last logits and feed the token at query 0 (pad queries
        after it), prompt rows feed their chunk.  Each working row's
        query-0 slot is revealed before the forward, and its committed
        window [cursor, cursor + n_commit) after it; pad queries' K/V
        stays unrevealed, rewritten in place by a later step.  With
        `graph` an S = 1 forward is replayed from the read bucket's CUDA
        graph (sampling and the reveals stay eager).  Returns (tokens
        [B], each row's logits at its last_pos [B, V], the revealed
        mask)."""
        tok = sample_logits_rows(self._last, inp['generators'],
                                 **inp['filt'])
        rows = torch.arange(self.n_slots, device=self.device)
        cursors, n_commit = inp['cursors'], inp['n_commit']
        has_work = n_commit > 0
        kv_mask = self._kv_mask.clone()
        kv_mask[rows, cursors] |= has_work
        tokens = inp['tokens']
        # A prompt row feeds its chunk; every other row the sampled token
        # (a dead row's write lands on no slot a live row reads).
        chunk = has_work & ~inp['active']
        feed = torch.cat([torch.where(chunk, tokens[:, 0], tok)[:, None],
                          tokens[:, 1:]], dim=1)
        positions = inp['rope'][:, None] + torch.arange(
            feed.shape[1], device=self.device)
        if graph and feed.shape[1] == 1:
            logits = self._graphs.run(inp['bucket'], feed=feed,
                                      positions=positions, kv_mask=kv_mask,
                                      last_pos=inp['last_pos'])
        else:
            x = self.model.hidden(feed, positions, self._cache, kv_mask,
                                  kernel=kernel, read_len=inp['bucket'])
            logits = self.model.head(x[rows, inp['last_pos']])
        kv_mask |= spec_lib.commit_window(self.max_seq_len, cursors,
                                          n_commit, has_work)
        return tok, logits, kv_mask

    @torch.no_grad()
    def mixed_logits(self, kernel: str) -> Tuple[torch.Tensor, List[int]]:
        """The next mixed step's logits at each row's last_pos [B, V]
        (decode rows: query 0; a prompt row: its last prompt token when
        the chunk ends the prompt, else query 0) with `kernel`, and the
        rows that work, committing nothing: the step rewrites the same
        K/V when it runs.  For holding the kernels against their plain
        versions on the serving path.  Joins the step in flight first."""
        with self._step_lock:
            self._pipeline_join()
            occupied, mixed = self._work()
            inp = self._mixed_inputs(occupied, mixed, self._mix_s)
            rows = occupied + [p.slot_idx for p, _ in inp['mix']]
            return self._mixed_forward(inp, kernel)[1], rows

    def _dispatch_mixed(self, occupied: List[int],
                        mixed: List[_PendingPrefill]) -> _InflightStep:
        """Dispatch half of one decode step for `occupied`, at the mix
        width carrying the mixed pendings' prompt chunks when there are
        any, else at S = 1 (replayed from its CUDA graph on the card)."""
        t_enter = time.perf_counter()
        rids = [self._slots[i].request_id for i in occupied]
        inp = self._mixed_inputs(occupied, mixed,
                                 self._mix_s if mixed else 1)
        tok, new_last, self._kv_mask = self._mixed_forward(
            inp, self.decode_kernel, graph=self._graphs is not None)
        self._last = torch.where(inp['update_last'][:, None], new_last,
                                 self._last)
        host, event = self._fetch(tok)
        return _InflightStep('mixed' if inp['mix'] else 'plain', host,
                             event, occupied, rids, inp['mix'], t_enter)

    def _fetch(self, out: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """Start the device-to-host copy of a step's results: on the card
        a non-blocking copy into pinned memory with a CUDA event recorded
        behind it, (host tensor, event); on the CPU (out, None)."""
        if not out.is_cuda:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _consume_step(self, handle: _InflightStep) -> None:
        """Consume half of one decode step: wait for its tokens, then
        commit them to the slots still held by their requests and advance
        the prompts that rode it."""
        if handle.event is not None:
            handle.event.synchronize()
        host = handle.host.numpy()
        if handle.mode != 'spec':
            self._commit_rows(handle.occupied, handle.rids, host[:, None],
                              np.ones((self.n_slots,), np.int64))
            self._advance_mix(handle.mix, None)
            return
        toks, counts = host[:, :-1], host[:, -1]
        self.spec_steps += 1
        self.spec_proposed += handle.proposed
        self.spec_accepted += int(sum(counts[i] - 1
                                      for i in handle.occupied))
        self.spec_committed += self._commit_rows(
            handle.occupied, handle.rids, toks, counts)
        self._advance_mix(handle.mix, toks)

    def _advance_mix(self, mix: List[Tuple[_PendingPrefill, int]],
                     toks: Optional[np.ndarray]) -> None:
        """Advance each ridden pending's cursor; promote a prompt that is
        all in the cache to a live slot (with a verify's first token
        toks[slot, 0] under speculation)."""
        for pending, take in mix:
            if pending not in self._prefills:
                continue
            pending.done += take
            if pending.done >= pending.true_len:
                self._prefills.remove(pending)
                self._finish_mixed(pending, None if toks is None
                                   else int(toks[pending.slot_idx, 0]))

    def _commit_rows(self, occupied: List[int], rids: List[int],
                     toks: np.ndarray, counts: np.ndarray) -> int:
        """Commit toks[i, :counts[i]] to each occupied slot still held by
        its request, a slot's tail dropped once it completes; returns the
        tokens committed."""
        committed = 0
        for i, rid in zip(occupied, rids):
            s = self._slots[i]
            if s is None or s.request_id != rid:
                continue
            for j in range(int(counts[i])):
                committed += 1
                if self._commit_token(i, int(toks[i, j])):
                    break       # eos or budget: drop the tail
        return committed

    # -- speculative decoding ----------------------------------------------
    def _spec_inputs(self, occupied: List[int],
                     mixed: List[_PendingPrefill]) -> Dict[str, Any]:
        """Inputs of one verify: each live row's pending token (its last
        output, not yet in the cache) at the slot one before plain
        decode's cursor, with up to n_prop = min(k, budget left - 1)
        proposals behind it; mixed prompt rows ride the same k + 1 window
        with their chunk in the pending and proposal seats (inactive, so
        acceptance ignores them).  `drafts` is n-gram's proposals, or None
        for the draft model's."""
        b, k = self.n_slots, self.spec_k
        h = self._row_inputs(occupied)
        h.update(cursors=np.zeros((b,), np.int64),
                 rope=np.zeros((b,), np.int64),
                 t_pend=np.zeros((b,), np.int64),
                 n_prop=np.zeros((b,), np.int64),
                 mix_drafts=np.zeros((b, k), np.int64),
                 mix_real=np.zeros((b,), np.int64),
                 mix_seed=np.zeros((b,), bool), generators=[None] * b)
        seed_gens: List[Optional[torch.Generator]] = [None] * b
        for i in occupied:
            s = self._slots[i]
            h['cursors'][i] = s.pad_len + s.generated - 1
            h['rope'][i] = s.prompt_len + s.generated - 1
            h['t_pend'][i] = s.outputs[-1]
            h['n_prop'][i] = min(k, s.max_new - s.generated - 1)
            if s.temperature > 0:
                h['generators'][i] = spec_lib.verify_generator(
                    s.seed, s.generated, self.device)
        mix = self._mix_rows(mixed, k + 1)
        for p, take in mix:
            i, cfg = p.slot_idx, p.cfg
            h['cursors'][i] = h['rope'][i] = p.done
            h['t_pend'][i] = p.tokens[0, p.done]
            h['mix_drafts'][i, :take - 1] = p.tokens[0, p.done + 1:
                                                     p.done + take]
            h['temps'][i] = cfg.temperature
            h['top_ks'][i] = cfg.top_k
            h['top_ps'][i] = cfg.top_p
            h['mix_real'][i] = take
            h['mix_seed'][i] = p.done + take >= p.true_len
            if h['mix_seed'][i] and cfg.temperature > 0:
                seed_gens[i] = row_generator(p.seed, 0, self.device)
        if self._draft is None:
            # n-gram self-drafting, on the host, into the rows the prompt
            # chunks leave free.
            for i in occupied:
                s = self._slots[i]
                props = spec_lib.ngram_propose(s.prompt_ids + s.outputs,
                                               int(h['n_prop'][i]))
                h['mix_drafts'][i, :len(props)] = props
                h['n_prop'][i] = len(props)
        # Query k attends through position cursor + k.
        work = occupied + [p.slot_idx for p, _ in mix]
        inp = self._device_inputs(
            h, ('active', 'cursors', 'rope', 't_pend', 'n_prop',
                'mix_drafts', 'mix_real', 'mix_seed'),
            int(h['cursors'][work].max()) + k + 1)
        inp.update(seed_gens=seed_gens, mix=mix,
                   drafts=inp['mix_drafts'] if self._draft is None else None,
                   proposed=int(h['n_prop'][occupied].sum()))
        return inp

    def _spec_forward(self, inp: Dict[str, Any], kernel: str
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
        """One verify: the proposals (the draft model's, or n-gram's from
        `inp`), each working row's query-0 slot revealed, the k + 1
        forward, acceptance, and the committed window [cursor, cursor +
        count) revealed (a prompt row's whole chunk).  Rejected and pad
        K/V stays written but hidden.  Returns (out [B, k+1], counts [B],
        logits [B, k+1, V], the revealed mask); a seeding prompt row's
        out[:, 0] is its first token, drawn as plain decode's first step
        draws it."""
        rows = torch.arange(self.n_slots, device=self.device)
        active, cursors = inp['active'], inp['cursors']
        mix_real = inp['mix_real']
        drafts = inp['drafts']
        if drafts is None:
            drafts = self._draft.propose(inp['t_pend'], inp['rope'],
                                         cursors, active, inp['bucket'])
            # Prompt rows take their chunk, not the draft's garbage.
            drafts = torch.where((mix_real > 0)[:, None],
                                 inp['mix_drafts'], drafts)
        act_w = active | (mix_real > 0)
        kv_mask = self._kv_mask.clone()
        kv_mask[rows, cursors] |= act_w
        tokens = torch.cat([inp['t_pend'][:, None], drafts], dim=1)
        positions = inp['rope'][:, None] + torch.arange(
            tokens.shape[1], device=self.device)
        logits = self.model(tokens, positions, self._cache, kv_mask,
                            kernel=kernel, read_len=inp['bucket'])
        out, counts = spec_lib.accept_draft_rows(
            logits, drafts, inp['n_prop'], inp['generators'],
            **inp['filt'])
        counts = torch.where(active, counts, 0)
        kv_mask |= spec_lib.commit_window(
            self.max_seq_len, cursors,
            torch.where(mix_real > 0, mix_real, counts), act_w)
        if inp['mix']:
            seed_tok = sample_logits_rows(
                logits[rows, torch.clamp(mix_real - 1, min=0)],
                inp['seed_gens'], **inp['filt'])
            out[:, 0] = torch.where(inp['mix_seed'], seed_tok, out[:, 0])
        return out, counts, logits, kv_mask

    @torch.no_grad()
    def verify_logits(self, kernel: str) -> torch.Tensor:
        """The next verify's logits [B, k+1, V] with `kernel`, committing
        nothing: the verify rewrites the same K/V when it runs (and the
        draft model its own).  For holding the kernels against their
        plain versions on the serving path.  Joins the step in flight
        first."""
        with self._step_lock:
            self._pipeline_join()
            return self._spec_forward(self._spec_inputs(*self._work()),
                                      kernel)[2]

    def _dispatch_spec(self, occupied: List[int],
                       mixed: List[_PendingPrefill]) -> _InflightStep:
        """Dispatch half of one verify: the forward, acceptance and the
        reveals on the device, the draft model's reveal of the committed
        window (where the reference commits it), and one copy of the
        step's tokens and counts to the host."""
        t_enter = time.perf_counter()
        rids = [self._slots[i].request_id for i in occupied]
        inp = self._spec_inputs(occupied, mixed)
        out, counts, _, self._kv_mask = self._spec_forward(
            inp, self.decode_kernel)
        if self._draft is not None:
            self._draft.commit(inp['cursors'], counts, inp['active'])
        host, event = self._fetch(torch.cat([out, counts[:, None]], dim=1))
        return _InflightStep('spec', host, event, occupied, rids,
                             inp['mix'], t_enter, proposed=inp['proposed'])

    def speculation_info(self) -> Optional[Dict[str, Any]]:
        """Speculation summary (None when disabled): the proposer, k, and
        the cumulative verify steps, proposed, accepted and committed
        tokens, with the acceptance rate.  Joins the step in flight
        first."""
        if not self.spec_k:
            return None
        self._fence()
        proposed = self.spec_proposed
        return dict(
            mode='draft' if self._draft is not None else 'ngram',
            draft_model=(self._draft.model_name
                         if self._draft is not None else None),
            spec_k=self.spec_k, steps=self.spec_steps,
            proposed_tokens=proposed, accepted_tokens=self.spec_accepted,
            committed_tokens=self.spec_committed,
            acceptance_rate=(self.spec_accepted / proposed
                             if proposed else None))

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler tick: admission and prefill chunks, then one
        decode step for all occupied slots (a verify under speculation;
        carrying prompt chunks with a mix budget).  False when fully idle
        (nothing queued, prefilling, occupied or in flight).

        With async_pipeline the tick is double-buffered: see
        `_step_async` for the order and why streams do not change."""
        with self._step_lock:
            if self.async_pipeline:
                return self._step_async()
            return self._step_sync()

    def _work(self) -> Tuple[List[int], List[_PendingPrefill]]:
        """The occupied slots and the mixed pendings a step serves."""
        return ([i for i, s in enumerate(self._slots) if s is not None],
                [p for p in self._prefills if p.mixed])

    def _dispatch(self, occupied: List[int],
                  mixed: List[_PendingPrefill]) -> _InflightStep:
        if self.spec_k:
            return self._dispatch_spec(occupied, mixed)
        return self._dispatch_mixed(occupied, mixed)

    def _step_sync(self) -> bool:
        """The synchronous tick: front, dispatch, fetch, consume."""
        self._schedule_front()
        occupied, mixed = self._work()
        if not occupied and not mixed:
            return bool(self._prefills) or bool(self._queue)
        self._consume_step(self._dispatch(occupied, mixed))
        return True

    def _step_async(self) -> bool:
        """One double-buffered tick (the reference's `_step_async`):

          1. front    - eviction, admission and prefill chunks, while step
                        N runs on the device (their device work is queued
                        behind N on the same stream);
          2. join N   - wait for N's tokens, then commit them here;
          3. dispatch N + 1 - build its inputs from the just-committed
                        state and queue it; return without waiting.

        Commits always land before the next step's inputs are built, so
        each step sees the per-row state the synchronous loop would give
        it.  Admission sees a completion one tick later than the
        synchronous loop (at the join), which can shift batch
        composition; a row's stream does not depend on its companions
        (the kv mask keeps rows apart, and a sampled row draws from its
        own (seed, generated) generator), so each request's tokens stay
        those of the synchronous loop."""
        self._schedule_front()
        consumed = self._pipeline_join()
        if self._fatal is not None:
            return False
        occupied, mixed = self._work()
        if not occupied and not mixed:
            # A tick that consumed the last step in flight did work.
            return consumed or bool(self._prefills) or bool(self._queue)
        self._pipeline_put(self._dispatch(occupied, mixed))
        return True

    # -- the pipeline's fence --------------------------------------------
    def _pipeline_put(self, handle: _InflightStep) -> None:
        """Record `handle` as the (single) step in flight."""
        self._inflight = handle

    def _pipeline_join(self) -> bool:
        """Consume the step in flight, if any: wait for its tokens and
        commit them.  A step still running on the device when the join
        begins (the host front took less time than it) counts as
        overlapped.  True when a step was consumed."""
        handle = self._inflight
        if handle is None:
            return False
        self._inflight = None
        if self._fatal is not None:
            return False        # aborted while in flight: results void
        if handle.event is not None and not handle.event.query():
            self._pipe_steps_overlapped += 1
        self._consume_step(handle)
        return True

    def _pipeline_abandon(self) -> None:
        """Forget the step in flight without committing it (abort and
        close): no commit ever happens but through `_pipeline_join`."""
        self._inflight = None

    def _fence(self) -> None:
        """Join the step in flight before reading engine state, from any
        thread (under the step lock)."""
        with self._step_lock:
            self._pipeline_join()

    def close(self, timeout: float = 5.0) -> None:
        """Fence the pipeline at shutdown (idempotent; a no-op on a
        synchronous or never-stepped engine): the step in flight is
        abandoned, never committed, and its device work is waited for up
        to `timeout` seconds.  There is no fetch thread to join: afterwards
        no step is in flight and the engine runs nothing (unless a step()
        still running on another thread holds the step lock past
        `timeout`: then nothing is changed)."""
        deadline = time.monotonic() + timeout
        if not self._step_lock.acquire(timeout=timeout):
            return
        try:
            handle = self._inflight
            self._pipeline_abandon()
        finally:
            self._step_lock.release()
        if handle is None or handle.event is None:
            return
        while not handle.event.query() and time.monotonic() < deadline:
            time.sleep(0.001)

    def pipeline_info(self) -> Dict[str, Any]:
        """Pipeline block for /health?verbose=1, with the reference's keys:
        mode, depth (steps in flight), max_depth, worker_alive, and
        steps_overlapped (consumed steps still running on the device when
        their join began; always 0 on the CPU, where a step is done when
        its dispatch returns).  worker_alive is always False: the port
        has no fetch thread (a non-blocking copy and a CUDA event take its
        place)."""
        return dict(mode='async' if self.async_pipeline else 'sync',
                    depth=0 if self._inflight is None else 1,
                    max_depth=1 if self.async_pipeline else 0,
                    worker_alive=False,
                    steps_overlapped=self._pipe_steps_overlapped)

    def graph_info(self) -> Optional[Dict[str, Any]]:
        """The decode graphs captured (buckets, capture seconds, pool
        bytes, replays), or None where the forward runs eagerly."""
        return None if self._graphs is None else self._graphs.info()

    def run_until_idle(self) -> None:
        """Step until idle; a step is never left in flight (the last tick
        joins it and dispatches nothing)."""
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
        leaked.  Joins the step in flight first."""
        self._fence()
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
        self._fence()
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
                 checkpoint_dir: Optional[str] = None,
                 device: DeviceLike = 'cuda') -> None:
        self.device = resolve_device(device)
        self.model, self.config = build_model(
            model, params, n_slots=max_batch_size, max_seq_len=max_seq_len,
            model_overrides=model_overrides, param_dtype=param_dtype,
            prefill_bucket=prefill_bucket, page_size=page_size, max_pages=0,
            quantize=quantize, kv_cache_dtype=kv_cache_dtype, seed=seed,
            device=self.device, checkpoint_dir=checkpoint_dir)
        self.loaded_real_weights = (params is not None
                                    or checkpoint_dir is not None)
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

"""Speculative decoding: proposals and parity-guarded acceptance, in PyTorch.

Port of skypilot_tpu/infer/speculative.py.  One target forward commits
several tokens:

  1. a proposer guesses k tokens: a small draft model decoding greedily
     against its own KV cache (`DraftRunner`), or, with no extra
     weights, prompt-lookup (n-gram) self-drafting (`ngram_propose`);
  2. the target scores the pending token and the k proposals in one
     multi-token slot forward (models/llama.py `_slot_positions`);
  3. `accept_draft_rows` keeps the longest draft prefix the target
     agrees with and samples one more token, so a verify commits 1 to
     k + 1 tokens.

Acceptance keeps the output unchanged.  At temperature 0 a proposal is
accepted iff it is the target's argmax there, and the correction or
bonus token is the argmax after the accepted prefix: the stream is plain
greedy decode's.  At temperature > 0 it is rejection sampling against
the filtered distribution plain decode draws from
(engine.filter_logits_rows): accept d with probability p(d), and on a
rejection resample from p with d removed.  Every committed token's
marginal is p.  The port cannot reproduce JAX's PRNG, so a sampled row
draws from its own torch.Generator seeded from (seed, generated index)
(`verify_generator`), independent of its batch companions, as plain
decode's `row_generator` is.

Rollback copies nothing: a rejected proposal's K/V sits at a cache
position the engine does not reveal, and the next verify overwrites it
in place.  The reference's `spec_metrics` waits for the port's metrics
registry (ROADMAP queue 1, 'Server surface and observability'); the
engine keeps its counters for `speculation_info`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.models.llama import (PagedCache, PrefillCache,
                                             SlotCache)


# -- self-drafting: prompt-lookup / n-gram proposals --------------------

def ngram_propose(context: Sequence[int], k: int, max_ngram: int = 3,
                  min_ngram: int = 1) -> List[int]:
    """Prompt-lookup proposals: find the most recent earlier occurrence
    of the longest suffix n-gram of `context` and propose the tokens that
    followed it, up to k.  [] when nothing matches (the verify then
    scores only the pending token)."""
    n_ctx = len(context)
    if k <= 0 or n_ctx < min_ngram + 1:
        return []
    for n in range(min(max_ngram, n_ctx - 1), min_ngram - 1, -1):
        suffix = tuple(context[n_ctx - n:])
        # The most recent earlier occurrence wins: recency tracks local
        # repetition (code, templates) better than the first match.
        for start in range(n_ctx - n - 1, -1, -1):
            if tuple(context[start:start + n]) == suffix:
                cont = context[start + n:start + n + k]
                if cont:
                    return list(cont)
                break
    return []


# -- acceptance ---------------------------------------------------------

def verify_generator(seed: int, generated: int,
                     device: torch.device) -> torch.Generator:
    """The generator a sampled row's verify draws from at its
    `generated`-th committed token: its k acceptance uniforms first,
    then the correction or bonus token.  Seeded from a hash of an int
    tuple (stable across processes), apart from `row_generator`'s."""
    g = torch.Generator(device=device)
    g.manual_seed(hash((int(seed), int(generated), 1)) & 0x7FFFFFFFFFFFFFFF)
    return g


def accept_draft_rows(logits: torch.Tensor, drafts: torch.Tensor,
                      n_prop: torch.Tensor,
                      generators: Sequence[Optional[torch.Generator]],
                      temps: torch.Tensor, top_ks: torch.Tensor,
                      top_ps: torch.Tensor, *, max_k: int, use_top_p: bool,
                      top_p_in_topk: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accept or resample one verify forward's proposals.

    logits [B, k+1, V]: row j is the target's distribution after the
    j-th fed token, so logits[:, i-1] judges drafts[:, i-1] and
    logits[:, n] gives the token after an n-long accepted prefix.
    drafts [B, k] int64; n_prop [B] the real proposals a row (the rest
    is padding, rejected).  generators[i]: the row's generator for
    temps[i] > 0 (`verify_generator`), None for a greedy row.  The
    filter arguments are sample_logits_rows'.

    Returns (out [B, k+1], counts [B]): out[b, :counts[b]] are the
    committed tokens, the accepted prefix and one sampled token."""
    b, s, v = logits.shape
    k = s - 1
    dev = logits.device
    ok = drafts == torch.argmax(logits[:, :k], dim=-1)
    rows = [i for i, g in enumerate(generators) if g is not None]
    if rows:
        filt = engine_lib.filter_logits_rows(
            logits.reshape(b * s, v), temps.repeat_interleave(s),
            top_ks.repeat_interleave(s), top_ps.repeat_interleave(s),
            max_k=max_k, use_top_p=use_top_p,
            top_p_in_topk=top_p_in_topk).reshape(b, s, v)
        probs = torch.softmax(filt[:, :k], dim=-1)
        p_draft = torch.gather(probs, -1, drafts[:, :, None])[..., 0]
        u = torch.ones((b, k), dtype=torch.float32, device=dev)
        for i in rows:
            u[i] = torch.rand(k, generator=generators[i], device=dev)
        ok = torch.where(temps[:, None] > 0, u < p_draft, ok)
    ok &= torch.arange(k, device=dev)[None, :] < n_prop[:, None]
    n_acc = torch.cumprod(ok.long(), dim=-1).sum(-1)            # [B]
    brange = torch.arange(b, device=dev)
    t_new = torch.argmax(logits[brange, n_acc], dim=-1)
    if rows:
        # A sampled row that rejected a proposal resamples from the
        # filtered target with the rejected token removed (point-mass
        # proposals make the max(p - q, 0) residual exactly that).
        final = filt[brange, n_acc]
        rejected = torch.gather(drafts, 1,
                                torch.clamp(n_acc, max=k - 1)[:, None])[:, 0]
        exclude = (temps > 0) & (n_acc < n_prop)
        final = torch.where(
            exclude[:, None] & (torch.arange(v, device=dev)[None, :]
                                == rejected[:, None]),
            final.new_tensor(engine_lib.NEG_INF), final)
        final = torch.softmax(final, dim=-1)
        for i in rows:
            t_new[i] = torch.multinomial(final[i], 1,
                                         generator=generators[i])[0]
    pos = torch.arange(k + 1, device=dev)[None, :]
    out = torch.cat([drafts, drafts.new_zeros((b, 1))], dim=1)
    out = torch.where(pos == n_acc[:, None], t_new[:, None], out)
    out = torch.where(pos <= n_acc[:, None], out, 0)
    return out, n_acc + 1


# -- draft-model runner ---------------------------------------------------

class DraftRunner:
    """Draft-model proposer in the target engine's slot layout.

    The same n_slots, max_seq_len and cursors as the target, so target
    cursors map 1:1 onto the draft cache.  When the target is paged the
    draft holds its own pool at full coverage (n_slots * pages_per_slot
    + 1 pages) with no allocator: slot i owns pages [1 + i * pps,
    1 + (i + 1) * pps) for good, and rollback is kv-mask truncation, as
    the target's.  It runs through the same kernel wrappers as the
    target (`kernel`): kernel 4 at S = 1 for its steps, kernel 5 for its
    whole-prompt prefill, on the card.

    A propose runs k + 1 greedy steps: steps 1..k give the proposals;
    the last feeds d_k back so that its K/V is in the draft cache when
    everything is accepted.  Their reveals are discarded: `commit`
    reveals only the committed window."""

    def __init__(self, model: str, params: Optional[Mapping[str,
                                                          torch.Tensor]],
                 *, target_vocab_size: int, n_slots: int, max_seq_len: int,
                 spec_k: int, model_overrides: Optional[Dict[str, Any]],
                 param_dtype: Any, prefill_bucket: int, kv_cache_dtype: str,
                 page_size: int, kernels: Dict[str, str], seed: int,
                 device: torch.device,
                 checkpoint_dir: Optional[str] = None) -> None:
        if spec_k <= 0:
            raise ValueError(f'spec_k must be positive, got {spec_k}')
        self.k = spec_k
        self.model, self.config = engine_lib.build_model(
            model, params, n_slots=n_slots, max_seq_len=max_seq_len,
            model_overrides=model_overrides, param_dtype=param_dtype,
            prefill_bucket=prefill_bucket, page_size=page_size,
            max_pages=0, quantize=None, kv_cache_dtype=kv_cache_dtype,
            seed=seed, device=device, checkpoint_dir=checkpoint_dir)
        # Proposals are target token ids: a draft of another tokenizer
        # would decode garbage, so a vocab mismatch fails here.
        if self.config.vocab_size != target_vocab_size:
            raise ValueError(
                f'draft model {model!r} has vocab_size='
                f'{self.config.vocab_size} but the target expects '
                f'{target_vocab_size}: speculative decoding requires the '
                f'SAME tokenizer family for draft and target (proposals '
                f'are exchanged as token ids).')
        self.model_name = model
        self.n_slots = n_slots
        self.max_seq_len = self.config.max_seq_len
        self.page_size = page_size
        self.kernels = kernels
        self.device = device
        cache_cls = PagedCache if page_size else SlotCache
        self.cache = cache_cls.zeros(self.config, n_slots, device)
        self.kv_mask = torch.zeros((n_slots, self.max_seq_len),
                                   dtype=torch.bool, device=device)

    @torch.no_grad()
    def admit(self, slot_idx: int, tokens: np.ndarray,
              mask_row: torch.Tensor, pad: int) -> None:
        """Prefill the target's padded prompt row into the draft's slot
        in one whole-prompt forward, then insert it (paged: into the
        slot's fixed pages); the draft's kv-mask row is the target's, so
        the two caches' cursors stay aligned."""
        cache1 = PrefillCache.zeros(self.config, 1, self.device)
        self.model.hidden(engine_lib.to_device(tokens[:, :pad], self.device),
                          torch.arange(pad, device=self.device)[None], cache1,
                          mask_row[None], kernel=self.kernels['prefill'])
        if self.page_size:
            pps = self.max_seq_len // self.page_size
            table_row = np.arange(1 + slot_idx * pps,
                                  1 + (slot_idx + 1) * pps, dtype=np.int32)
            engine_lib.paged_insert(self.cache, cache1, table_row, slot_idx)
        else:
            engine_lib.slot_insert(self.cache, cache1, slot_idx)
        self.kv_mask[slot_idx] = mask_row

    @torch.no_grad()
    def propose(self, t_pend: torch.Tensor, rope: torch.Tensor,
                cursors: torch.Tensor, active: torch.Tensor,
                read_len: int) -> torch.Tensor:
        """k greedy proposals a row, [B, k] int64 on the device (never
        fetched: the verify takes them as they are).  Each step reveals
        its write slot in a copy of the mask (a slot past max_len is not
        revealed: the reference drops that write)."""
        b = t_pend.shape[0]
        rows = torch.arange(b, device=self.device)
        kv_mask = self.kv_mask.clone()
        tok = t_pend
        outs = []
        for j in range(self.k + 1):
            at = cursors + j
            fits = active & (at < self.max_seq_len)
            at = torch.clamp(at, max=self.max_seq_len - 1)
            kv_mask[rows, at] |= fits
            logits = self.model(tok[:, None], (rope + j)[:, None],
                                self.cache, kv_mask,
                                kernel=self.kernels['decode'],
                                read_len=read_len)
            tok = torch.argmax(logits[:, 0], dim=-1)
            outs.append(tok)
        return torch.stack(outs[:self.k], dim=1)

    def commit(self, cursors: torch.Tensor, counts: torch.Tensor,
               active: torch.Tensor) -> None:
        """Reveal the committed window [cursor, cursor + count) of each
        active row; what the proposal steps wrote past it stays hidden."""
        self.kv_mask |= commit_window(self.max_seq_len, cursors, counts,
                                      active)


def commit_window(max_len: int, cursors: torch.Tensor, counts: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """[B, max_len] bool: slots [cursor, cursor + count) of each row with
    `rows` set, what a step reveals after its forward."""
    slots = torch.arange(max_len, device=cursors.device)[None, :]
    return (rows[:, None] & (slots >= cursors[:, None])
            & (slots < (cursors + counts)[:, None]))

#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (skypilot_tpu_torch) on one card.

    python3 chip_smoke.py              # every phase; needs one NVIDIA card

Phases, any failure exits non-zero:
  1. device  - require CUDA; print the card's name and power limit as
               `nvidia-smi --query-gpu=name,power.limit` gives them.
  2. build   - compile every kernel library from csrc/ (one nvcc per
               source, all in parallel) and print the build time and
               ptxas's report.
  3. kernels - at llama3-8b serving shapes (H 32, kvh 8, d 128, page 16,
               bf16) hold each kernel against its plain PyTorch version
               run at f32 on the same values, within the kernel's
               rounding bound (`check_kernel`), and time the kernel, the
               plain version (bf16) and one PyTorch library call for the
               same function (SDPA on K/V gathered beforehand: a
               yardstick the port never calls).  Decode: batch 8,
               contexts 100-4000 over a shuffled page pool with a
               poisoned null page, timed; then, checked only, the cases
               the kernel's split page walk can get wrong (DECODE_EDGES):
               a row shorter than one chunk, a 4000-position row beside
               1-position rows, a row that sees nothing, S 4 masks, a
               1024-position window (chunks that see nothing), pages of 8
               and of 32, d 64, f16 and f32 q, each called twice in a row
               on different inputs (a merge counter left non-zero would
               show); and, checked and timed, at the serving path's
               multi-query widths: S 5 (a speculative verify) and S 64 (a
               mixed step) over the timed case's contexts (DECODE_S).  Prefill: the 512-token chunks of a
               3000-token prompt at cursor base 0, 1536 and 2560 (the
               last chunk, where kv_mask cuts into the chunk), timed;
               then, checked only, the cases the prefill kernel's tiling
               can get wrong (PREFILL_EDGES): a chunk of 200 rows (not a
               multiple of the 64-row tile), a 1024-token window, a
               permuted block table, d 64, f16, pages of 8 and of 32
               tokens at a base that is not a multiple of the page.
     The int8 branches of both at the same shapes (the edge cases
               too): the pools and caches
               are quantize_int8_rows of the same bf16 rows (the decode
               null page poisoned with int8 127 at a scale of 1e4), held
               against the plain int8 versions at f32 on the same int8
               values and scales; the library yardstick is SDPA on K/V
               dequantized to bf16 beforehand (not timed).
     Flash attention (forward, dq, dk/dv): at the llama3-8b training
               shape (B 2, H 32, kvh 8, S 4096, d 128, causal, bf16), with
               a 1024-token window, and at a ragged S 1000 with d 64, each
               output (out, lse, dq, dk, dv) against the plain versions
               run at f32 on the same values, within
               `flash_attention.rounding_bounds`; times of the kernels,
               the plain versions (bf16 inputs) and SDPA (its forward,
               and its backward alone over one saved forward for dq and
               dk/dv; K/V repeated to H heads beforehand) at the training
               shape; then, checked only, FLASH_EDGES: queries at an
               offset past their keys (700; 200 under a 300-token window
               at d 64).
     Head width 256 (gemma; `phase_kernels_d256`): kernels 4 and 5, both
               branches, checked and timed against the plain versions and
               SDPA at the serve_gemma shapes: decode over the same
               contexts at gemma-7b's heads (16 over 16) at S 1 and 5 and
               gemma-2b's (8 over 1, a group of 8); a 512-token chunk at
               base 1536 at both models' heads (GEMMA_DECODE,
               GEMMA_PREFILL).
     Flash kernels 1-3 at head width 256 (`phase_flash_d256`): at
               gemma-7b's heads (16 over 16) and gemma-2b's (8 over 1),
               B 2 x S 4096, causal, checked within
               `flash_attention.rounding_bounds` and timed with their
               plain versions and SDPA (K/V repeated 8 times for G 8);
               checked only: a 1024-token window, a ragged S 1000, an
               offset of 700 (FLASH_D256_CASES, FLASH_D256_EDGES).
  4. serve   - start the port's InferenceServer on llama3-8b at full width
               and depth (random bf16 weights from a seed; page 16,
               prefill chunk 512, 8 slots, max_seq_len 4096; like every
               server below, with its default decode pipeline: pipelined,
               the S = 1 decode forward replayed from CUDA graphs), reset every
               kernel's launch count, POST 8 concurrent greedy /generate
               requests (prompts of 40-3000 tokens, 32 new tokens) and 2
               sampled ones, and read the counts: both float branches
               must have launched, the int8 branches not.  Then: a
               repeated greedy prompt must give the same tokens; prefill
               and decode tokens/s; and the first decode step's logits of
               one request with the kernels and with their plain versions
               ('plain') must agree.
     serve_int8 - the bf16 server freed, the same with
               kv_cache_dtype='int8' (same weights and requests): only
               the int8 branches may launch, both must; the pools' bytes
               against the bf16 ones; greedy repeat; tokens/s; then four
               prompts (40-3000 tokens) prefilled and decoded one step
               through the kernels and, apart, through their plain
               versions: the prefill and decode logits must agree within
               INT8_LOGITS_REL_TOL.  Readings only: the int8 cache's
               logits against the bf16 cache's, and the share of greedy
               tokens equal to the bf16 phase's.
     serve_prefix - a server like serve's (same weights) answers one
               request with a PREFIX_LEN-token prefix and a SUFFIX_LEN-token
               suffix, then SHARERS concurrent ones with the same prefix and
               other suffixes, each of which must share the prefix's
               PREFIX_LEN / page pages (prefix-hit pages counted by the
               engine); launches as serve's.  Readings: the peak live pages
               against the same SHARERS requests served by serve's engine,
               where nothing of theirs was in the pool; prefill ms of a cold
               prompt and of a sharer.  Checked: SHARERS sharers of a second
               prefix, their prefill and first decode step logits against
               the same prompts prefilled cold by serve's engine: equal bit
               for bit (PREFIX_LEN is a whole number of chunks, so both
               compute the same last chunk over the same values); and how
               many greedy tokens the HTTP sharers have in common with
               serve's engine's.
     serve_wint8 - the same server with int8 weights (quantize='int8') and
               a bf16 KV cache: the weight bytes against serve's, the float
               branches launch, tokens/s, the device busy ms of a decode
               step at batch 8 beside serve's (torch.profiler); the first
               decode step's logits with the kernels and the plain versions
               within LOGITS_REL_TOL; reading: the gap to serve's logits
               (bf16 weights) for the same prompt.
     serve_unpaged - the default, unpaged server (page_size 0, a
               contiguous slot cache: the reference runs no kernel there)
               on llama3-8b at full width cut to UNPAGED_LAYERS layers,
               f32 weights and activations: 3 concurrent greedy requests
               of UNPAGED_NEW new tokens, every launch count 0.  Held to
               the same model served paged with kernel='xla': equal
               greedy tokens, and first decode step logits within
               UNPAGED_LOGITS_REL_TOL of max |logit|.
     serve_static - the server with --no-continuous (continuous=False, the
               request-level InferenceEngine) on the same model and
               weights: the serve_unpaged prompts in one /generate batch of
               4, no kernel launched, greedy tokens equal to
               serve_unpaged's.
     serve_spec - serve's server with --spec-k 4: 8 greedy requests over
               templated prompts with n-gram self-drafting, then with a
               llama3.2-1b draft, and, when neither accepted a token, with a
               draft of the target's config and seed; per mode the proposed,
               accepted and committed tokens, kernel 4's launches by S
               (S 5 must launch, kernel 5 too), the token agreement with
               plain bf16 decode; /health?verbose=1's speculation block.
               The first verify forward's logits (all k + 1 positions),
               kernels vs plain, within LOGITS_REL_TOL (bf16 cache) and
               INT8_LOGITS_REL_TOL (int8 cache, the quant branch at S 5).
     serve_mixed - serve's server with --prefill-mix-budget 64: 8 decoding
               requests, then 2 prompts of 1000 tokens once all 8 are
               live; kernel 4 must launch at S 64 and kernel 5 never.
               Reading: the decode rows' inter-token ms while two long
               prompts prefill, mixed against dedicated ticks.  One mixed
               step's logits (decode rows, and a prompt row at its last
               token), kernels vs plain, bf16 and int8 caches (limits as
               serve_spec's).
     serve_async - the default server (pipelined, decode graphs) against
               --no-async-pipeline on the same weights, bf16 and int8
               caches: 8 greedy requests (40-1200 tokens) each, equal
               tokens; kernel 4's launches over the four bursts (replays
               count the launches captured in their graphs); HTTP decode
               tokens/s of both; the pipelined engine must have overlapped
               a step and replayed a graph.  Then, on the pipelined
               engine: a decode step of 8 rows (64-4000 tokens) replayed
               against the eager forward within GRAPH_LOGITS_GAP; the
               graphs captured, their capture seconds and pool bytes; and
               a decode step at batch 8 synchronous and eager, pipelined
               and eager, pipelined with graphs (wall ms, profiler off),
               and with graphs under the profiler (busy, idle share,
               kernels and host launch calls a step).
     invariants - at serve_unpaged's size (f32, 4 layers; kernel 4 at f32,
               prefill 'xla'): speculation with a draft of the target's
               config and seed, and mixed batches, must give plain decode's
               greedy streams token for token (where not, the first token
               that differs and the top-2 logit margin there are printed).
  5. train   - `python -m skypilot_tpu_torch.train` (its `main`) on
               llama3-8b at its published widths, depth cut to 4 layers,
               batch 2 x seq 4096, 5 steps (bf16 compute, f32 params and
               AdamW moments, remat), with every kernel's launch count set
               to 0 just before and read just after: flash forward 2 L
               steps (remat reruns it), dq and dk/dv L steps each, the
               serving kernels 0.  Every loss and grad_norm finite; step
               ms, tokens/s, peak memory.  Then, at one batch and the same
               weights, the loss and global grad norm with the kernels
               and with their plain versions must agree (twice, on two
               batches); then 10 steps on one repeated batch must lower
               the loss by more than 0.5 (the reference's memorization
               test).
     finetune - the LoRA recipe through `python -m skypilot_tpu_torch.train`
               (its `main`): llama3-8b at full width and all 32 layers,
               rank-16 adapters (alpha 16) on q/k/v/o, --train-only lora,
               remat_policy='save_attn', --loss-chunk 1024, batch 2 x seq
               8192 in two microbatches (the recipe's 16 cut to fit the
               smoke's time), 3 steps, every count set to 0 just before
               and read just after: each flash kernel once a layer and
               microbatch (save_attn keeps the attention's output and lse,
               so the backward runs no forward), the serving kernels 0.
               Every base parameter bit for bit unchanged (against a host
               copy taken at init), every adapter b off zero, losses and
               grad norms finite; step ms, tokens/s, peak memory.  Then
               one step's loss and adapter grad norm, kernels vs plain, on
               the finetuned weights of the first FT_CHECK_LAYERS layers at
               1 x 8192, within the train limits.
     checkpoint - llama3-8b width cut to CK_LAYERS layers, LoRA as
               finetune's, in a temporary directory removed at the end: a
               params-only base checkpoint (no adapters) restored into a
               LoRA train_only trainer (base equal, every b zero, step 0,
               the first logits the base model's bit for bit); 2 + 2 steps
               with a save and a fresh trainer's `restore_or_init` between
               against 4 uninterrupted steps (bit for bit, else within the
               train limits; which one held is printed); then the
               trained checkpoint served by the server's CLI path
               (`server_from_args`, --checkpoint-dir, LoRA overrides):
               one /generate of CK_LENS prompts whose greedy streams must
               equal an engine's given the same params in memory, kernels
               4 and 5 counted from 0 around it; then graph_check on the
               server's engine (the adapters inside the decode graphs).
     serve_qwen - qwen2-7b whole (28 layers, 28 query heads over 4 KV
               heads: a group of 7; q/k/v biases) through the server's
               CLI path (`server_from_args`), serve's settings: the main
               path (10 requests, kernels 4 and 5 counted from 0), decode
               tokens/s, `first_step_check`, `graph_check`.
     serve_mixtral - mixtral-8x7b at full width, 16 of its 32 layers
               (MIXTRAL_SERVE_LAYERS), the same: the main path, decode
               tokens/s, `moe_route_check` (kernels vs plain with each
               run's routes read, the plain run also routed as the
               kernels' run), `graph_check` with the MoE layers inside the
               graph; then a --spec-k 4 server: one n-gram request, kernel
               4 at S 5 under capacity.
     serve_gpt2 - gpt2 (124 M) whole, max_seq_len 1024: the main path
               (prompts up to 960 tokens; kernels 4 and 5 at d 64, 12
               heads over 12, a group of 1), decode tokens/s,
               `first_step_check`.
     train_families - TRAIN_FAMILIES through the trainer's CLI, 5 steps
               each (gpt2 whole 8 x 1024, qwen2-7b 4 layers 2 x 4096,
               mixtral-8x7b 2 layers 1 x 4096), counts from 0: flash
               forward 2 L steps, dq and dk/dv L steps; every loss,
               aux_loss (Mixtral's > 0) and grad norm finite; then one
               step kernels vs plain within FAMILY_TRAIN_LIMITS (Mixtral's
               plain run routed as the kernels' run) and
               FAMILY_MEMORIZE_STEPS steps on one batch whose loss must
               fall.
     serve_gemma - gemma-7b whole (28 layers, 16 heads over 16 at head_dim
               256, GeGLU, the tied head, vocab 256128) through the CLI's
               server, serve's settings: the main path (10 requests,
               kernels 4 and 5 at d 256 counted from 0), decode tokens/s,
               `first_step_check`, `graph_check`; the same from an int8
               KV cache (`int8_logit_gaps`, INT8_LOGITS_REL_TOL); a
               --spec-k 4 server with a gemma-2b draft over templated
               prompts (kernel 4 at S 5, the draft's at S 1 over one KV
               head); gemma-2b alone (main path, decode tokens/s,
               `first_step_check`).
     train_gemma - gemma-2b whole (18 layers, 8 heads over 1 at head_dim
               256, vocab 256128, tied head) through the trainer's CLI,
               batch 2 x 4096, --loss-chunk 1024, 5 steps, counts from 0:
               flash kernels 1-3 at d 256, forward 2 L steps, dq and dk/dv
               L steps, the serving kernels 0; then one step kernels vs
               plain within FAMILY_TRAIN_LIMITS and FAMILY_MEMORIZE_STEPS
               steps on one batch whose loss must fall (`train_family`).
     finetune_gemma - the finetune phase on gemma-7b at all 28 layers
               (GEMMA_FINETUNE): the LoRA recipe, 2 x 8192 in two
               microbatches, 3 steps, each flash kernel once a layer and
               microbatch, the base bit for bit unchanged, kernels vs
               plain on 2 layers.
     The kernel phase's edge cases include these families' heads: G 1
     at d 64 and G 7 at d 128 in DECODE_EDGES (S 1 and 5),
     PREFILL_EDGES and FLASH_EDGES.
  6. summary - one JSON line {"kernels": [...]} with each kernel's route,
               source, the TPU kernel it replaces, its launches on its
               path (serve phase, serve_int8 phase, train phase) and in
               every phase, finetune, checkpoint and the families'
               phases included ("launches_by_phase"; kernel 4 also by S
               in serve_spec, serve_mixed, serve_async and serve_mixtral's
               spec server, "launches_by_s"),
               error, times
               and bound (kernel 4's S 5 and S 64 cases in `cases`);
               the int8 entries carry "branch": "quant".
               The prefill entry's times and bound are the base-1536
               chunk's, its max_abs_err the worst over the three chunks
               and the edge cases, and `cases` holds each one's numbers
               (the edge cases untimed); the decode entries' max_abs_err
               is the worst over the timed case and DECODE_EDGES, whose
               errors `cases` holds; the flash entries
               likewise hold the training shape's times and bound and the
               worst error over their three cases and FLASH_EDGES.  Four
               more entries, `<kernel>_d256` ("head_dim": 256), hold the
               head-width-256 instantiations: launches in the gemma
               phases (the float branch's main path serve_gemma, the int8
               branch's serve_gemma_int8), gemma-7b's times and bound,
               the worst error of their cases; three more,
               `flash_fwd_d256`, `flash_bwd_dq_d256` and
               `flash_bwd_dkv_d256`, hold flash kernels 1-3 at head width
               256: launches in train_gemma (their main path) and
               finetune_gemma, the times and bound at gemma-7b's heads,
               the worst error of their cases.
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

H, KVH, D, PS = 32, 8, 128, 16
DTYPE = torch.bfloat16
# A bf16 kernel output against its plain version run at f32 on the same
# values, per element, with A the attention of |V| (the plain version on
# |values|): the kernel rounds its output to bf16 once (U_BF16 * |plain|,
# U_BF16 the unit roundoff); the prefill kernel also rounds the
# probabilities to bf16 before the PV product, which moves sum(p v) / l
# by at most U_BF16 * A; F32_SLACK * A covers f32 sums in other orders.
# The int8 branches hold to the same per-element bounds against the plain
# int8 version run at f32 on the same int8 values and f32 scales, A then
# being the attention of |V| at its scales (vs * |v|).  The decode
# kernel converts int8 to f32 exactly and computes as the plain version
# does, so its only rounding is the output's: U_BF16 * |plain|.  The
# prefill kernel stages int8 as bf16, which is exact (|x| <= 127 fits
# bf16's 8-bit significand), takes q . k in f32 from exact bf16 products,
# multiplies the key scales in f32 as the plain version does, and rounds
# p * vs to bf16 before the PV product: |(p vs)' - p vs| <= U_BF16 * p vs,
# so sum (p vs)' v / l moves by at most U_BF16 * sum p vs |v| / l =
# U_BF16 * A; with the output's rounding, U_BF16 * (|plain| + A).
U_BF16 = 2.0 ** -8
F32_SLACK = 2.0 ** -12
# First-decode-step logits, kernels vs plain versions (bf16), through 32
# bf16 layers: the plain version rounds its normalised probabilities to
# bf16, the prefill kernel rounds them before normalising and the decode
# kernel not at all; the per-layer differences compound through the
# residual stream.  Sound runs on an H100 read 3.55%, 3.87% and 3.97% of
# max |logit|; the limit is 1.5x the largest.
LOGITS_REL_TOL = 0.06
# int8 KV cache, 32 layers: each prompt prefilled and decoded one step
# through the int8 kernels and, separately, through the int8 plain
# versions (bf16), so every layer's cache differs by the kernels'
# roundings too; max |kernels - plain| over max |plain logit|, for the
# prefill logits and the first decode step's.  A sound run on an H100
# reads 0.0312-0.0418 over four prompts (eight readings); the limit is
# 1.5x the largest.
INT8_LOGITS_REL_TOL = 0.063
# Unpaged serving (no kernel) against paged serving with kernel='xla', at
# f32: the two read the same cache values through the same plain
# grouped attention over the same read window, so their first decode
# step's logits differ by f32 summation order at most.  At bf16 two read
# formulations of a random-weight model part ways by rounding alone.
UNPAGED_LAYERS = 4
UNPAGED_NEW = 16
UNPAGED_LENS = (40, 230, 700, 1500)
# Prefix sharing: a 2048-token prefix (128 pages of 16) and 64-token
# suffixes; SHARERS requests share it after the first.
PREFIX_LEN, SUFFIX_LEN, SHARERS = 2048, 64, 7
# A sharer's logits against the same prompt prefilled cold: the prefix's
# pages hold what the cold prefill's first PREFIX_LEN / 512 chunks wrote,
# and both run the same last chunk over the same values at the same base
# and shapes, so any difference is a hydrate fault (a wrong page,
# position, layer or scale), not rounding.
PREFIX_LOGITS_GAP = 0.0
UNPAGED_LOGITS_REL_TOL = 1e-4
# Training: llama3-8b widths at 4 of its 32 layers, to keep the run short
# (f32 params, grads and two AdamW moments are 16 bytes a parameter: 128
# GB at full depth does not fit the card, 31 GB at 4 layers leaves room),
# batch 2 x seq 4096, bf16 compute.
TRAIN_LAYERS = 4
TRAIN_STEPS = 5
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
# One step at one batch and the same weights, kernels vs plain versions:
# relative gaps of the loss and of the global grad norm.  The plain
# forward keeps f32 probabilities where the kernel rounds them to bf16,
# and the difference compounds through 4 layers and the backward pass.
# Sound runs on two H100s read the same loss gaps, 1.19e-5 and 9.63e-6,
# and grad-norm gaps, 4.61e-6 and 2.60e-6, on their two batches; the
# limits are about 8x and 10x the largest reading, as two batches say
# little of the spread over other data or software versions.
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_GNORM_REL_TOL = 5e-5
# Memorization: 10 steps on one repeated batch (warmup 2, peak lr 3e-4)
# must lower the loss by more than this, as the reference's
# test_model_train.py::test_loss_decreases demands of its 20 steps.
MEMORIZE_STEPS = 10
MEMORIZE_DROP = 0.5
# Flash-attention cases: (name, B, H, kvh, S, d, window), causal.
FLASH_CASES = (
    ('train', 2, 32, 8, 4096, 128, None),
    ('window', 1, 32, 8, 4096, 128, 1024),
    ('ragged_d64', 1, 32, 8, 1000, 64, None),
)
FLASH_KERNELS = ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')
# Checked, not timed: a query block at an offset past its keys (ring
# attention's chunks), where the diagonal crosses the dq pass's tiles at
# another column than in FLASH_CASES, alone and under a window; (name,
# B, H, kvh, S, d, window, offset).
FLASH_EDGES = (
    ('offset_700', 1, 32, 8, 1024, 128, None, 700),
    ('window_300_offset_200', 1, 32, 8, 1000, 64, 300, 200),
    # The other families' heads: gpt2's (12 over 12: a group of 1, at d
    # 64) at its training shape's sequence, qwen2-7b's (28 over 4: the
    # dk/dv group sum over 7 heads).
    ('gpt2_g1_d64', 2, 12, 12, 1024, 64, None, 0),
    ('qwen2_7b_g7', 1, 28, 4, 2048, 128, None, 0),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over `iters` calls.
    The calls queue behind a busy-wait kernel of about 10 ms, so the
    host's cost of launching them (the wrapper's checks, ctypes) does not
    leave the device idle between them: a fast kernel's time is its own,
    not its launch's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # pylint: disable=protected-access
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(name: str, got: torch.Tensor, plain, args, kw: dict, *,
                 probs_rounded: bool, u: float = U_BF16) -> float:
    """Max abs error of a bf16 kernel output `got` (f16: u = 2^-11, its
    unit roundoff) against `plain(*args, **kw)` run at f32 on the same
    values; raises when an element is not finite or outside u * |plain| +
    F32_SLACK * A (+ u * A when the kernel rounds its probabilities).
    args[2] is the values."""
    args32 = [a.float() if torch.is_tensor(a) and a.is_floating_point()
              else a for a in args]
    kw32 = dict(kw, probs_dtype=torch.float32)
    want = plain(*args32, **kw32).float()
    absv = plain(*args32[:2], args32[2].abs(), *args32[3:], **kw32).float()
    tol = u * want.abs() + F32_SLACK * absv
    if probs_rounded:
        tol += u * absv
    err = (got.float() - want).abs()
    # An element with no bound (an exact zero, e.g. a query that sees one
    # int8 column holding 0) must be exact.
    ratio = torch.where(tol > 0, err / tol,
                        torch.where(err > 0, float('inf'), 0.0))
    worst = ratio.max().item()
    log(f'{name}: max_abs_err {err.max().item():.3e} against the plain '
        f'version at f32; worst element at {worst:.3f} of its bound (mean '
        f'bound {tol.mean().item():.3e}, mean |plain| '
        f'{want.abs().mean().item():.3e})')
    if not (bool(torch.isfinite(got).all()) and worst <= 1.0):
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             'version')
    return err.max().item()


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is false; '
                         'this script needs an NVIDIA card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'python {sys.version.split()[0]}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


def phase_build() -> None:
    from skypilot_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build()
    log(f'build: {time.perf_counter() - t0:.2f}s for {sorted(built)}')
    for name, (path, report) in sorted(built.items()):
        log(f'build {name}: {path.name}')
        for line in report.splitlines():
            if 'Compiling entry function' in line:
                # The kernel's mangled name: its template arguments (type,
                # pool type, head dim) say which instantiation follows.
                log(f'  {line.split(chr(39))[1][:120]}')
            elif ('registers' in line or 'spill' in line or 'smem' in line
                    or line.startswith('nvcc ')):
                log(f'  {line.strip()}')


def _decode_inputs(dev, rng, quant=False):
    """Decode-step inputs: batch 8, contexts 100-4000 over a shuffled
    page pool, a poisoned null page.  With `quant` the pools are
    quantize_int8_rows of the same bf16 rows, and the null page holds
    int8 127 at a scale of 1e4."""
    from skypilot_tpu_torch.ops import grouped_attention as ga
    b = 8
    ctxs = np.linspace(100, 4000, b).astype(int)
    rng.shuffle(ctxs)
    n_read = -(-int(ctxs.max()) // PS)
    need = [-(-int(c) // PS) for c in ctxs]
    n_pages = 1 + sum(need) + 64
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, n_read), np.int32)
    mask = np.zeros((b, 1, 1, n_read * PS), bool)
    at = 0
    for i, (c, n) in enumerate(zip(ctxs, need)):
        table[i, :n] = perm[at:at + n]
        at += n
        mask[i, 0, 0, :c] = True
    g = torch.Generator(device=dev).manual_seed(1)
    pk = torch.randn(n_pages, KVH, PS, D, generator=g, device=dev,
                     dtype=DTYPE)
    pv = torch.randn(n_pages, KVH, PS, D, generator=g, device=dev,
                     dtype=DTYPE)
    scales = {}
    if quant:
        pk, ks = ga.quantize_int8_rows(pk)
        pv, vs = ga.quantize_int8_rows(pv)
        pk[0] = pv[0] = 127   # null page: garbage the mask must keep out
        ks[0] = vs[0] = 1e4
        scales = dict(key_scale=ks, value_scale=vs)
    else:
        pk[0] = 1e4    # null page: garbage the mask must keep out
        pv[0] = 1e4
    q = torch.randn(b, H, 1, D, generator=g, device=dev, dtype=DTYPE)
    return (q, pk, pv, torch.as_tensor(table, device=dev),
            torch.as_tensor(mask, device=dev), ctxs, scales)


def decode_work(ctxs, table, mask, quant: bool):
    """(bytes, flops) of one serving-shape decode step (H 32, kvh 8,
    d 128, S 1): q and out bf16 read and written once, the live K/V rows
    once (int8 with an f32 scale each, or bf16), the table and the mask;
    4 d flops per live position and query head."""
    live = int(np.sum(ctxs))
    b = table.shape[0]
    kv_row = 2 * (D + 4) if quant else 2 * D * 2
    nbytes = (2 * b * H * D * 2 + live * KVH * kv_row
              + table.numel() * 4 + b * mask.shape[-1])
    return nbytes, 4.0 * live * H * D


def _dequantized(x, scale):
    """K/V in bf16 from an int8 cache (the library yardstick's input)."""
    return (x.float() * scale).to(DTYPE)


def _kernel_decode(dev, rng, quant):
    from skypilot_tpu_torch.ops import grouped_attention as ga
    from skypilot_tpu_torch.ops import paged_attention as pa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    name = 'paged_decode_int8' if quant else 'paged_decode'
    q, pk, pv, table, mask, ctxs, scales = _decode_inputs(dev, rng, quant)
    kw = dict(scale=D ** -0.5, probs_dtype=DTYPE, **scales)
    got = pa.paged_decode_attention(q, pk, pv, table, mask, **kw)
    torch.cuda.synchronize()
    log(f'{name}: contexts {sorted(ctxs.tolist())}')
    err = check_kernel(name, got, pa.paged_decode_attention_plain,
                       (q, pk, pv, table, mask),
                       dict(scale=D ** -0.5, **scales), probs_rounded=False)
    kg = ga.gather_pages(pk, table)
    vg = ga.gather_pages(pv, table)
    if quant:   # dequantized beforehand, untimed
        kg = _dequantized(kg, ga.gather_pages(scales['key_scale'], table))
        vg = _dequantized(vg, ga.gather_pages(scales['value_scale'], table))
    ms = time_ms(lambda: pa.paged_decode_attention(q, pk, pv, table, mask,
                                                   **kw))
    plain_ms = time_ms(lambda: pa.paged_decode_attention_plain(
        q, pk, pv, table, mask, **kw))
    lib_ms = time_ms(lambda: sdpa(q, kg, vg, attn_mask=mask,
                                  scale=D ** -0.5, enable_gqa=True))
    bms, by = bound(*decode_work(ctxs, table, mask, quant))
    lib = 'sdpa on K/V dequantized to bf16 beforehand' if quant else 'sdpa'
    log(f'{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
        f'{lib} {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})')
    del q, pk, pv, table, mask, scales, kg, vg, got
    cases = [_kernel_decode_multi(dev, name, quant, s) for s in DECODE_S]
    cases += _decode_edges(dev, name, quant)
    return dict(max_abs_err=max([err] + [c['max_abs_err'] for c in cases]),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, cases=cases)


# Kernel 4 at the query widths of speculation (the pending token and
# k = 4 proposals) and of mixed batches (a 64-token budget), timed and
# checked: batch 8, the decode case's contexts (100-4000), query j of a
# row seeing its first context + j positions.
DECODE_S = (5, 64)


def _kernel_decode_multi(dev, name: str, quant: bool, s: int,
                         heads=(H, KVH, D), case=None) -> dict:
    """Kernel 4 at S queries a row over the decode case's contexts, at
    `heads` (query heads, KV heads, head dim), checked and timed."""
    from skypilot_tpu_torch.ops import grouped_attention as ga
    from skypilot_tpu_torch.ops import paged_attention as pa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, kvh, d = heads
    ctxs = np.linspace(100, 4000, 8).astype(int)
    np.random.RandomState(0).shuffle(ctxs)
    args, scales = _decode_edge_inputs(dev, 200 + s, tuple(ctxs), s, d, PS,
                                       DTYPE, None, quant, h, kvh)
    q, pk, pv, table, mask = args
    kw = dict(scale=d ** -0.5, probs_dtype=DTYPE, **scales)
    got = pa.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    case = case or f's{s}'
    err = check_kernel(f'{name} {case} S {s} heads {h}/{kvh} d {d} '
                       f'(contexts {sorted(ctxs.tolist())})',
                       got, pa.paged_decode_attention_plain, tuple(args),
                       dict(scale=d ** -0.5, **scales), probs_rounded=False)
    kg, vg = ga.gather_pages(pk, table), ga.gather_pages(pv, table)
    if quant:   # dequantized beforehand, untimed
        kg = _dequantized(kg, ga.gather_pages(scales['key_scale'], table))
        vg = _dequantized(vg, ga.gather_pages(scales['value_scale'], table))
    ms = time_ms(lambda: pa.paged_decode_attention(*args, **kw))
    plain_ms = time_ms(lambda: pa.paged_decode_attention_plain(*args, **kw))
    lib_ms = time_ms(lambda: sdpa(q, kg, vg, attn_mask=mask,
                                  scale=d ** -0.5, enable_gqa=True))
    bms, by = bound(*decode_multi_work(ctxs, s, table, mask, quant, heads))
    log(f'{name} {case} S {s} heads {h}/{kvh} d {d}: kernel {ms:.4f} ms, '
        f'plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms '
        f'({by}), kernel at {bms / ms:.3f} of its bound')
    return dict(case=case, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms)


def decode_multi_work(ctxs, s: int, table, mask, quant: bool,
                      heads=(H, KVH, D)):
    """(bytes, flops) of kernel 4 at S queries a row (`heads`: H 32, kvh 8,
    d 128 unless given): q and out bf16 once, each row's K/V rows once
    (its context + S - 1 positions, int8 with an f32 scale or bf16), the
    table and the mask; 4 d flops per visible (query, position) pair and
    query head."""
    h, kvh, d = heads
    b = table.shape[0]
    kv_row = 2 * (d + 4) if quant else 2 * d * 2
    live = int(np.sum(ctxs)) + b * (s - 1)
    pairs = int(np.sum(ctxs)) * s + b * s * (s - 1) // 2
    nbytes = (2 * b * h * s * d * 2 + live * kvh * kv_row
              + table.numel() * 4 + mask.numel())
    return nbytes, 4.0 * pairs * h * d


# Decode cases the kernel's split page walk can get wrong, checked but not
# timed: (name, contexts, S, d, page size, q dtype, window), each with
# H 32 and kvh 8 over a shuffled pool with a poisoned null page, in both
# branches.  Query s of a row sees its first context + s positions (with
# a window, only the last `window` of them); table entries past a row's
# pages point at the null page.  A context of 0 is a row that sees
# nothing (its table full of real pages): the reference gives it the mean
# of V over its read window.  Every case runs twice in a row on different
# inputs before either is checked, so that a merge counter left non-zero
# by the first call shows in the second.
DECODE_EDGES = (
    ('row_shorter_than_a_chunk', (37, 3000), 1, D, PS, DTYPE, None),
    ('long_row_beside_1_position_rows', (4000, 1, 1, 1), 1, D, PS, DTYPE,
     None),
    ('row_sees_nothing', (0, 2000, 5), 1, D, PS, DTYPE, None),
    ('s4_masks', (700, 33, 1), 4, D, PS, DTYPE, None),
    ('window_1024', (4000, 2500, 300), 1, D, PS, DTYPE, 1024),
    ('ps8', (1000, 9), 1, D, 8, DTYPE, None),
    ('ps32', (1000, 40), 1, D, 32, DTYPE, None),
    ('d64', (1500, 17), 1, 64, PS, DTYPE, None),
    ('f16_q', (1500, 17), 1, D, PS, torch.float16, None),
    ('f32_q', (1500, 17), 1, D, PS, torch.float32, None),
    # The other families' heads (an 8th field: query heads, KV heads):
    # gpt2's 12 over 12 at d 64 (a group of 1: each 4-row block carries 3
    # idle rows) and qwen2-7b's 28 over 4 (a group of 7: blocks straddle
    # query heads; at S 5, 35 rows in 9 blocks), at S 1 and S 5.
    ('gpt2_g1_d64', (1000, 300, 17), 1, 64, PS, DTYPE, None, (12, 12)),
    ('gpt2_g1_d64_s5', (900, 40), 5, 64, PS, DTYPE, None, (12, 12)),
    ('qwen2_7b_g7', (3000, 300, 17), 1, D, PS, DTYPE, None, (28, 4)),
    ('qwen2_7b_g7_s5', (900, 40), 5, D, PS, DTYPE, None, (28, 4)),
)


def _decode_edge_inputs(dev, seed, ctxs, s, d, ps, dtype, window, quant,
                        h=H, kvh=KVH):
    from skypilot_tpu_torch.ops import grouped_attention as ga
    g = torch.Generator().manual_seed(seed)
    b = len(ctxs)
    n_read = -(-(max(ctxs) + s - 1) // ps)
    n_pages = 1 + b * n_read + 64
    table = (torch.randperm(n_pages - 1, generator=g)[:b * n_read] + 1
             ).reshape(b, n_read).to(torch.int32)
    mask = torch.zeros(b, 1, s, n_read * ps, dtype=torch.bool)
    for i, c in enumerate(ctxs):
        if c == 0:
            continue
        for qi in range(s):
            lo = 0 if window is None else max(0, c + qi - window)
            mask[i, 0, qi, lo:c + qi] = True
        table[i, -(-(c + s - 1) // ps):] = 0
    pk, pv = (torch.randn(n_pages, kvh, ps, d, generator=g).to(dtype)
              for _ in range(2))
    q = torch.randn(b, h, s, d, generator=g).to(dtype)
    scales = {}
    if quant:
        pk, ks = ga.quantize_int8_rows(pk)
        pv, vs = ga.quantize_int8_rows(pv)
        pk[0] = pv[0] = 127
        ks[0] = vs[0] = 1e4
        scales = dict(key_scale=ks.to(dev), value_scale=vs.to(dev))
    else:
        pk[0] = pv[0] = 1e4
    return ([t.to(dev) for t in (q, pk, pv, table, mask)], scales)


def _decode_edges(dev, name, quant):
    """Check the decode kernel (float or int8 branch) on each DECODE_EDGES
    case; returns one case dict each (max_abs_err, no times)."""
    from skypilot_tpu_torch.ops import paged_attention as pa
    out = []
    for ci, (case, ctxs, s, d, ps, dtype, window, *heads) in enumerate(
            DECODE_EDGES):
        runs = [_decode_edge_inputs(dev, 100 + 2 * ci + k, ctxs, s, d, ps,
                                    dtype, window, quant,
                                    *(heads[0] if heads else ()))
                for k in range(2)]
        gots = [pa.paged_decode_attention(*args, scale=d ** -0.5,
                                          probs_dtype=dtype, **scales)
                for args, scales in runs]
        torch.cuda.synchronize()
        u = {torch.float32: 2.0 ** -24, torch.float16: 2.0 ** -11}.get(
            dtype, U_BF16)
        err = max(check_kernel(
            f'{name} {case} call {k + 1} (contexts {list(ctxs)}, S {s}, '
            f'd {d}, page {ps}, {dtype}, window {window}, heads '
            f'{heads[0] if heads else (H, KVH)})', got,
            pa.paged_decode_attention_plain, tuple(args),
            dict(scale=d ** -0.5, **scales), probs_rounded=False, u=u)
            for k, (got, (args, scales)) in enumerate(zip(gots, runs)))
        out.append(dict(case=case, max_abs_err=err))
        del runs, gots
    return out


# Prefill cases the kernel's tiling can get wrong, checked but not timed:
# (name, S, d, page size, cursor base, dtype, permuted table, window),
# each over a [1, 8, 4096, d] cache whose kv_mask ends at 3000, with 32
# query heads.  A permuted table walks all 4096 / page positions in a
# shuffled page order; visibility follows the physical positions.
PREFILL_EDGES = (
    ('s200', 200, 128, 16, 1100, DTYPE, False, None),
    ('window1024', 512, 128, 16, 1536, DTYPE, False, 1024),
    ('permuted_table', 512, 128, 16, 1536, DTYPE, True, None),
    ('d64', 512, 64, 16, 1536, DTYPE, False, None),
    ('f16', 512, 128, 16, 1536, torch.float16, False, None),
    ('ps8', 512, 128, 8, 1536, DTYPE, False, None),
    ('ps32_base_mid_page', 512, 128, 32, 1541, DTYPE, False, None),
    # gpt2's heads at d 64 (12 over 12) and qwen2-7b's (28 over 4): a
    # 9th field, (query heads, KV heads).
    ('gpt2_g1_d64', 512, 64, 16, 512, DTYPE, False, None, (12, 12)),
    ('qwen2_7b_g7', 512, 128, 16, 1536, DTYPE, False, None, (28, 4)),
)
PREFILL_MAX_LEN, PREFILL_TRUE_LEN = 4096, 3000


def _prefill_cache(dev, g, quant, d=D, dtype=DTYPE, kvh=KVH):
    """keys, values [1, kvh, 4096, d] (int8 with f32 scales when `quant`),
    their scales as kwargs, and the library yardstick's K/V."""
    from skypilot_tpu_torch.ops import grouped_attention as ga
    shape = (1, kvh, PREFILL_MAX_LEN, d)
    keys = torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    values = torch.randn(*shape, generator=g, device=dev, dtype=dtype)
    if not quant:
        return keys, values, {}, (keys, values)
    keys, ks = ga.quantize_int8_rows(keys)
    values, vs = ga.quantize_int8_rows(values)
    return (keys, values, dict(key_scale=ks, value_scale=vs),
            (_dequantized(keys, ks), _dequantized(values, vs)))


def _prefill_edges(dev, name, quant):
    """Check the kernel (float or int8 branch) on each PREFILL_EDGES case;
    returns one case dict each (max_abs_err, no times)."""
    from skypilot_tpu_torch.ops import ragged_prefill as rp
    out = []
    for case, s, d, ps, base, dtype, permuted, window, *heads in \
            PREFILL_EDGES:
        h, kvh = heads[0] if heads else (H, KVH)
        g = torch.Generator(device=dev).manual_seed(5)
        keys, values, scales, _ = _prefill_cache(dev, g, quant, d, dtype,
                                                 kvh)
        qp = torch.randn(1, h, s, d, generator=g, device=dev, dtype=dtype)
        n_pages = PREFILL_MAX_LEN // ps
        if permuted:
            walk = torch.randperm(n_pages, generator=g, device=dev)
        else:   # the engine's read bucket
            walk = torch.arange(-(-(base + s) // 512) * 512 // ps,
                                device=dev)
        tbl = walk.to(torch.int32)[None].contiguous()
        kv_mask = (torch.arange(PREFILL_MAX_LEN, device=dev)
                   < PREFILL_TRUE_LEN)[None]
        kw = dict(scale=d ** -0.5, page_size=ps, window=window, **scales)
        got = rp.ragged_prefill_attention(qp, keys, values, tbl, base,
                                          kv_mask, probs_dtype=dtype, **kw)
        torch.cuda.synchronize()
        err = check_kernel(
            f'{name} {case} (S {s}, d {d}, page {ps}, base {base}, '
            f'{dtype}, window {window}, heads {h}/{kvh})', got,
            rp.ragged_prefill_attention_plain,
            (qp, keys, values, tbl, base, kv_mask), kw, probs_rounded=True,
            u=2.0 ** -11 if dtype == torch.float16 else U_BF16)
        out.append(dict(case=case, max_abs_err=err))
        del keys, values, scales, qp, got
    return out


def _prefill_timed(dev, name, quant, base, g, cache, heads=(H, KVH, D),
                   tag=None) -> dict:
    """One 512-token chunk at cursor `base` over `cache` (as
    `_prefill_cache` gives it, at `heads`), checked and timed against the
    plain version and SDPA."""
    from skypilot_tpu_torch.ops import ragged_prefill as rp
    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, kvh, d = heads
    keys, values, scales, (lib_k, lib_v) = cache
    s, max_len, true_len = 512, PREFILL_MAX_LEN, PREFILL_TRUE_LEN
    tag = tag or f'{name} base {base}'
    kv_mask = (torch.arange(max_len, device=dev) < true_len)[None]
    qp = torch.randn(1, h, s, d, generator=g, device=dev, dtype=DTYPE)
    read_len = -(-(base + s) // 512) * 512   # the engine's read bucket
    n_read = read_len // PS
    tbl = torch.arange(n_read, dtype=torch.int32,
                       device=dev)[None].contiguous()
    # The cursor base as the engine passes it: an int32 device tensor.
    base_t = torch.tensor([base], dtype=torch.int32, device=dev)
    pkw = dict(scale=d ** -0.5, probs_dtype=DTYPE, page_size=PS, **scales)
    got = rp.ragged_prefill_attention(qp, keys, values, tbl, base_t,
                                      kv_mask, **pkw)
    torch.cuda.synchronize()
    err = check_kernel(tag, got, rp.ragged_prefill_attention_plain,
                       (qp, keys, values, tbl, base_t, kv_mask),
                       dict(scale=d ** -0.5, page_size=PS, **scales),
                       probs_rounded=True)
    pos = torch.arange(read_len, device=dev)
    qpos = base + torch.arange(s, device=dev)
    lib_mask = ((pos[None, :] <= qpos[:, None])
                & kv_mask[0, :read_len][None])[None, None]
    kr = lib_k[:, :, :read_len]
    vr = lib_v[:, :, :read_len]
    ms = time_ms(lambda: rp.ragged_prefill_attention(
        qp, keys, values, tbl, base_t, kv_mask, **pkw))
    plain_ms = time_ms(lambda: rp.ragged_prefill_attention_plain(
        qp, keys, values, tbl, base_t, kv_mask, **pkw))
    lib_ms = time_ms(lambda: sdpa(qp, kr, vr, attn_mask=lib_mask,
                                  scale=d ** -0.5, enable_gqa=True))
    bms, by = bound(*prefill_work(s, base, quant, heads))
    lib = 'sdpa on K/V dequantized to bf16 beforehand' if quant else 'sdpa'
    log(f'{tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {lib} '
        f'{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})')
    return dict(base=base, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms)


def _kernel_prefill(dev, quant):
    name = 'ragged_prefill_int8' if quant else 'ragged_prefill'
    g = torch.Generator(device=dev).manual_seed(2)
    cache = _prefill_cache(dev, g, quant)
    cases = [_prefill_timed(dev, name, quant, base, g, cache)
             for base in (0, 1536, 2560)]
    del cache
    cases += _prefill_edges(dev, name, quant)
    main = dict(next(c for c in cases if c.get('base') == 1536))
    del main['base']
    main['max_abs_err'] = max(c['max_abs_err'] for c in cases)
    return dict(main, cases=cases)


def prefill_work(s: int, base: int, quant: bool, heads=(H, KVH, D)):
    """(bytes, flops) of one serving-shape prefill chunk (`heads`: H 32,
    kvh 8, d 128 unless given; a 3000-token kv_mask): q and out bf16 read
    and written once, the live K/V rows once (int8 with an f32 scale
    each, or bf16), the kv_mask row and the table; 4 d flops per visible
    (query, column) pair and query head."""
    h, kvh, d = heads
    pairs = sum(min(base + i + 1, PREFILL_TRUE_LEN) for i in range(s))
    kv_row = 2 * (d + 4) if quant else 2 * d * 2
    n_read = -(-(base + s) // 512) * 512 // PS
    nbytes = (2 * s * h * d * 2 + min(base + s, PREFILL_TRUE_LEN) * kvh
              * kv_row + PREFILL_MAX_LEN + n_read * 4)
    return nbytes, 4.0 * pairs * h * d


# Kernels 4 and 5 at head width 256, the serve_gemma shapes, both
# branches, checked and timed: decode over the decode case's contexts
# (100-4000, batch 8) at gemma-7b's heads (16 over 16: a group of 1) at
# S 1 (the entry's times) and S 5 (a verify), and at gemma-2b's (8 over
# 1: a group of 8); prefill a 512-token chunk at base 1536 of a 4096-token
# cache, gemma-7b's heads (the entry's times) and gemma-2b's.
GEMMA_D = 256
GEMMA_DECODE = (('gemma_7b', 16, 16, 1), ('gemma_7b_s5', 16, 16, 5),
                ('gemma_2b_g8', 8, 1, 1))
GEMMA_PREFILL = (('gemma_7b', 16, 16), ('gemma_2b_g8', 8, 1))


def phase_kernels_d256(dev) -> dict:
    """Kernels 4 and 5 at head width 256 (GEMMA_DECODE, GEMMA_PREFILL),
    float and int8 branches: entries `<kernel>_d256` whose times and bound
    are gemma-7b's S 1 decode and base-1536 chunk, whose max_abs_err is
    the worst of their cases, and whose `cases` hold each case's
    numbers."""
    results = {}
    for quant in (False, True):
        tag = '_int8' if quant else ''
        name = f'paged_decode{tag}_d256'
        cases = [_kernel_decode_multi(dev, name, quant, s,
                                      (h, kvh, GEMMA_D), case)
                 for case, h, kvh, s in GEMMA_DECODE]
        results[name] = dict(cases[0], max_abs_err=max(
            c['max_abs_err'] for c in cases), cases=cases)
        del results[name]['case']
        _free()
        name = f'ragged_prefill{tag}_d256'
        cases = []
        for case, h, kvh in GEMMA_PREFILL:
            g = torch.Generator(device=dev).manual_seed(3)
            cache = _prefill_cache(dev, g, quant, GEMMA_D, DTYPE, kvh)
            cases.append(dict(case=case, **_prefill_timed(
                dev, name, quant, 1536, g, cache, (h, kvh, GEMMA_D),
                f'{name} {case} base 1536 heads {h}/{kvh}')))
            del cache
            _free()
        results[name] = dict(cases[0], max_abs_err=max(
            c['max_abs_err'] for c in cases), cases=cases)
        del results[name]['case'], results[name]['base']
    return results


# Flash kernels 1-3 at head width 256 (`phase_flash_d256`), checked and
# timed at the train_gemma and finetune_gemma heads, B 2 x S 4096, causal:
# gemma-7b's (16 over 16, the entries' numbers) and gemma-2b's (8 over 1:
# the dk/dv group sum over 8 heads; SDPA gets K/V repeated 8 times).
# Checked only: a 1024-token window, a ragged S 1000, queries at an offset
# of 700 (name, B, H, kvh, S, d, window, offset).
FLASH_D256_CASES = (
    ('gemma_7b', 2, 16, 16, 4096, GEMMA_D, None),
    ('gemma_2b_g8', 2, 8, 1, 4096, GEMMA_D, None),
)
FLASH_D256_EDGES = (
    ('window_1024', 1, 16, 16, 4096, GEMMA_D, 1024, 0),
    ('ragged_1000_g8', 1, 8, 1, 1000, GEMMA_D, None, 0),
    ('offset_700_g8', 1, 8, 1, 1024, GEMMA_D, None, 700),
)


def phase_kernels(dev, quant=(False, True),
                  kernels=('paged_decode', 'ragged_prefill')) -> dict:
    """The serving kernels at llama3-8b shapes, float and int8 branches
    (`quant` and `kernels` pick which)."""
    results = {}
    for q in (False, True):
        if q not in quant:
            continue
        tag = '_int8' if q else ''
        if 'paged_decode' in kernels:
            results['paged_decode' + tag] = _kernel_decode(
                dev, np.random.RandomState(0), q)
        if 'ragged_prefill' in kernels:
            results['ragged_prefill' + tag] = _kernel_prefill(dev, q)
    return results


def check_flash(name: str, got: torch.Tensor, want: torch.Tensor,
                tol: torch.Tensor) -> float:
    """Max abs error of a flash kernel output against its plain version
    at f32; raises when an element is not finite or outside `tol`."""
    err = (got.float() - want.float()).abs()
    ratio = torch.where(tol > 0, err / tol,
                        torch.where(err > 0, float('inf'), 0.0))
    worst = ratio.max().item()
    log(f'{name}: max_abs_err {err.max().item():.3e} against the plain '
        f'version at f32; worst element at {worst:.3f} of its bound (mean '
        f'bound {tol.mean().item():.3e}, mean |plain| '
        f'{want.float().abs().mean().item():.3e})')
    if not (bool(torch.isfinite(got).all()) and worst <= 1.0):
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             'version')
    return err.max().item()


def _flash_work(b, h, kvh, s, d, window):
    """(bytes, flops) of each flash kernel for one causal case: each
    input read once and each output written once; flops over the visible
    (query, key) pairs, 2 d per product: the forward has two products a
    pair (S, PV), dq three (S, dP, dS K), dk/dv four (S, dP, P^T dO,
    dS^T Q)."""
    pairs = sum(min(r + 1, window or r + 1) for r in range(s)) * b * h
    q_bytes = b * h * s * d * 2
    kv_bytes = 2 * b * kvh * s * d * 2
    row_bytes = b * h * s * 4
    return {
        'flash_fwd': (2 * q_bytes + kv_bytes + row_bytes, 4.0 * pairs * d),
        'flash_bwd_dq': (2 * q_bytes + kv_bytes + 2 * row_bytes
                         + b * h * s * d * 4, 6.0 * pairs * d),
        'flash_bwd_dkv': (2 * q_bytes + kv_bytes + 2 * row_bytes
                          + 2 * b * kvh * s * d * 4, 8.0 * pairs * d),
    }


def _flash_case(dev, seed, case, b, h, kvh, s, d, window, offset=0,
                timed=True, full=False):
    """Check one flash case; time it: every kernel, its plain version and
    SDPA when `full`, else only the forward; nothing when not `timed`
    (the edge cases).  Returns
    (max_abs_err, (ms, plain_ms), library_ms) per kernel name."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(*shape, generator=g, device=dev, dtype=DTYPE)
                   for shape in ((b, h, s, d), (b, kvh, s, d),
                                 (b, kvh, s, d), (b, h, s, d)))
    kw = dict(scale=d ** -0.5, causal=True, window=window, offset=offset)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    log(f'flash {case}: B {b} H {h} kvh {kvh} S {s} d {d} window {window} '
        f'offset {offset}')
    tol = fa.rounding_bounds(q, k, v, do, lse, delta, **kw)
    f32 = [x.float() for x in (q, k, v, do)]
    out32, lse32 = fa.flash_fwd_plain(*f32[:3], **kw)
    err_f = max(check_flash(f'flash_fwd {case} out', out, out32, tol['out']),
                check_flash(f'flash_fwd {case} lse', lse, lse32, tol['lse']))
    del out32, lse32
    dq32, dk32, dv32 = fa.flash_bwd_plain(*f32, lse, delta, **kw)
    err_dq = check_flash(f'flash_bwd_dq {case} dq', dq, dq32, tol['dq'])
    err_dkv = max(check_flash(f'flash_bwd_dkv {case} dk', dk, dk32,
                              tol['dk']),
                  check_flash(f'flash_bwd_dkv {case} dv', dv, dv32,
                              tol['dv']))
    del dq32, dk32, dv32, f32, tol
    errs = dict(zip(FLASH_KERNELS, (err_f, err_dq, err_dkv)))
    fwd = lambda: fa.flash_fwd(q, k, v, **kw)
    if not timed:
        return errs, {}, {}
    if not full:
        return errs, {'flash_fwd': (time_ms(fwd), None)}, {}
    plain_bwd = time_ms(lambda: fa.flash_bwd_plain(q, k, v, do, lse, delta,
                                                   **kw), iters=5, warmup=1)
    times = {
        'flash_fwd': (time_ms(fwd), time_ms(
            lambda: fa.flash_fwd_plain(q, k, v, **kw), iters=5, warmup=1)),
        'flash_bwd_dq': (time_ms(lambda: fa.flash_bwd_dq(
            q, k, v, do, lse, delta, **kw)), plain_bwd),
        'flash_bwd_dkv': (time_ms(lambda: fa.flash_bwd_dkv(
            q, k, v, do, lse, delta, **kw)), plain_bwd),
    }
    lib_f, lib_b = sdpa_times(q, k, v, do, kw['scale'])
    log(f'flash {case}: sdpa forward {lib_f:.4f} ms, backward alone '
        f'{lib_b:.4f} ms (autograd.grad over one saved forward); the '
        'plain backward computes dq, dk and dv together')
    return errs, times, dict(zip(FLASH_KERNELS, (lib_f, lib_b, lib_b)))


def sdpa_times(q, k, v, do, scale):
    """(forward ms, backward-alone ms) of causal SDPA on the flash
    kernels' inputs, K/V repeated to H heads beforehand: the library
    yardsticks of the forward and of the dq and dk/dv passes (the port
    never calls SDPA).  The backward is torch.autograd.grad over one
    saved forward, its graph retained between calls."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = q.shape[1] // k.shape[1]
    krep, vrep = (x.repeat_interleave(g, dim=1) for x in (k, v))
    fwd = time_ms(lambda: sdpa(q, krep, vrep, is_causal=True, scale=scale))
    leaves = [x.detach().requires_grad_() for x in (q, krep, vrep)]
    out = sdpa(*leaves, is_causal=True, scale=scale)
    bwd = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                              retain_graph=True))
    return fwd, bwd


def phase_flash_kernels(dev, cases=FLASH_CASES, edges=FLASH_EDGES,
                        full=('train',), suffix='', seed=10) -> dict:
    """Flash kernels 1-3 on `cases` (checked and timed: every kernel, its
    plain version and SDPA in the cases `full` names, else the forward
    alone) and `edges` (checked): entries `<kernel><suffix>` whose times,
    bound and library time are those of `full[0]` and whose max_abs_err
    is the worst of every case."""
    results = {name: dict(cases=[]) for name in FLASH_KERNELS}
    for ci, (case, b, h, kvh, s, d, window) in enumerate(cases):
        errs, times, libs = _flash_case(dev, seed + ci, case, b, h, kvh, s,
                                        d, window, full=case in full)
        torch.cuda.empty_cache()
        work = _flash_work(b, h, kvh, s, d, window)
        for name in FLASH_KERNELS:
            bms, by = bound(*work[name])
            entry = dict(case=case, max_abs_err=errs[name], bound_ms=bms,
                         bound_by=by)
            if name in times:
                entry['ms'], entry['plain_ms'] = times[name]
                log(f'{name}{suffix} {case}: kernel {entry["ms"]:.4f} ms, '
                    f'plain {entry["plain_ms"]} ms, library '
                    f'{libs.get(name)} ms, bound {bms:.4f} ms ({by})')
            if name in libs:
                entry['library_ms'] = libs[name]
            results[name]['cases'].append(entry)
    for ci, (case, b, h, kvh, s, d, window, offset) in enumerate(edges):
        errs = _flash_case(dev, seed + 10 + ci, case, b, h, kvh, s, d,
                           window, offset, timed=False)[0]
        torch.cuda.empty_cache()
        for name in FLASH_KERNELS:
            results[name]['cases'].append(dict(case=case,
                                               max_abs_err=errs[name]))
    for res in results.values():
        main = next(c for c in res['cases'] if c['case'] == full[0])
        res.update(max_abs_err=max(c['max_abs_err'] for c in res['cases']),
                   ms=main['ms'], plain_ms=main['plain_ms'],
                   bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                   library_ms=main['library_ms'])
    return {name + suffix: res for name, res in results.items()}


def phase_flash_d256(dev) -> dict:
    """Flash kernels 1-3 at head width 256 (FLASH_D256_CASES, timed,
    FLASH_D256_EDGES): entries `<kernel>_d256` with gemma-7b's numbers."""
    results = phase_flash_kernels(
        dev, FLASH_D256_CASES, FLASH_D256_EDGES,
        full=tuple(c[0] for c in FLASH_D256_CASES), suffix='_d256', seed=30)
    for res in results.values():
        res['head_dim'] = GEMMA_D
    return results


def _post(url: str, body: dict, timeout: float = 600) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise AssertionError(f'{url}: HTTP {resp.status}')
        return json.loads(resp.read())


SERVE_KERNELS = ('paged_decode', 'ragged_prefill')
SERVE_KERNELS_INT8 = ('paged_decode_int8', 'ragged_prefill_int8')


def _start_server(dev, kv_cache_dtype: str, quantize=None, **flags):
    """The port's InferenceServer on llama3-8b at full width and depth
    (random bf16 weights from the engine's seed 0, so every call serves
    the same weights; with quantize='int8' their int8 quantization), with
    `flags` (speculation, mixed batches), answering on a free localhost
    port.  Returns (server, its HTTP thread, base url)."""
    from skypilot_tpu_torch.infer import server as server_lib
    t0 = time.perf_counter()
    srv = server_lib.InferenceServer(
        model='llama3-8b', port=0, host='127.0.0.1', max_batch_size=8,
        max_seq_len=4096, prefill_chunk=512, page_size=16,
        allow_random_weights=True, kv_cache_dtype=kv_cache_dtype,
        quantize=quantize, device=dev, **flags)
    eng = srv.engine
    cfg = eng.config
    log(f'serve[{kv_cache_dtype}]: llama3-8b dim {cfg.dim} layers '
        f'{cfg.n_layers} heads {cfg.n_heads}/{cfg.n_kv_heads} ffn '
        f'{cfg.ffn_dim} vocab {cfg.vocab_size} {cfg.dtype}, weights '
        f'{quantize or cfg.param_dtype}, KV cache {eng.kv_cache_dtype}, '
        f'{flags}; kernels decode={eng.decode_kernel} '
        f'prefill={eng.prefill_kernel}; ready in '
        f'{time.perf_counter() - t0:.1f}s, '
        f'{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated')
    if (eng.decode_kernel, eng.prefill_kernel) != ('fused', 'fused'):
        raise AssertionError('serving path does not run the CUDA kernels')
    if eng.kv_cache_dtype != kv_cache_dtype:
        raise AssertionError(f'KV cache is {eng.kv_cache_dtype}')
    srv.start()
    http_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    http_thread.start()
    url = f'http://127.0.0.1:{srv.port}'
    with urllib.request.urlopen(url + '/health', timeout=60) as r:
        if json.loads(r.read()).get('status') != 'ok':
            raise AssertionError('/health is not ok')
    return srv, http_thread, url


GREEDY_LENS = [40, 200, 500, 900, 1400, 2000, 2500, 3000]
SAMPLED_LENS = [300, 1000]
SERVE_NEW = 32


def _post_all(url: str, reqs: list) -> tuple:
    """POST each request to /generate from its own thread, all at once;
    (first completion of each, seconds until the last answered).  Raises
    when a request fails."""
    out = [None] * len(reqs)
    errors = []

    def one(i):
        try:
            out[i] = _post(url + '/generate', reqs[i])['tokens'][0]
        except Exception as e:  # pylint: disable=broad-except
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f'requests failed: {errors}')
    return out, time.perf_counter() - t0


def _check_branches(launches: dict, kv_cache_dtype: str, tag: str) -> None:
    """Serving from a `kv_cache_dtype` cache launches only that cache's
    branches of kernels 4 and 5, each at least once."""
    ran, idle = ((SERVE_KERNELS_INT8, SERVE_KERNELS)
                 if kv_cache_dtype == 'int8'
                 else (SERVE_KERNELS, SERVE_KERNELS_INT8))
    if min(launches[k] for k in ran) <= 0 or any(launches[k] for k in idle):
        raise AssertionError(f'{tag} serving must launch only {ran}, each '
                             f'at least once: {launches}')


def _serve_main_path(url: str, vocab: int, rng, kv_cache_dtype: str,
                     tag=None, lens=(GREEDY_LENS, SAMPLED_LENS)):
    """The main path: 8 concurrent greedy and 2 sampled /generate
    requests (prompt lengths `lens`), with every launch count set to 0
    just before and read just after.  Returns (completions, launches,
    the requests)."""
    tag = tag or kv_cache_dtype
    greedy_lens, sampled_lens = lens
    reqs = [dict(prompt_ids=[rng.randint(0, vocab, n).tolist()],
                 max_new_tokens=SERVE_NEW, temperature=0.0)
            for n in greedy_lens]
    reqs += [dict(prompt_ids=[rng.randint(0, vocab, n).tolist()],
                  max_new_tokens=SERVE_NEW, temperature=0.8, top_k=50,
                  top_p=0.9, seed=i) for i, n in enumerate(sampled_lens)]
    _reset_launch_counts()
    out, burst_s = _post_all(url, reqs)
    launches = _launch_counts()
    for toks in out:
        if len(toks) != SERVE_NEW or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f'bad completion: {toks}')
    log(f'serve[{tag}]: {len(reqs)} concurrent requests, '
        f'{sum(greedy_lens) + sum(sampled_lens)} prompt tokens, '
        f'{len(reqs) * SERVE_NEW} generated, in {burst_s:.2f}s; launches '
        f'{launches}')
    _check_branches(launches, kv_cache_dtype, tag)
    return out, launches, reqs


def _serve_repeat_and_rates(url: str, eng, rng, reqs, out,
                            tag: str) -> dict:
    """A repeated greedy prompt gives the same tokens (the second request
    shares the first's prompt pages); prefill and decode tokens/s over
    HTTP, on prompts no earlier request registered: no page is shared
    while the rates are timed."""
    vocab = eng.config.vocab_size
    rep = reqs[1]
    first = _post(url + '/generate', rep)['tokens'][0]
    second = _post(url + '/generate', rep)['tokens'][0]
    if first != second:
        raise AssertionError(f'greedy repeat differs: {first} {second}')
    log(f'serve[{tag}]: repeated greedy prompt identical '
        f'({len(first)} tokens; equal to its burst completion: '
        f'{first == out[1]})')
    hits0 = eng.prefix_hit_pages
    # Prefill throughput: one 3000-token prompt, time to its one token.
    long_req = dict(prompt_ids=[rng.randint(0, vocab, 3000).tolist()],
                    max_new_tokens=1)
    t0 = time.perf_counter()
    _post(url + '/generate', long_req)
    prefill_tps = 3000 / (time.perf_counter() - t0)
    if eng.prefix_hit_pages != hits0:
        raise AssertionError(f'serve[{tag}]: the timed requests shared pages')
    decode_tps = _decode_rate(url, eng, rng, tag)
    log(f'serve[{tag}]: prefill {prefill_tps:.1f} tokens/s (one '
        f'3000-token prompt over HTTP, first token included); decode '
        f'{decode_tps:.1f} tokens/s at batch 8 (33- minus 1-token runs)')
    return dict(prefill_tps=prefill_tps, decode_tps=decode_tps)


def _decode_rate(url: str, eng, rng, tag: str, new: int = 33) -> float:
    """Decode tokens/s at batch 8 over HTTP: `new`- minus 1-token runs,
    each over 8 new prompts of 64 tokens (so that both prefill the same
    work and share no page)."""
    vocab = eng.config.vocab_size
    hits0 = eng.prefix_hit_pages
    batches = [[rng.randint(0, vocab, 64).tolist() for _ in range(8)]
               for _ in range(2)]
    t0 = time.perf_counter()
    _post(url + '/generate', dict(prompt_ids=batches[0], max_new_tokens=1))
    t1 = time.perf_counter()
    _post(url + '/generate', dict(prompt_ids=batches[1], max_new_tokens=new))
    t2 = time.perf_counter()
    if eng.prefix_hit_pages != hits0:
        raise AssertionError(f'serve[{tag}]: the timed requests shared pages')
    return 8 * (new - 1) / ((t2 - t1) - (t1 - t0))


# The host calls that launch device work, as torch.profiler names them: a
# kernel launch (PyTorch's, cuBLAS's, the port's kernels') or a graph's.
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
                'cuLaunchKernelEx', 'cudaGraphLaunch')
# The decode loop's modes: (async_pipeline, CUDA graphs).
DECODE_MODES = {'sync_eager': (False, False), 'async_eager': (True, False),
                'async_graphs': (True, True)}


def set_decode_mode(eng, mode: str, graphs) -> None:
    """Put the engine in one of DECODE_MODES (the step in flight joined
    first); `graphs` is the engine's own DecodeGraphs, switched off for
    the eager modes.  A measurement seam: the engine has no knob for it."""
    eng._fence()  # pylint: disable=protected-access
    eng.async_pipeline, use_graphs = DECODE_MODES[mode]
    eng._graphs = graphs if use_graphs else None  # pylint: disable=protected-access


def decode_window(eng, steps: int = 16, profile: bool = True) -> dict:
    """One decode step at batch 8 (8 live slots over 64-token prompts),
    over a torch.profiler trace of `steps` steps, as
    scripts/port_profile.py's decode window measures it: wall ms a step
    (host clock, the device synchronized at the end), device busy ms (the
    union of the kernels' intervals; None when the trace holds no device
    event), the idle share, device kernels a step and host launch calls
    a step (LAUNCH_CALLS).  Without `profile` only the wall ms, with the
    profiler off (an eager step leaves some 5000 events in a trace, which
    take seconds to read)."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    rng = np.random.RandomState(9)
    for _ in range(8):
        eng.submit(rng.randint(0, eng.config.vocab_size, 64).tolist(),
                   engine_lib.SamplingConfig(max_new_tokens=steps + 4))
    eng.step()      # admits and prefills all 8, first decode step
    eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with (torch.profiler.profile(activities=acts) if profile
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    eng.run_until_idle()
    if not profile:
        return dict(wall_ms=wall)
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = union_us(spans) / steps / 1e3 if spans else None
    return dict(wall_ms=wall, busy_ms=busy,
                idle=None if busy is None else 1.0 - busy / wall,
                kernels=len(spans) / steps,
                host_launches=sum(e.name in LAUNCH_CALLS
                                  for e in events) / steps)


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals: a trace's device
    busy time (scripts/port_profile.py reads it too)."""
    busy, hi = 0.0, float('-inf')
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, hi))
        hi = max(hi, b)
    return busy


def first_step_check(eng, prompt, tag: str) -> torch.Tensor:
    """The first decode step of `prompt` through the kernels and through
    their plain versions over the same cache: within LOGITS_REL_TOL of
    max |logit|.  Returns the kernels' logits [V] (CPU, f32)."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    rid = eng.submit(prompt, engine_lib.SamplingConfig(max_new_tokens=4))
    while all(s is None for s in eng._slots):  # pylint: disable=protected-access
        eng._schedule_front()  # pylint: disable=protected-access
    fused = eng.decode_logits('fused').float()
    plain = eng.decode_logits('plain').float()
    row = next(i for i, s in enumerate(eng._slots) if s is not None)  # pylint: disable=protected-access
    diff = (fused[row] - plain[row]).abs().max().item()
    scale = plain[row].abs().max().item()
    log(f'{tag}: first decode step logits, kernels vs plain: max abs diff '
        f'{diff:.3e}, max |logit| {scale:.3e} (tolerance '
        f'{LOGITS_REL_TOL} x max |logit|), argmax equal '
        f'{int(fused[row].argmax()) == int(plain[row].argmax())}')
    if not (torch.isfinite(fused[row]).all()
            and diff <= LOGITS_REL_TOL * scale):
        raise AssertionError(f'{tag}: kernel logits disagree with the plain '
                             'path')
    eng.cancel(rid)
    eng.step()
    return fused[row].cpu()


def weight_bytes(eng) -> int:
    """Bytes of the model's weights (int8 weights with their scales)."""
    return sum(t.nbytes for t in eng.model.state_dict().values())


def phase_serve(dev) -> dict:
    """bf16 KV cache.  Returns the launches, the greedy completions, the
    pools' and weights' bytes, a decode step's busy ms, one 700-token
    prompt with its first decode step's logits through the kernels (for
    serve_int8's and serve_wint8's readings), and the engine (serve_prefix
    prefills cold on it)."""
    srv, http_thread, url = _start_server(dev, 'auto')
    eng = srv.engine
    vocab = eng.config.vocab_size
    rng = np.random.RandomState(3)
    out, launches, reqs = _serve_main_path(url, vocab, rng, 'auto')
    _serve_repeat_and_rates(url, eng, rng, reqs, out, 'auto')
    srv.shutdown()
    http_thread.join(timeout=30)
    busy = decode_window(eng)['busy_ms']
    log(f'serve: decode step at batch 8, device busy {busy} ms; weights '
        f'{weight_bytes(eng)} bytes')
    # First decode step of one request: kernels vs plain versions.
    prompt = rng.randint(0, vocab, 700).tolist()
    logits = first_step_check(eng, prompt, 'serve')
    return dict(launches=launches, greedy=out[:len(GREEDY_LENS)],
                pool_bytes=eng._cache.nbytes(),  # pylint: disable=protected-access
                weight_bytes=weight_bytes(eng), decode_busy_ms=busy,
                prompt=prompt, logits=logits, engine=eng)


def prefill_ms(eng, prompt) -> float:
    """Wall ms from submitting `prompt` to its slot going live (admission,
    hydrate, every chunk step, the insert), the device synchronized at
    both ends; the slot is freed again."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid = eng.submit(prompt, engine_lib.SamplingConfig(max_new_tokens=4))
    while not any(s is not None and s.request_id == rid
                  for s in eng._slots):  # pylint: disable=protected-access
        eng._schedule_front()  # pylint: disable=protected-access
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    eng.cancel(rid)
    eng.step()
    return ms


def phase_serve_prefix(dev, cold) -> dict:
    """Prefix sharing on a server like serve's (same weights); `cold` is
    serve's engine, which has none of these prompts in its pool."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    gc.collect()
    srv, http_thread, url = _start_server(dev, 'auto')
    eng = srv.engine
    alloc = eng._alloc  # pylint: disable=protected-access
    vocab = eng.config.vocab_size
    rng = np.random.RandomState(8)
    pages = PREFIX_LEN // PS

    def prompts_of(prefix, n):
        return [prefix + rng.randint(0, vocab, SUFFIX_LEN).tolist()
                for _ in range(n)]

    prompts = prompts_of(rng.randint(0, vocab, PREFIX_LEN).tolist(),
                         1 + SHARERS)
    # The main path: every count set to 0 just before, read just after.
    _reset_launch_counts()
    eng.prefix_hit_pages = eng.prefix_miss_pages = 0
    alloc.peak_live_pages = alloc.live_pages
    t0 = time.perf_counter()
    first = _post(url + '/generate', dict(
        prompt_ids=[prompts[0]], max_new_tokens=SERVE_NEW))['tokens'][0]
    t1 = time.perf_counter()
    out, burst_s = _post_all(url, [dict(prompt_ids=[p],
                                        max_new_tokens=SERVE_NEW)
                                   for p in prompts[1:]])
    launches = _launch_counts()
    hits, misses = eng.prefix_hit_pages, eng.prefix_miss_pages
    peak = alloc.peak_live_pages
    srv.shutdown()
    http_thread.join(timeout=30)
    log(f'serve_prefix: one request of a {PREFIX_LEN}-token prefix and a '
        f'{SUFFIX_LEN}-token suffix in {t1 - t0:.2f}s, then {SHARERS} '
        f'concurrent sharers in {burst_s:.2f}s ({SERVE_NEW} new tokens '
        f'each); prefix-hit pages {hits} (expected {SHARERS * pages}), '
        f'pages allocated {misses}; peak live pages {peak}; launches '
        f'{launches}')
    for toks in [first] + out:
        if len(toks) != SERVE_NEW or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f'bad completion: {toks}')
    _check_branches(launches, 'auto', 'serve_prefix')
    if hits != SHARERS * pages:
        raise AssertionError(f'serve_prefix: {hits} prefix-hit pages, '
                             f'expected {SHARERS * pages}')
    # The same sharers on serve's engine, admitted together with nothing
    # of theirs in its pool: no page shared.
    cold_alloc = cold._alloc  # pylint: disable=protected-access
    cold_alloc.peak_live_pages = cold_alloc.live_pages
    cold_hits = cold.prefix_hit_pages
    want = cold.generate(prompts[1:], engine_lib.SamplingConfig(
        max_new_tokens=SERVE_NEW))
    cold_peak = cold_alloc.peak_live_pages
    if cold.prefix_hit_pages != cold_hits:
        raise AssertionError('serve_prefix: the cold engine shared pages')
    agree = sum(a == b for x, y in zip(out, want) for a, b in zip(x, y))
    log(f'serve_prefix: the same {SHARERS} requests without sharing (serve\'s '
        f'engine): peak live pages {cold_peak} against {peak} shared; greedy '
        f'tokens equal at the same position {agree} of {SHARERS * SERVE_NEW}')
    # Prefill time, cold (5 chunk steps) and sharing (the prefix's pages
    # hydrated, one 64-token chunk), each twice over new prompts.
    prefixes = [rng.randint(0, vocab, PREFIX_LEN).tolist() for _ in range(2)]
    cold_ms = [prefill_ms(eng, prompts_of(p, 1)[0]) for p in prefixes]
    hits0 = eng.prefix_hit_pages
    shared_ms = [prefill_ms(eng, prompts_of(p, 1)[0]) for p in prefixes]
    if eng.prefix_hit_pages - hits0 != 2 * pages:
        raise AssertionError('serve_prefix: timed sharers did not share')
    log(f'serve_prefix: prefill ms of a {PREFIX_LEN + SUFFIX_LEN}-token '
        f'prompt, cold {[round(x, 2) for x in cold_ms]}, sharing its '
        f'{PREFIX_LEN}-token prefix {[round(x, 2) for x in shared_ms]}')
    # Sharers of the first timed prefix against the same prompts
    # prefilled cold: prefill and first decode step logits.
    check = prompts_of(prefixes[0], SHARERS)
    hits0 = eng.prefix_hit_pages
    got = first_step_logits(eng, check, 'fused')
    if eng.prefix_hit_pages - hits0 != SHARERS * pages:
        raise AssertionError('serve_prefix: checked sharers did not share')
    ref = unshared_first_step_logits(cold, check, 'fused')
    gaps = []
    for g, w in zip(got, ref):
        ok = bool(torch.isfinite(g).all())
        gaps.append(max(((g[i] - w[i]).abs().max() / w[i].abs().max()).item()
                        if ok else float('inf') for i in range(SHARERS)))
    log(f'serve_prefix: {SHARERS} sharers against the same prompts '
        f'prefilled cold, max abs diff over max |logit|: prefill '
        f'{gaps[0]:.3e}, first decode step {gaps[1]:.3e} (limit '
        f'{PREFIX_LOGITS_GAP})')
    if not max(gaps) <= PREFIX_LOGITS_GAP:
        raise AssertionError('serve_prefix: shared prefill disagrees with '
                             'cold prefill')
    return dict(launches=launches, hits=hits, peak=peak,
                cold_peak=cold_peak, cold_ms=cold_ms, shared_ms=shared_ms,
                gaps=gaps, agree=agree)


def phase_serve_wint8(dev, bf16: dict) -> dict:
    """int8 weights, bf16 KV cache, after the bf16 servers are freed: the
    same requests as serve's; the weight bytes and a decode step's busy
    ms against serve's; the kernels against their plain versions on the
    int8 weights; reading: the gap to the bf16 weights' logits."""
    gc.collect()
    torch.cuda.empty_cache()
    srv, http_thread, url = _start_server(dev, 'auto', quantize='int8')
    eng = srv.engine
    vocab = eng.config.vocab_size
    nbytes = weight_bytes(eng)
    log(f'serve_wint8: weights {nbytes} bytes (int8 with f32 scales) '
        f'against {bf16["weight_bytes"]} for bf16 weights (an f32 head), '
        f'ratio {nbytes / bf16["weight_bytes"]:.4f}')
    rng = np.random.RandomState(3)
    out, launches, reqs = _serve_main_path(url, vocab, rng, 'auto',
                                           tag='wint8')
    rates = _serve_repeat_and_rates(url, eng, rng, reqs, out, 'wint8')
    srv.shutdown()
    http_thread.join(timeout=30)
    busy = decode_window(eng)['busy_ms']
    log(f'serve_wint8: decode step at batch 8, device busy {busy} ms '
        f'against {bf16["decode_busy_ms"]} ms with bf16 weights')
    logits = first_step_check(eng, bf16['prompt'], 'serve_wint8')
    ref = bf16['logits']
    gap = (logits - ref).abs().max().item() / ref.abs().max().item()
    agree = np.mean([a == b for x, y in zip(out, bf16['greedy'])
                     for a, b in zip(x, y)])
    log(f'serve_wint8: reading, first decode step logits of the same '
        f'700-token prompt, int8 weights against bf16 weights: max abs diff '
        f'over max |logit| {gap:.5f}, argmax equal '
        f'{int(logits.argmax()) == int(ref.argmax())}; greedy tokens equal '
        f'to the bf16 phase at the same position: {agree:.4f}')
    return dict(launches=launches, weight_bytes=nbytes, decode_busy_ms=busy,
                bf16_gap=gap, **rates)


def first_step_logits(eng, prompts, kernel: str, last=None):
    """Prefill `prompts` into free slots with `kernel` ('fused': the
    kernels, 'plain': their plain versions, 'xla': the reference's read),
    then run the first decode step with it; returns (prefill logits at
    each prompt's last token, first decode step logits), each [n, V] f32,
    and frees the slots.  With `last` ([n, V]) the decode step samples
    its token from those logits instead of the prefill's own."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    saved = eng.prefill_kernel
    eng.prefill_kernel = kernel
    try:
        rids = [eng.submit(p, engine_lib.SamplingConfig(max_new_tokens=4))
                for p in prompts]
        slots = eng._slots  # pylint: disable=protected-access
        while sum(s is not None for s in slots) < len(prompts):
            eng._schedule_front()  # pylint: disable=protected-access
        rows = [next(i for i, s in enumerate(slots)
                     if s is not None and s.request_id == r) for r in rids]
        prefill = eng._last[rows].float().clone()  # pylint: disable=protected-access
        if last is not None:
            eng._last[rows] = last.to(eng._last.dtype)  # pylint: disable=protected-access
        decode = eng.decode_logits(kernel)[rows].float()
    finally:
        eng.prefill_kernel = saved
    for r in rids:
        eng.cancel(r)
    eng.step()
    return prefill, decode


def unshared_first_step_logits(eng, prompts, kernel: str, last=None):
    """`first_step_logits` with every token prefilled by `kernel`: the
    paged engine's prefix registrations are dropped first (no slot may
    be live), and the run must share no page."""
    alloc = eng._alloc  # pylint: disable=protected-access
    if alloc.live_pages:
        raise AssertionError(f'{alloc.live_pages} pages live before an '
                             'unshared prefill')
    alloc.reset()
    hits0 = eng.prefix_hit_pages
    out = first_step_logits(eng, prompts, kernel, last)
    if eng.prefix_hit_pages != hits0:
        raise AssertionError('an unshared prefill shared pages')
    return out


def int8_logit_gaps(eng, prompts) -> list:
    """The int8 serving path's logits through the kernels against the
    plain versions, each prompt prefilled and decoded one step by each:
    [(prefill gap, decode gap)] per prompt, each max |kernels - plain|
    over max |plain| (inf where the kernels' logits are not finite);
    and the kernels' first decode step logits [n, V].  Both decode steps
    take the token the kernels' prefill logits give: where the two
    prefills' greedy tokens differ (their logits are a few percent
    apart), decode steps over different tokens have nothing to agree
    on.  Neither pass shares a page: each prefills every token itself."""
    got = unshared_first_step_logits(eng, prompts, 'fused')
    want = unshared_first_step_logits(eng, prompts, 'plain', last=got[0])
    same = (got[0].argmax(-1) == want[0].argmax(-1)).tolist()
    log(f'int8 logits check: greedy token of the kernels\' prefill equal '
        f'to the plain versions\' for each prompt: {same}')
    gaps = []
    for i in range(len(prompts)):
        pair = []
        for g, w in zip(got, want):
            ok = bool(torch.isfinite(g[i]).all())
            pair.append((g[i] - w[i]).abs().max().item()
                        / w[i].abs().max().item() if ok else float('inf'))
        gaps.append(tuple(pair))
    return gaps, got[1]


# Prompts of the int8 logits check: one chunk, several chunks, the
# longest prompt of the burst (scripts/int8_faults.py reads the same).
INT8_CHECK_LENS = (40, 1300, 3000)


def int8_check_prompts(vocab: int) -> list:
    rng = np.random.RandomState(4)
    return [rng.randint(0, vocab, n).tolist() for n in INT8_CHECK_LENS]


def phase_serve_int8(dev, bf16: dict) -> dict:
    """int8 KV cache, after the bf16 server is freed: the same weights,
    requests and checks as `phase_serve`, only the int8 branches may
    launch; then the logits through the kernels against the plain
    versions (limit INT8_LOGITS_REL_TOL), and readings against the bf16
    phase."""
    gc.collect()
    torch.cuda.empty_cache()
    srv, http_thread, url = _start_server(dev, 'int8')
    eng = srv.engine
    vocab = eng.config.vocab_size
    pool_bytes = eng._cache.nbytes()  # pylint: disable=protected-access
    log(f'serve[int8]: K/V pools {pool_bytes} bytes (int8 with f32 scales) '
        f'against {bf16["pool_bytes"]} bf16, ratio '
        f'{pool_bytes / bf16["pool_bytes"]:.4f}')
    rng = np.random.RandomState(3)
    out, launches, reqs = _serve_main_path(url, vocab, rng, 'int8')
    rates = _serve_repeat_and_rates(url, eng, rng, reqs, out, 'int8')
    srv.shutdown()
    http_thread.join(timeout=30)
    greedy = out[:len(GREEDY_LENS)]
    agree = np.mean([a == b for x, y in zip(greedy, bf16['greedy'])
                     for a, b in zip(x, y)])
    prompts = [bf16['prompt']] + int8_check_prompts(vocab)
    gaps, fused = int8_logit_gaps(eng, prompts)
    lens = [len(p) for p in prompts]
    log(f'serve[int8]: logits through the int8 kernels against the int8 '
        f'plain versions, (prefill, first decode step) gap over max '
        f'|logit| for prompts of {lens} tokens: '
        f'{[(round(a, 5), round(b, 5)) for a, b in gaps]} (limit '
        f'{INT8_LOGITS_REL_TOL})')
    worst = max(max(g) for g in gaps)
    if not worst <= INT8_LOGITS_REL_TOL:
        raise AssertionError('int8 kernel logits disagree with the plain '
                             'path')
    # Readings only: the int8 cache against the bf16 cache.
    int8_logits = fused[0].cpu()
    ref = bf16['logits']
    gap = (int8_logits - ref).abs().max().item() / ref.abs().max().item()
    log(f'serve[int8]: reading, first decode step logits of the same '
        f'700-token prompt, int8 cache against bf16 cache: max abs diff '
        f'over max |logit| {gap:.5f}, argmax equal '
        f'{int(int8_logits.argmax()) == int(ref.argmax())}; greedy tokens '
        f'equal to the bf16 phase at the same position: {agree:.4f} of '
        f'{len(GREEDY_LENS) * SERVE_NEW}')
    return dict(launches=launches, gaps=gaps, pool_bytes=pool_bytes,
                bf16_gap=gap, greedy_agree=float(agree), **rates)


def phase_serve_unpaged(dev) -> dict:
    """The default, unpaged server at f32 and reduced depth: no kernel
    launches; held to the same model served paged with kernel='xla'.
    Returns the launches, the prompts and their greedy completions."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import llama as llama_lib
    gc.collect()
    torch.cuda.empty_cache()
    kw = dict(model='llama3-8b', max_seq_len=4096, prefill_chunk=512,
              model_overrides={'n_layers': UNPAGED_LAYERS,
                               'dtype': 'float32'},
              param_dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    srv = server_lib.InferenceServer(port=0, host='127.0.0.1',
                                     max_batch_size=4,
                                     allow_random_weights=True, **kw)
    eng = srv.engine
    log(f'serve_unpaged: llama3-8b width, {UNPAGED_LAYERS} layers, f32, '
        f'page_size {eng.page_size}, kernels decode={eng.decode_kernel} '
        f'prefill={eng.prefill_kernel}; ready in '
        f'{time.perf_counter() - t0:.1f}s, '
        f'{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated')
    if not (eng.page_size == 0
            and isinstance(eng._cache, llama_lib.SlotCache)  # pylint: disable=protected-access
            and (eng.decode_kernel, eng.prefill_kernel) == ('xla', 'xla')):
        raise AssertionError('the default server is not unpaged')
    srv.start()
    http_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    http_thread.start()
    url = f'http://127.0.0.1:{srv.port}'
    vocab = eng.config.vocab_size
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, vocab, n).tolist() for n in UNPAGED_LENS]
    # The main path: every count set to 0 just before, read just after.
    _reset_launch_counts()
    try:
        out, burst_s = _post_all(url, [dict(
            prompt_ids=[p], max_new_tokens=UNPAGED_NEW, temperature=0.0)
            for p in prompts])
    finally:
        launches = _launch_counts()
        srv.shutdown()
        http_thread.join(timeout=30)
    log(f'serve_unpaged: {len(prompts)} concurrent greedy requests '
        f'({list(UNPAGED_LENS)} prompt tokens, {UNPAGED_NEW} new each) in '
        f'{burst_s:.2f}s; launches {launches}')
    if any(launches.values()):
        raise AssertionError(f'unpaged serving launched a kernel: '
                             f'{launches}')
    unpaged_logits = first_step_logits(eng, prompts, 'xla')[1]
    del srv, eng
    gc.collect()
    torch.cuda.empty_cache()

    paged = engine_lib.ContinuousBatchingEngine(
        n_slots=4, page_size=PS, decode_kernel='xla', prefill_kernel='xla',
        **kw)
    want = paged.generate(prompts, engine_lib.SamplingConfig(
        max_new_tokens=UNPAGED_NEW))
    paged_logits = unshared_first_step_logits(paged, prompts, 'xla')[1]
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    gaps = [((u - p).abs().max() / p.abs().max()).item()
            for u, p in zip(unpaged_logits, paged_logits)]
    same = out == want
    log(f'serve_unpaged: against paged serving with kernel=xla: greedy '
        f'tokens equal {same}; first decode step logits max abs diff over '
        f'max |logit| {[f"{x:.3e}" for x in gaps]} (limit '
        f'{UNPAGED_LOGITS_REL_TOL})')
    if not (same and torch.isfinite(unpaged_logits).all()
            and max(gaps) <= UNPAGED_LOGITS_REL_TOL):
        raise AssertionError('unpaged serving disagrees with paged serving')
    return dict(launches=launches, prompts=prompts, greedy=out)


def phase_serve_static(dev, unpaged: dict) -> dict:
    """--no-continuous: the request-level InferenceEngine behind the
    server, on serve_unpaged's model and weights (llama3-8b width,
    UNPAGED_LAYERS layers, f32, seed 0); serve_unpaged's prompts in one
    /generate batch of 4.  No kernel may launch; the greedy tokens must be
    serve_unpaged's."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import server as server_lib
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    srv = server_lib.InferenceServer(
        model='llama3-8b', port=0, host='127.0.0.1', max_batch_size=4,
        max_seq_len=4096, continuous=False, allow_random_weights=True,
        model_overrides={'n_layers': UNPAGED_LAYERS, 'dtype': 'float32'},
        param_dtype=torch.float32, device=dev)
    if not isinstance(srv.engine, engine_lib.InferenceEngine):
        raise AssertionError('--no-continuous did not build InferenceEngine')
    log(f'serve_static: llama3-8b width, {UNPAGED_LAYERS} layers, f32, '
        f'request-level engine; ready in {time.perf_counter() - t0:.1f}s, '
        f'{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated')
    srv.start()
    http_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    http_thread.start()
    url = f'http://127.0.0.1:{srv.port}'
    # The main path: every count set to 0 just before, read just after.
    _reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = _post(url + '/generate', dict(
            prompt_ids=unpaged['prompts'], max_new_tokens=UNPAGED_NEW,
            temperature=0.0))['tokens']
    finally:
        launches = _launch_counts()
        srv.shutdown()
        http_thread.join(timeout=30)
    same = out == unpaged['greedy']
    log(f'serve_static: one batch of {len(out)} greedy prompts '
        f'({list(UNPAGED_LENS)} tokens, {UNPAGED_NEW} new each) in '
        f'{time.perf_counter() - t0:.2f}s; launches {launches}; tokens equal '
        f'to the unpaged continuous engine\'s: {same}')
    if any(launches.values()):
        raise AssertionError(f'static serving launched a kernel: {launches}')
    if not same:
        raise AssertionError('static serving disagrees with continuous '
                             'serving')
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches)


# Speculative decoding (serve_spec): k = 4 proposals a step, 8 greedy
# requests of SPEC_NEW tokens over templated prompts (each a 48-token
# span repeated with 8-token fillers between, TEMPLATE_REPS times over,
# and cut off halfway into the span once more).  A random target's first
# token is as random as its weights, so n-gram would match nothing at
# the first verify: `echo_prompts` sets the first filler token to the
# first greedy token, so that the suffix the first verify looks up stands
# in the prompt and real proposals reach the card;
# the draft model is Meta's 1B (llama3.2-1b: 16 layers, head_dim 64, the
# same vocabulary).  Mixed batches (serve_mixed): a 64-token budget;
# MIX_DECODE requests decode (two of them end after MIX_SHORT_NEW tokens,
# freeing their slots) while MIX_LONG prompts of MIX_LONG_LEN tokens
# arrive.  The invariants run at serve_unpaged's size (f32, 4 layers),
# kernel 4 reading (it takes f32) and prefill 'xla' (kernel 5 takes no
# f32): the spec and mixed greedy streams must equal the plain stream.
SPEC_K = 4
SPEC_NEW = 32
TEMPLATE_SPAN, TEMPLATE_FILL = 48, 8
TEMPLATE_REPS = (6, 8, 10, 12, 14, 16, 20, 24)
ECHO_ROUNDS = 4
SPEC_DRAFT = 'llama3.2-1b'
MIX_BUDGET = 64
MIX_DECODE, MIX_SHORT_NEW, MIX_LONG_NEW = 8, 8, 96
MIX_LONG, MIX_LONG_LEN = 2, 1000
INV_NEW = 24


def template_prompts(vocab: int, seed: int) -> list:
    """Templated traffic: each prompt a span repeated with fillers, ending
    halfway into the span."""
    rng = np.random.RandomState(seed)
    out = []
    for reps in TEMPLATE_REPS:
        span = rng.randint(0, vocab, TEMPLATE_SPAN).tolist()
        p = []
        for _ in range(reps):
            p += span + rng.randint(0, vocab, TEMPLATE_FILL).tolist()
        out.append(p + span[:TEMPLATE_SPAN // 2])
    return out


def echo_prompts(plain, prompts: list) -> tuple:
    """`prompts` with each one's first filler token set to its first
    greedy token on `plain` (the served weights), again while that changes
    the first token, at most ECHO_ROUNDS times; (prompts, whether each
    one's first token stands in it)."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    one = engine_lib.SamplingConfig(max_new_tokens=1)
    out = [list(p) for p in prompts]
    for rnd in range(ECHO_ROUNDS + 1):
        first = [t[0] for t in plain.generate(out, one)]
        echo = [t in p for t, p in zip(first, out)]
        if all(echo) or rnd == ECHO_ROUNDS:
            return out, echo
        for p, t, e in zip(out, first, echo):
            if not e:
                p[TEMPLATE_SPAN] = t


def _free() -> None:
    """Hand the memory of the objects just dropped back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def _by_s() -> dict:
    from skypilot_tpu_torch.ops import paged_attention as pa
    return {'float': dict(sorted(pa.launches_by_s.items())),
            'int8': dict(sorted(pa.launches_int8_by_s.items()))}


def _live(eng, prompts, new: int) -> list:
    """Submit `prompts` and drive the engine until each is live (admission
    and prefill ticks; whole steps where prompts ride decode steps);
    returns the request ids."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    rids = [eng.submit(p, engine_lib.SamplingConfig(max_new_tokens=new))
            for p in prompts]
    tick = eng.step if eng.prefill_mix_budget else eng._schedule_front  # pylint: disable=protected-access
    for _ in range(10_000):
        if sum(s is not None for s in eng._slots) == len(prompts):  # pylint: disable=protected-access
            return rids
        tick()
    raise AssertionError('requests did not go live together')


def _drop(eng, rids) -> None:
    for r in rids:
        eng.cancel(r)
    eng.step()
    if not eng.is_idle() or eng.allocator_leak_report() is not None:
        raise AssertionError(f'pages leaked: {eng.allocator_leak_report()}')


def _logit_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (inf where got is not finite)."""
    if not bool(torch.isfinite(got).all()):
        return float('inf')
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def verify_check(eng, prompts, limit: float, tag: str) -> float:
    """The first verify forward of `prompts` (logits at all k + 1
    positions) through the kernels and through their plain versions over
    the same cache; the worst row's gap must be within `limit`.  An
    n-gram engine must propose at least one token there."""
    from skypilot_tpu_torch.infer import speculative as spec_lib
    rids = _live(eng, prompts, SPEC_NEW)
    rows = [i for i, s in enumerate(eng._slots) if s is not None]  # pylint: disable=protected-access
    props = [len(spec_lib.ngram_propose(
        eng._slots[i].prompt_ids + eng._slots[i].outputs, SPEC_K))  # pylint: disable=protected-access
        for i in rows]
    if not sum(props):
        raise AssertionError(f'{tag}: the first verify proposes nothing')
    fused = eng.verify_logits('fused')
    plain = eng.verify_logits('plain')
    gaps = [_logit_gap(fused[i], plain[i]) for i in rows]
    gap = max(gaps)
    log(f'{tag}: first verify forward (S {SPEC_K + 1}, {len(rows)} rows, '
        f'n-gram proposals by row {props}), kernels vs plain: max abs diff over max |logit| {gap:.5f} (limit '
        f'{limit}); by row {[round(g, 5) for g in gaps]}')
    _drop(eng, rids)
    if not gap <= limit:
        raise AssertionError(f'{tag}: verify logits disagree with the plain '
                             'path')
    return gap


def mixed_check(eng, vocab: int, limit: float, tag: str) -> float:
    """One mixed step with 6 live decode rows and a prompt whose last
    chunk rides it: the decode rows' logits and the prompt row's at its
    last token, through the kernels and through their plain versions;
    within `limit`."""
    rng = np.random.RandomState(12)
    # Enough new tokens that the first row still decodes when the last of
    # the six (4340 prompt tokens, 64 a step) goes live.
    rids = _live(eng, [rng.randint(0, vocab, n).tolist()
                       for n in (40, 100, 300, 700, 1200, 2000)], 256)
    rids.append(eng.submit(rng.randint(0, vocab, 4 * MIX_BUDGET + 37)
                           .tolist()))
    # Each step joined at once, so that the pending's cursor counts the
    # chunk of the step in flight.
    eng.step()
    eng._fence()  # pylint: disable=protected-access
    pend = eng._prefills[0]  # pylint: disable=protected-access
    while pend.true_len - pend.done > MIX_BUDGET:
        eng.step()
        eng._fence()  # pylint: disable=protected-access
    fused, rows = eng.mixed_logits('fused')
    plain, _ = eng.mixed_logits('plain')
    gaps = [_logit_gap(fused[i], plain[i]) for i in rows]
    gap = max(gaps)
    log(f'{tag}: one mixed step (S {MIX_BUDGET}, {len(rows) - 1} decode '
        f'rows, the prompt row at its last token), kernels vs plain: max '
        f'abs diff over max |logit| {gap:.5f} (limit {limit}); by row '
        f'{[round(g, 5) for g in gaps]} (the prompt row last)')
    _drop(eng, rids)
    if not gap <= limit:
        raise AssertionError(f'{tag}: mixed-step logits disagree with the '
                             'plain path')
    return gap


def _margin_at(eng, prompt) -> float:
    """Top-1 minus top-2 logit of the plain engine after `prompt`."""
    rids = _live(eng, [prompt], 2)
    row = next(i for i, s in enumerate(eng._slots) if s is not None)  # pylint: disable=protected-access
    top = torch.topk(eng._last[row], 2).values  # pylint: disable=protected-access
    _drop(eng, rids)
    return (top[0] - top[1]).item()


def _same_streams(tag: str, got, want, plain_eng, prompts) -> None:
    """Greedy streams equal token for token; where not, print the first
    position that differs and the plain engine's top-2 margin there."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            t = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
            margin = _margin_at(plain_eng, prompts[i] + w[:t])
            log(f'{tag}: request {i} differs at token {t} ({g[t]} vs '
                f'{w[t]}); top-2 logit margin there {margin:.4e}')
            raise AssertionError(f'{tag}: greedy stream differs from plain')
    log(f'{tag}: greedy streams equal to plain decode, '
        f'{sum(len(w) for w in want)} tokens')


def phase_invariants(dev) -> None:
    """The reference's invariants on the card, at f32 and 4 layers."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    _free()
    kw = dict(model='llama3-8b', max_seq_len=4096, prefill_chunk=512,
              n_slots=4, page_size=PS,
              model_overrides={'n_layers': UNPAGED_LAYERS, 'dtype': 'float32'},
              param_dtype=torch.float32, decode_kernel='fused',
              prefill_kernel='xla', device=dev)
    rng = np.random.RandomState(13)
    prompts = [rng.randint(0, 128256, n).tolist() for n in UNPAGED_LENS]
    cfg = engine_lib.SamplingConfig(max_new_tokens=INV_NEW)
    plain = engine_lib.ContinuousBatchingEngine(**kw)
    want = plain.generate(prompts, cfg)
    for tag, extra in (
            ('spec (draft: the target\'s config and seed)', dict(
                spec_k=SPEC_K, draft_model='llama3-8b',
                draft_overrides=kw['model_overrides'])),
            ('mixed', dict(prefill_mix_budget=MIX_BUDGET))):
        eng = engine_lib.ContinuousBatchingEngine(**kw, **extra)
        _reset_launch_counts()
        got = eng.generate(prompts, cfg)
        info = eng.speculation_info()
        log(f'invariants, f32, {UNPAGED_LAYERS} layers, {tag}: kernel 4 '
            f'launches by S {_by_s()}, speculation {info}')
        _same_streams(f'invariants {tag}', got, want, plain, prompts)
        if info is not None and info['accepted_tokens'] <= 0:
            raise AssertionError('invariants: the draft accepted nothing')
        del eng
        _free()
    del plain
    _free()


def phase_serve_spec(dev) -> dict:
    """Speculative decoding through the server: n-gram, then a llama3.2-1b
    draft; readings, the verify forward's kernels vs plain (bf16 and int8
    caches), and the token agreement with plain bf16 decode."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    _free()
    vocab = 128256
    cfg = engine_lib.SamplingConfig(max_new_tokens=SPEC_NEW)
    plain = engine_lib.ContinuousBatchingEngine(
        model='llama3-8b', max_seq_len=4096, prefill_chunk=512, n_slots=8,
        page_size=PS, device=dev)
    prompts, echo = echo_prompts(plain, template_prompts(vocab, 14))
    log(f'serve_spec: prompts whose first greedy token stands in them: '
        f'{sum(echo)} of {len(echo)}')
    if not any(echo):
        raise AssertionError('serve_spec: no prompt echoes its first token')
    check = [p for p, e in zip(prompts, echo) if e][:4]
    want = plain.generate(prompts, cfg)
    del plain
    _free()
    launches, by_s, accepted = {}, {}, 0
    modes = [('ngram', {}), ('draft', dict(draft_model=SPEC_DRAFT))]
    while modes:
        mode, extra = modes.pop(0)
        srv, http_thread, url = _start_server(dev, 'auto', spec_k=SPEC_K,
                                              **extra)
        eng = srv.engine
        with urllib.request.urlopen(url + '/health?verbose=1',
                                    timeout=60) as r:
            health = json.loads(r.read())
        if health['speculation']['mode'] != mode.split('_')[0]:
            raise AssertionError(f'/health speculation: {health}')
        _reset_launch_counts()
        out, burst_s = _post_all(url, [dict(prompt_ids=[p],
                                            max_new_tokens=SPEC_NEW)
                                       for p in prompts])
        launches[mode] = _launch_counts()
        by_s[mode] = _by_s()
        srv.shutdown()
        http_thread.join(timeout=30)
        info = eng.speculation_info()
        accepted += info['accepted_tokens']
        # Each (row, verify) commits its accepted tokens and one more.
        per_row = info['committed_tokens'] / max(
            1, info['committed_tokens'] - info['accepted_tokens'])
        agree = sum(a == b for x, y in zip(out, want) for a, b in zip(x, y))
        log(f'serve_spec[{mode}]: {len(prompts)} greedy requests '
            f'({[len(p) for p in prompts]} prompt tokens, {SPEC_NEW} new '
            f'each) in {burst_s:.2f}s; verify steps {info["steps"]}, '
            f'proposed {info["proposed_tokens"]}, accepted '
            f'{info["accepted_tokens"]} (rate {info["acceptance_rate"]}), '
            f'committed {info["committed_tokens"]} '
            f'({info["committed_tokens"] / max(1, info["steps"]):.3f} a '
            f'verify step over the batch, {per_row:.3f} a row); kernel 4 '
            f'launches by S {by_s[mode]}; launches '
            f'{launches[mode]}; greedy tokens equal to plain bf16 decode at '
            f'the same position {agree} of {len(prompts) * SPEC_NEW}')
        for toks in out:
            if len(toks) != SPEC_NEW or not all(0 <= t < vocab for t in toks):
                raise AssertionError(f'bad completion: {toks}')
        if not (by_s[mode]['float'].get(SPEC_K + 1, 0) > 0
                and launches[mode]['ragged_prefill'] > 0
                and info['proposed_tokens'] > 0):
            raise AssertionError(f'serve_spec[{mode}]: kernel 4 at S '
                                 f'{SPEC_K + 1} or kernel 5 did not launch, '
                                 'or nothing was proposed')
        if mode == 'ngram':
            verify_check(eng, check, LOGITS_REL_TOL, 'serve_spec')
        del srv, eng
        _free()
        if mode == 'draft' and accepted == 0:
            # Random weights: the n-gram proposals and the random 1B draft
            # found nothing the random target agrees with.  A draft of the
            # target's config and seed (the reference tests' own device)
            # makes multi-token commits run on the card.
            modes.append(('draft_same', dict(draft_model='llama3-8b')))
    if accepted <= 0:
        raise AssertionError('serve_spec: neither mode accepted a token')
    # The int8 cache's quant branch at S = k + 1.
    eng = engine_lib.ContinuousBatchingEngine(
        model='llama3-8b', max_seq_len=4096, prefill_chunk=512, n_slots=8,
        page_size=PS, kv_cache_dtype='int8', spec_k=SPEC_K, device=dev)
    _reset_launch_counts()
    verify_check(eng, check, INT8_LOGITS_REL_TOL, 'serve_spec[int8]')
    by_s['int8_check'] = _by_s()
    if by_s['int8_check']['int8'].get(SPEC_K + 1, 0) <= 0:
        raise AssertionError('serve_spec[int8]: the quant branch did not '
                             f'launch at S {SPEC_K + 1}')
    del eng
    _free()
    total = {k: sum(c[k] for c in launches.values())
             for k in launches['ngram']}
    log(f'serve_spec: launches by mode {launches}')
    return dict(launches=total, by_s=by_s)


def _post_mixed(url: str, eng, vocab: int) -> tuple:
    """MIX_DECODE requests decoding (the last two end after MIX_SHORT_NEW
    tokens), then MIX_LONG long prompts posted once every decode row is
    live; (completions, seconds)."""
    rng = np.random.RandomState(15)
    lens = np.linspace(64, 400, MIX_DECODE).astype(int)
    prompts = [rng.randint(0, vocab, n).tolist() for n in lens]
    calls = [dict(prompt_ids=prompts[:-2], max_new_tokens=MIX_LONG_NEW),
             dict(prompt_ids=prompts[-2:], max_new_tokens=MIX_SHORT_NEW),
             dict(prompt_ids=[rng.randint(0, vocab, MIX_LONG_LEN).tolist()
                              for _ in range(MIX_LONG)],
                  max_new_tokens=16)]
    out = [None] * len(calls)
    errors = []

    def one(i):
        try:
            out[i] = _post(url + '/generate', calls[i])['tokens']
        except Exception as e:  # pylint: disable=broad-except
            errors.append(repr(e))

    def until(what: str, cond) -> None:
        deadline = time.monotonic() + 300
        while not cond():
            if time.monotonic() > deadline or errors:
                raise AssertionError(f'serve_mixed: {what}: {errors}')
            time.sleep(0.002)

    t0 = time.perf_counter()
    rid0 = eng._next_rid  # pylint: disable=protected-access
    threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
    # In this order: the long-running decoders are admitted first, the
    # short ones after them, and the long prompts once all are live.
    threads[0].start()
    until('submission', lambda: eng._next_rid >= rid0 + MIX_DECODE - 2)  # pylint: disable=protected-access
    threads[1].start()
    until('decode rows live', lambda: sum(
        s is not None for s in eng._slots) == MIX_DECODE)  # pylint: disable=protected-access
    threads[2].start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f'requests failed: {errors}')
    return [c for call in out for c in call], time.perf_counter() - t0


def inter_token_ms(eng, vocab: int) -> list:
    """Wall ms of each step (one token for every decode row) while two
    MIX_LONG_LEN-token prompts prefill beside 6 live decode rows, the
    device synchronized after each step."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    rng = np.random.RandomState(16)
    rids = _live(eng, [rng.randint(0, vocab, 128).tolist()
                       for _ in range(6)], 200)
    for _ in range(3):
        eng.step()
    rids += [eng.submit(rng.randint(0, vocab, MIX_LONG_LEN).tolist(),
                        engine_lib.SamplingConfig(max_new_tokens=4))
             for _ in range(MIX_LONG)]
    steps = []
    torch.cuda.synchronize()
    while True:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        if not eng._prefills and len(steps) > 1:  # pylint: disable=protected-access
            break
    _drop(eng, rids)
    return steps


def phase_serve_mixed(dev) -> dict:
    """Mixed prefill/decode batches through the server (budget 64): the
    long prompts prefill inside decode steps, kernel 4 at S 64, kernel 5
    never; the decode rows' inter-token ms during that prefill against
    dedicated ticks (readings); one mixed step's kernels vs plain (bf16
    and int8 caches)."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    _free()
    vocab = 128256
    srv, http_thread, url = _start_server(dev, 'auto',
                                          prefill_mix_budget=MIX_BUDGET)
    eng = srv.engine
    _reset_launch_counts()
    out, secs = _post_mixed(url, eng, vocab)
    launches = _launch_counts()
    by_s = {'served': _by_s()}
    srv.shutdown()
    http_thread.join(timeout=30)
    log(f'serve_mixed: {MIX_DECODE} decoding requests, then {MIX_LONG} '
        f'prompts of {MIX_LONG_LEN} tokens, in {secs:.2f}s; kernel 4 '
        f'launches by S {by_s["served"]}; kernel 5 launches '
        f'{launches["ragged_prefill"]}'
        f' (the mixed prefill runs none); launches {launches}')
    if any(o is None or not o for o in out):
        raise AssertionError(f'serve_mixed: bad completions {out}')
    if not (by_s['served']['float'].get(MIX_BUDGET, 0) > 0
            and launches['ragged_prefill'] == 0):
        raise AssertionError('serve_mixed: kernel 4 did not launch at S '
                             f'{MIX_BUDGET}, or kernel 5 launched')
    mixed_ms = inter_token_ms(eng, vocab)
    mixed_check(eng, vocab, LOGITS_REL_TOL, 'serve_mixed')
    del srv, eng
    _free()
    ded = engine_lib.ContinuousBatchingEngine(
        model='llama3-8b', max_seq_len=4096, prefill_chunk=512, n_slots=8,
        page_size=PS, device=dev)
    ded_ms = inter_token_ms(ded, vocab)
    del ded
    _free()
    log(f'serve_mixed: reading, the decode rows\' inter-token ms while '
        f'{MIX_LONG} prompts of {MIX_LONG_LEN} tokens prefill beside 6 '
        f'decode rows: mixed (budget {MIX_BUDGET}) {len(mixed_ms)} steps, '
        f'mean {np.mean(mixed_ms):.2f} max {max(mixed_ms):.2f}; dedicated '
        f'ticks (512-token chunks) {len(ded_ms)} steps, mean '
        f'{np.mean(ded_ms):.2f} max {max(ded_ms):.2f}; steps '
        f'{[round(x, 2) for x in mixed_ms]} / {[round(x, 2) for x in ded_ms]}')
    eng = engine_lib.ContinuousBatchingEngine(
        model='llama3-8b', max_seq_len=4096, prefill_chunk=512, n_slots=8,
        page_size=PS, kv_cache_dtype='int8', prefill_mix_budget=MIX_BUDGET,
        device=dev)
    _reset_launch_counts()
    mixed_check(eng, vocab, INT8_LOGITS_REL_TOL, 'serve_mixed[int8]')
    by_s['int8_check'] = _by_s()
    if by_s['int8_check']['int8'].get(MIX_BUDGET, 0) <= 0:
        raise AssertionError('serve_mixed[int8]: the quant branch did not '
                             f'launch at S {MIX_BUDGET}')
    del eng
    _free()
    return dict(launches=launches, by_s=by_s, mixed_ms=mixed_ms,
                dedicated_ms=ded_ms)


# serve_async: 8 greedy requests, served by the default (pipelined, decode
# graphs) server and by --no-async-pipeline on the same weights.
ASYNC_LENS = (40, 100, 200, 350, 500, 700, 900, 1200)
# Replayed decode logits against the eager forward's: the same kernels in
# the same order on the same inputs (observed bit for bit on an NVIDIA
# H100, bf16 and int8 caches).
GRAPH_LOGITS_GAP = 0.0
# Steps of a decode window of serve_async.
ASYNC_WINDOW_STEPS = 8
# serve_async's HTTP decode rate: 129- minus 1-token runs.  With decode
# graphs a step takes some 12 ms, and the decode loop's 50 ms idle poll
# can land in either run: 128 steps keep it under 5% of the difference.
ASYNC_RATE_NEW = 129


def graph_check(eng, vocab: int, tag: str) -> float:
    """The next decode step of 8 live requests (64-4000 tokens: reads of
    512 to 4096 positions) replayed from its CUDA graph against the eager
    forward, kernels both: max |diff| over max |logit| within
    GRAPH_LOGITS_GAP."""
    rng = np.random.RandomState(22)
    rids = _live(eng, [rng.randint(0, vocab, n).tolist()
                       for n in (64, 300, 700, 1200, 1800, 2500, 3200,
                                 4000 - SERVE_NEW)], SERVE_NEW)
    rows = [i for i, s in enumerate(eng._slots) if s is not None]  # pylint: disable=protected-access
    eager = eng.decode_logits('fused')[rows]
    replay = eng.decode_logits('fused', graph=True)[rows]
    gap = _logit_gap(replay, eager)
    log(f'{tag}: a decode step of {len(rows)} rows replayed from its CUDA '
        f'graph against the eager forward: max abs diff over max |logit| '
        f'{gap} (limit {GRAPH_LOGITS_GAP}); graphs {eng.graph_info()}')
    _drop(eng, rids)
    if not gap <= GRAPH_LOGITS_GAP:
        raise AssertionError(f'{tag}: replayed logits differ from eager')
    return gap


def phase_serve_async(dev, card: str) -> dict:
    """The decode pipeline at llama3-8b width, bf16 and int8 caches: the
    default server (pipelined, the S = 1 decode forward replayed from CUDA
    graphs) against --no-async-pipeline on the same weights, 8 greedy
    requests each, the tokens equal; every kernel-4 launch counted over
    the four bursts (each count set to 0 just before a burst and read
    just after; replays count the launches captured in their graphs);
    HTTP decode tokens/s of both (ASYNC_RATE_NEW); on the pipelined
    engine the graphs captured, their capture seconds and pool bytes, the
    replay against the eager forward (`graph_check`), and a decode step
    at batch 8 in each of DECODE_MODES (wall ms, profiler off), and with
    graphs under the profiler (device busy ms, idle share, kernels and
    host launch calls a step)."""
    launches: dict = {}
    by_s = {'float': {}, 'int8': {}}
    out = {}
    for kv_cache_dtype in ('auto', 'int8'):
        streams, rates = {}, {}
        for pipelined in (False, True):
            tag = (f'serve_async[{kv_cache_dtype}, '
                   f'{"async" if pipelined else "sync"}]')
            t_server = time.perf_counter()
            srv, http_thread, url = _start_server(
                dev, kv_cache_dtype, async_pipeline=pipelined)
            eng = srv.engine
            vocab = eng.config.vocab_size
            rng = np.random.RandomState(21)
            reqs = [dict(prompt_ids=[rng.randint(0, vocab, n).tolist()],
                         max_new_tokens=SERVE_NEW, temperature=0.0)
                    for n in ASYNC_LENS]
            _reset_launch_counts()
            streams[pipelined], burst_s = _post_all(url, reqs)
            counts, runs = _launch_counts(), _by_s()
            _check_branches(counts, kv_cache_dtype, tag)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            for branch, c in runs.items():
                for q, n in c.items():
                    by_s[branch][q] = by_s[branch].get(q, 0) + n
            rates[pipelined] = _decode_rate(url, eng, rng, tag,
                                            ASYNC_RATE_NEW)
            pipe = eng.pipeline_info()
            srv.shutdown()
            http_thread.join(timeout=30)
            log(f'{tag}: {len(reqs)} greedy requests in {burst_s:.2f}s; '
                f'launches {counts}, by S {runs}; HTTP decode '
                f'{rates[pipelined]:.1f} tokens/s at batch 8 '
                f'({ASYNC_RATE_NEW}- minus 1-token runs); pipeline '
                f'{pipe}; graphs {eng.graph_info()}; '
                f'{time.perf_counter() - t_server:.1f}s since the server '
                'was started')
            if pipelined != (pipe['mode'] == 'async'):
                raise AssertionError(f'{tag}: pipeline {pipe}')
            if pipelined:
                graphs = eng._graphs  # pylint: disable=protected-access
                if not (pipe['steps_overlapped'] > 0 and graphs.replays > 0):
                    raise AssertionError(f'{tag}: no step overlapped or no '
                                         'graph replayed')
                out[kv_cache_dtype] = dict(
                    graphs=eng.graph_info(),
                    graph_gap=graph_check(eng, vocab, tag), modes={})
                modes = out[kv_cache_dtype]['modes']
                for mode in DECODE_MODES:
                    set_decode_mode(eng, mode, graphs)
                    modes[mode] = decode_window(eng, ASYNC_WINDOW_STEPS,
                                                profile=False)
                m = decode_window(eng, ASYNC_WINDOW_STEPS)
                log(f'{tag}: decode step at batch 8 ({card}), wall ms, '
                    f'profiler off: ' + ', '.join(
                        f'{mode} {modes[mode]["wall_ms"]:.3f}'
                        for mode in DECODE_MODES) + '; async_graphs with '
                    f'the profiler on: wall {m["wall_ms"]:.3f} ms, device '
                    f'busy {m["busy_ms"]} ms, idle share {m["idle"]}, '
                    f'{m["kernels"]} kernels and {m["host_launches"]} host '
                    f'launch calls a step (scripts/port_profile.py profiles '
                    f'all three)')
                modes['async_graphs_profiled'] = m
                del graphs
            del srv, eng
            _free()
        if streams[True] != streams[False]:
            raise AssertionError(f'serve_async[{kv_cache_dtype}]: pipelined '
                                 'tokens differ from the synchronous loop')
        log(f'serve_async[{kv_cache_dtype}]: pipelined greedy tokens equal '
            f'to --no-async-pipeline\'s ({len(ASYNC_LENS) * SERVE_NEW} '
            f'tokens); HTTP decode tokens/s at batch 8, sync '
            f'{rates[False]:.1f}, async {rates[True]:.1f}')
        out[kv_cache_dtype]['decode_tps'] = rates
    return dict(launches=launches, by_s=by_s, **out)


def _launch_counts() -> dict:
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.ops import ragged_prefill as rp
    return {'paged_decode': pa.launches, 'ragged_prefill': rp.launches,
            'paged_decode_int8': pa.launches_int8,
            'ragged_prefill_int8': rp.launches_int8,
            'flash_fwd': fa.fwd_launches, 'flash_bwd_dq': fa.dq_launches,
            'flash_bwd_dkv': fa.dkv_launches}


def _reset_launch_counts() -> None:
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.ops import ragged_prefill as rp
    pa.launches = rp.launches = 0
    pa.launches_int8 = rp.launches_int8 = 0
    pa.launches_by_s, pa.launches_int8_by_s = {}, {}
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0


def train_gaps(dev):
    """One training step's loss and global grad norm with the kernels and
    with their plain versions, same weights and batch, on each of two
    batches.  Returns the trainer, the last batch and the relative gaps
    [(loss gap, grad-norm gap)] (inf where a value is not finite)."""
    from skypilot_tpu_torch.train import data as data_lib
    from skypilot_tpu_torch.train import trainer as trainer_lib
    config = trainer_lib.TrainConfig(
        model='llama3-8b', global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        warmup_steps=2, total_steps=20,
        model_overrides={'n_layers': TRAIN_LAYERS, 'max_seq_len': TRAIN_SEQ})
    tr = trainer_lib.Trainer(config, device=dev)
    tr.init_state()
    stream = data_lib.synthetic_data(TRAIN_BATCH, TRAIN_SEQ,
                                     tr.model_config.vocab_size, seed=1,
                                     device=dev)
    gaps = []
    for _ in range(2):
        batch = next(stream)
        got = {}
        for kernel in ('fused', 'xla'):
            m = trainer_lib.compute_grads(tr.model, batch, kernel=kernel)
            gn = trainer_lib.global_norm({k: p.grad for k, p in
                                          tr.model.named_parameters()})
            got[kernel] = (float(m['loss']), float(gn))
        tr.model.zero_grad(set_to_none=True)
        (lk, gk), (lp, gp) = got['fused'], got['xla']
        gap = (abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp))
        if not np.isfinite([lk, gk, *gap]).all():
            gap = (float('inf'), float('inf'))
        gaps.append(gap)
        log(f'train: one step, kernels vs plain versions: loss {lk:.6f} vs '
            f'{lp:.6f} (rel gap {gap[0]:.3e}, limit {TRAIN_LOSS_REL_TOL}); '
            f'grad norm {gk:.6f} vs {gp:.6f} (rel gap {gap[1]:.3e}, limit '
            f'{TRAIN_GNORM_REL_TOL})')
    return tr, batch, gaps


def phase_train(dev) -> dict:
    from skypilot_tpu_torch.train import __main__ as train_main
    gc.collect()
    torch.cuda.empty_cache()
    log(f'train: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still '
        'allocated before the train phase')
    torch.cuda.reset_peak_memory_stats()
    overrides = {'n_layers': TRAIN_LAYERS}
    argv = ['--model', 'llama3-8b', '--model-overrides',
            json.dumps(overrides), '--global-batch-size', str(TRAIN_BATCH),
            '--seq-len', str(TRAIN_SEQ), '--steps', str(TRAIN_STEPS),
            '--log-every', '1', '--json-metrics']
    # The main path: every count set to 0 just before, read just after.
    _reset_launch_counts()
    t0 = time.perf_counter()
    metrics = train_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    peak = metrics['peak_memory_bytes'] / 2**30
    L, n = TRAIN_LAYERS, TRAIN_STEPS
    want = {'paged_decode': 0, 'ragged_prefill': 0, 'paged_decode_int8': 0,
            'ragged_prefill_int8': 0, 'flash_fwd': 2 * L * n,
            'flash_bwd_dq': L * n, 'flash_bwd_dkv': L * n}
    log(f'train: llama3-8b widths, {L} layers, batch {TRAIN_BATCH} x seq '
        f'{TRAIN_SEQ}, {n} steps in {wall:.1f}s (model init included); '
        f'launches {launches}, expected {want}')
    if launches != want:
        raise AssertionError(f'train launches {launches} != {want}')
    hist = metrics['history']
    if len(hist) != n or not all(
            np.isfinite(r['loss']) and np.isfinite(r['grad_norm'])
            for r in hist):
        raise AssertionError(f'train: missing or non-finite steps: {hist}')
    for r in hist:
        log(f'train step {r["step"]}: loss {r["loss"]:.4f} grad_norm '
            f'{r["grad_norm"]:.4f} step {r["step_ms"]:.1f} ms '
            f'{r["tokens_per_sec"]:.1f} tokens/s')
    steady = hist[1:]
    step_ms = sum(r['step_ms'] for r in steady) / len(steady)
    tps = TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3
    log(f'train: steps 2-{n}: {step_ms:.1f} ms/step, {tps:.1f} tokens/s; '
        f'peak memory allocated {peak:.2f} GiB')
    del metrics
    gc.collect()
    torch.cuda.empty_cache()

    tr, batch, gaps = train_gaps(dev)
    for loss_gap, norm_gap in gaps:
        if not (loss_gap <= TRAIN_LOSS_REL_TOL
                and norm_gap <= TRAIN_GNORM_REL_TOL):
            raise AssertionError('train: kernels disagree with the plain '
                                 'versions')

    # Memorization: one repeated batch, the loss must fall.
    losses = [float(tr.step(batch)['loss']) for _ in range(MEMORIZE_STEPS)]
    log(f'train: {MEMORIZE_STEPS} steps on one repeated batch: losses '
        f'{[round(x, 4) for x in losses]}')
    if not (np.isfinite(losses).all()
            and losses[-1] < losses[0] - MEMORIZE_DROP):
        raise AssertionError(f'train: loss did not fall by more than '
                             f'{MEMORIZE_DROP} on a repeated batch')
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# finetune and checkpoint: LoRA finetuning, the port's checkpoints, serving
# a trained checkpoint
# ---------------------------------------------------------------------------
# The LoRA recipe (the reference's examples/llm/llama3_finetune_lora.yaml):
# llama3-8b at full width and all 32 layers, rank-16 adapters on q/k/v/o,
# only the adapters trained, remat_policy='save_attn', the chunked loss,
# seq 8192.  The global batch is cut from the recipe's 16 to 2 (two
# microbatches of 1 x 8192) to fit the smoke's time.
FT_OVERRIDES = {'lora_rank': 16, 'lora_alpha': 16,
                'remat_policy': 'save_attn'}
FT_BATCH, FT_ACCUM, FT_SEQ, FT_STEPS, FT_CHUNK = 2, 2, 8192, 3, 1024
# The kernels-vs-plain step of the finetune: the finetuned weights of its
# first FT_CHECK_LAYERS layers (embedding, head and adapters included),
# one microbatch of 1 x 8192.  The plain flash versions hold [1, 32, 8192,
# 8192] f32 scores, 8.6 GB each, several at once: with the 32-layer f32
# base (32 GB) beside them they would not fit the card.
FT_CHECK_LAYERS = 2
# The checkpoint phase: llama3-8b width cut to CK_LAYERS layers (about
# 6 GB of f32 params a checkpoint), LoRA as the finetune, batch 2 x
# CK_SEQ; serving the trained checkpoint as serve_async's default server.
CK_LAYERS, CK_SEQ, CK_STEPS = 2, 2048, 4
CK_LENS = (40, 300, 900, 1500)
CK_NEW = 16


def _lora_train_config(n_layers=None, model='llama3-8b', **kw):
    from skypilot_tpu_torch.train import trainer as trainer_lib
    overrides = dict(FT_OVERRIDES, max_seq_len=kw['seq_len'])
    if n_layers is not None:
        overrides['n_layers'] = n_layers
    return trainer_lib.TrainConfig(
        model=model, train_only='lora', loss_chunk=FT_CHUNK,
        warmup_steps=2, total_steps=20, model_overrides=overrides, **kw)


def _adapter_grad_norm(model) -> float:
    return float(torch.sqrt(sum(p.grad.float().square().sum()
                                for p in model.parameters()
                                if p.requires_grad)))


def finetune_gaps(dev, model, name='llama3-8b',
                  tag='finetune') -> tuple:
    """One step's loss and adapter grad norm with the kernels and with
    their plain versions, on the finetuned weights of the first
    FT_CHECK_LAYERS layers of `model` (config `name`) and one 1 x FT_SEQ
    microbatch.  Returns (loss gap, grad-norm gap), relative (inf where
    not finite)."""
    from skypilot_tpu_torch.train import data as data_lib
    from skypilot_tpu_torch.train import trainer as trainer_lib
    tr = trainer_lib.Trainer(_lora_train_config(
        FT_CHECK_LAYERS, name, global_batch_size=1, seq_len=FT_SEQ),
        device=dev)
    tr.init_state()
    keep = set(tr.model.state_dict())
    with torch.no_grad():
        tr.model.load_state_dict({k: v for k, v in model.state_dict().items()
                                  if k in keep})
    batch = next(data_lib.synthetic_data(1, FT_SEQ,
                                         tr.model_config.vocab_size, seed=2,
                                         device=dev))
    got = {}
    for kernel in ('fused', 'xla'):
        m = trainer_lib.compute_grads(tr.model, batch, kernel=kernel,
                                      loss_chunk=FT_CHUNK)
        got[kernel] = (float(m['loss']), _adapter_grad_norm(tr.model))
        tr.model.zero_grad(set_to_none=True)
    (lk, gk), (lp, gp) = got['fused'], got['xla']
    gap = (abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp))
    if not np.isfinite([lk, gk, *gap]).all():
        gap = (float('inf'), float('inf'))
    log(f'{tag}: one step at {FT_CHECK_LAYERS} layers (the finetuned '
        f'weights), 1 x {FT_SEQ}, kernels vs plain versions: loss {lk:.6f} '
        f'vs {lp:.6f} (rel gap {gap[0]:.3e}, limit {TRAIN_LOSS_REL_TOL}); '
        f'adapter grad norm {gk:.6f} vs {gp:.6f} (rel gap {gap[1]:.3e}, '
        f'limit {TRAIN_GNORM_REL_TOL})')
    del tr
    return gap


def phase_finetune(dev, card: str, model: str = 'llama3-8b',
                   tag: str = 'finetune') -> dict:
    """The LoRA recipe at `model`'s full depth through
    `train/__main__.main`:
    launches (every count set to 0 just before, read just after; kernel
    1 once a layer and microbatch under save_attn), the base bit for bit
    unchanged, every adapter b trained off zero, finite losses and grad
    norms, peak memory, step ms and tokens/s; then kernels vs plain
    (`finetune_gaps`)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import __main__ as train_main
    from skypilot_tpu_torch.train import trainer as trainer_lib
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ['--model', model, '--model-overrides',
            json.dumps(FT_OVERRIDES), '--train-only', 'lora', '--loss-chunk',
            str(FT_CHUNK), '--global-batch-size', str(FT_BATCH),
            '--grad-accum-steps', str(FT_ACCUM), '--seq-len', str(FT_SEQ),
            '--steps', str(FT_STEPS), '--log-every', '1', '--json-metrics']
    # The trainer that main builds, and a host copy of its frozen base
    # taken right after init (before the first step).
    seen = {}
    init_state = trainer_lib.Trainer.init_state

    def spy(self, *args, **kwargs):
        init_state(self, *args, **kwargs)
        seen['trainer'] = self
        seen['base'] = {n: p.detach().to('cpu') for n, p in
                        self.model.named_parameters() if not p.requires_grad}

    trainer_lib.Trainer.init_state = spy
    try:
        _reset_launch_counts()
        t0 = time.perf_counter()
        metrics = train_main.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
    finally:
        trainer_lib.Trainer.init_state = init_state
    tr = seen['trainer']
    L, n = tr.model_config.n_layers, FT_STEPS
    want = {'paged_decode': 0, 'ragged_prefill': 0, 'paged_decode_int8': 0,
            'ragged_prefill_int8': 0, 'flash_fwd': L * n * FT_ACCUM,
            'flash_bwd_dq': L * n * FT_ACCUM,
            'flash_bwd_dkv': L * n * FT_ACCUM}
    params = dict(tr.model.named_parameters())
    adapters = {k: p for k, p in params.items() if p.requires_grad}
    n_adapter = sum(p.numel() for p in adapters.values())
    base_bytes = sum(t.nbytes for t in seen['base'].values())
    peak = metrics['peak_memory_bytes']
    log(f'{tag}: {model}, {L} layers, LoRA rank '
        f'{tr.model_config.lora_rank} alpha {tr.model_config.lora_alpha} on '
        f'{tr.model_config.lora_targets}, train_only=lora, remat_policy='
        f"{tr.model_config.remat_policy}, loss_chunk {FT_CHUNK}, batch "
        f'{FT_BATCH} x seq {FT_SEQ} in {FT_ACCUM} microbatches, {n} steps '
        f'in {wall:.1f}s (model init and the base host copy included); '
        f'{n_adapter} adapter params, frozen base {base_bytes} bytes; '
        f'launches {launches}, expected {want}')
    if launches != want:
        raise AssertionError(f'{tag} launches {launches} != {want}')
    hist = metrics['history']
    if len(hist) != n or not all(
            np.isfinite(r['loss']) and np.isfinite(r['grad_norm'])
            for r in hist):
        raise AssertionError(f'{tag}: missing or non-finite steps: {hist}')
    for r in hist:
        log(f'{tag} step {r["step"]}: loss {r["loss"]:.4f} grad_norm '
            f'{r["grad_norm"]:.6f} step {r["step_ms"]:.1f} ms '
            f'{r["tokens_per_sec"]:.1f} tokens/s')
    steady = hist[1:]
    step_ms = sum(r['step_ms'] for r in steady) / len(steady)
    tps = FT_BATCH * FT_SEQ / step_ms * 1e3
    log(f'{tag}: steps 2-{n}: {step_ms:.1f} ms/step, {tps:.1f} tokens/s '
        f'({card}); peak memory allocated {peak} bytes '
        f'({peak / 2**30:.2f} GiB)')
    changed = [k for k, t in seen.pop('base').items()
               if not torch.equal(params[k].detach().cpu(), t)]
    untrained = [k for k, p in adapters.items()
                 if k.endswith('_lora.b') and not bool(p.detach().any())]
    log(f'{tag}: base parameters changed: {len(changed)} of '
        f'{len(params) - len(adapters)}; adapter b still all zero: '
        f'{len(untrained)} of {sum(k.endswith(".b") for k in adapters)}')
    if changed or untrained or not all(llama.is_lora(k) for k in adapters):
        raise AssertionError(f'{tag}: base changed {changed[:3]} or '
                             f'adapters untrained {untrained[:3]}')
    gap = finetune_gaps(dev, tr.model, model, tag)
    del tr, seen, params, adapters
    gc.collect()
    torch.cuda.empty_cache()
    if not (gap[0] <= TRAIN_LOSS_REL_TOL and gap[1] <= TRAIN_GNORM_REL_TOL):
        raise AssertionError(f'{tag}: kernels disagree with the plain '
                             'versions')
    return dict(launches=launches, step_ms=step_ms, tokens_per_s=tps,
                peak_bytes=peak, gaps=gap)


def _ck_trainer(dev, lora=True):
    from skypilot_tpu_torch.train import trainer as trainer_lib
    if lora:
        config = _lora_train_config(CK_LAYERS, global_batch_size=2,
                                    seq_len=CK_SEQ)
    else:
        config = trainer_lib.TrainConfig(
            model='llama3-8b', global_batch_size=2, seq_len=CK_SEQ,
            model_overrides={'n_layers': CK_LAYERS, 'max_seq_len': CK_SEQ})
    return trainer_lib.Trainer(config, device=dev)


def _ck_steps(tr, start: int, n: int) -> list:
    from skypilot_tpu_torch.train import data as data_lib
    stream = data_lib.synthetic_data(2, CK_SEQ, tr.model_config.vocab_size,
                                     start_step=start, device=tr.device)
    return [float(tr.step(next(stream))['loss']) for _ in range(n)]


def _ck_gaps(got: dict, want: dict) -> float:
    """max |got - want| over max |want| across the tensors of two
    state_dicts."""
    return max(float((got[k].float() - w.float()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30))
               for k, w in want.items())


def phase_checkpoint(dev, card: str) -> dict:
    """Save, resume, base-into-LoRA restore and serving a trained
    checkpoint, at llama3-8b width cut to CK_LAYERS layers, in a
    temporary directory removed at the end."""
    import shutil
    import tempfile

    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import checkpoint as ckpt_lib
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix='chip_smoke_ckpt_')
    out = {}
    srv = None
    try:
        # Base into LoRA: a params-only base (no adapters) opened by a LoRA
        # train_only trainer.
        base = _ck_trainer(dev, lora=False)
        base.init_state()
        t0 = time.perf_counter()
        ckpt_lib.save_params(ckpt_lib.make_manager(f'{root}/base'),
                             base.model.state_dict())
        save_s = time.perf_counter() - t0
        lora = _ck_trainer(dev)
        t0 = time.perf_counter()
        step = ckpt_lib.restore_or_init(ckpt_lib.make_manager(
            f'{root}/base'), lora)
        load_s = time.perf_counter() - t0
        sd, want = lora.model.state_dict(), base.model.state_dict()
        differ = [k for k, t in want.items() if not torch.equal(sd[k], t)]
        b_live = [k for k, t in sd.items()
                  if k.endswith('_lora.b') and bool(t.any())]
        from skypilot_tpu_torch.train import data as data_lib
        vocab = base.model_config.vocab_size
        tok = next(data_lib.synthetic_data(2, CK_SEQ, vocab, seed=3,
                                           device=dev))['inputs']
        with torch.no_grad():
            gap = _logit_gap(lora.model.train_forward(tok),
                             base.model.train_forward(tok))
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                     os.walk(f'{root}/base') for f in fs)
        log(f'checkpoint: base into LoRA: a params-only base of {nbytes} '
            f'bytes saved in {save_s:.1f}s, restored into a LoRA train_only '
            f'trainer in {load_s:.1f}s at step {step}; base params differing '
            f'{len(differ)} of {len(want)}; adapter b not zero {len(b_live)};'
            f' first logits against the base model: gap {gap} (limit 0.0)')
        if step != 0 or differ or b_live or gap != 0.0 or \
                set(sd) - set(want) != {k for k in sd if llama.is_lora(k)}:
            raise AssertionError('checkpoint: base into LoRA failed')
        del base, lora, sd, want
        shutil.rmtree(f'{root}/base')

        # Resume: 2 + 2 steps with a save and a fresh trainer between,
        # against 4 uninterrupted steps.
        whole = _ck_trainer(dev)
        whole.init_state()
        want_losses = _ck_steps(whole, 0, CK_STEPS)
        half = CK_STEPS // 2
        first = _ck_trainer(dev)
        first.init_state()
        losses = _ck_steps(first, 0, half)
        manager = ckpt_lib.make_manager(f'{root}/run', max_to_keep=1)
        ckpt_lib.save(manager, first, wait=True)
        del first
        resumed = _ck_trainer(dev)
        step = ckpt_lib.restore_or_init(manager, resumed)
        losses += _ck_steps(resumed, step, CK_STEPS - half)
        got_sd, want_sd = resumed.model.state_dict(), whole.model.state_dict()
        exact = losses == want_losses and all(
            torch.equal(got_sd[k], t) for k, t in want_sd.items())
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, want_losses))
        param_gap = _ck_gaps(got_sd, want_sd)
        log(f'checkpoint: resume at step {step}: losses {losses} against '
            f'uninterrupted {want_losses}; bit for bit: {exact} (loss rel '
            f'gap {loss_gap:.3e}, params max rel gap {param_gap:.3e})')
        if step != half or not (exact or loss_gap <= TRAIN_LOSS_REL_TOL):
            raise AssertionError('checkpoint: resume differs from the '
                                 'uninterrupted run')
        out.update(resume_exact=exact, resume_loss_gap=loss_gap)
        del whole, got_sd, want_sd
        ckpt_lib.save(manager, resumed, wait=True)
        params = {k: v.detach().clone()
                  for k, v in resumed.model.state_dict().items()}
        del resumed
        gc.collect()
        torch.cuda.empty_cache()

        # Serving the trained checkpoint: the CLI's server against an
        # engine given the same params in memory.
        overrides = {'n_layers': CK_LAYERS, 'lora_rank': 16,
                     'lora_alpha': 16}
        srv = server_lib.server_from_args([
            '--model', 'llama3-8b', '--model-overrides',
            json.dumps(overrides), '--checkpoint-dir', f'{root}/run',
            '--page-size', '16', '--prefill-chunk', '512',
            '--max-batch-size', '8', '--max-seq-len', '4096', '--port',
            '0', '--host', '127.0.0.1', '--device', str(dev)])
        eng = srv.engine
        if (eng.decode_kernel, eng.prefill_kernel) != ('fused', 'fused'):
            raise AssertionError('checkpoint: serving runs no kernel')
        srv.start()
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f'http://127.0.0.1:{srv.port}'
        rng = np.random.RandomState(31)
        prompts = [rng.randint(0, vocab, n).tolist() for n in CK_LENS]
        _reset_launch_counts()
        served = _post(url + '/generate', {'prompt_ids': prompts,
                                           'max_new_tokens': CK_NEW,
                                           'temperature': 0.0})['tokens']
        launches = _launch_counts()
        _check_branches(launches, 'auto', 'checkpoint')
        ref = engine_lib.ContinuousBatchingEngine(
            model='llama3-8b', params=params, n_slots=8, max_seq_len=4096,
            model_overrides=overrides, prefill_chunk=512, page_size=16,
            device=dev)
        want_tokens = ref.generate(prompts, engine_lib.SamplingConfig(
            max_new_tokens=CK_NEW))
        same = sum(a == b for g, w in zip(served, want_tokens)
                   for a, b in zip(g, w))
        log(f'checkpoint: served from --checkpoint-dir: {same} of '
            f'{sum(map(len, want_tokens))} greedy tokens equal to the engine '
            f'given the same params in memory; launches {launches}')
        if served != want_tokens:
            raise AssertionError('checkpoint: served streams differ from the '
                                 'in-memory params')
        srv.shutdown()
        srv = None
        graph_check(eng, vocab, 'checkpoint')
        del ref, params, eng
        out['launches'] = launches
        return out
    finally:
        if srv is not None:
            srv.shutdown()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the other families: qwen2-7b, mixtral-8x7b and gpt2, served and trained
# ---------------------------------------------------------------------------
# Served as serve's llama3-8b is: the server's CLI path
# (`server_from_args`), random bf16 weights from the engine's seed 0, page
# 16, prefill chunk 512, 8 slots, the default pipeline with decode graphs.
FAMILY_SERVE_ARGS = ('--page-size', '16', '--prefill-chunk', '512',
                     '--max-batch-size', '8', '--allow-random-weights',
                     '--port', '0', '--host', '127.0.0.1')
# Mixtral-8x7b at full width, cut to 16 of its 32 layers: each layer holds
# 1.451 B parameters (1.409 B of them its 8 experts), 2.9 GB in bf16, so
# 16 layers are 46.4 GB beside the f32 head (0.5 GB) and the page pool
# (2.15 GB at 16 layers); 32 layers (92.9 GB) do not fit the card.
MIXTRAL_SERVE_LAYERS = 16
# gpt2 (124 M) whole: max_seq_len is its pos_embed's 1024 rows, so the
# prompts stay under 1024 - SERVE_NEW.
GPT2_LENS = ([40, 100, 200, 300, 450, 600, 800, 960], [150, 500])
# Training, 5 steps each through the trainer's CLI, as train's llama3-8b
# (f32 params, grads and two AdamW moments: 16 bytes a parameter):
#   gpt2 whole, batch 8 x 1024: 124 M parameters, 2.0 GB;
#   qwen2-7b at 4 of its 28 layers, batch 2 x 4096: 4 x 233 M in the
#     layers and 2 x 545 M in the embedding and head, 32 GB (at full
#     depth 122 GB would not fit);
#   mixtral-8x7b at 2 of its 32 layers, batch 1 x 4096: 2 x 1.451 B in
#     the layers and 2 x 131 M in the embedding and head, 50.6 GB.
# (model, overrides, batch, seq)
TRAIN_FAMILIES = (
    ('gpt2', {}, 8, 1024),
    ('qwen2-7b', {'n_layers': 4}, 2, 4096),
    ('mixtral-8x7b', {'n_layers': 2}, 1, 4096),
)
# Steps on one repeated batch (warmup 2) whose loss must fall.
FAMILY_MEMORIZE_STEPS = 4
# One step, kernels vs plain versions, (loss, grad norm) relative gaps:
# the train phase's limits (TRAIN_LOSS_REL_TOL, TRAIN_GNORM_REL_TOL),
# unless a family is named here.  gpt2 whole (12 layers, 12 heads at d 64,
# batch 8 x 1024) read a grad-norm gap of 7.79e-5 on two H100 runs (loss
# 7.90e-6), over the llama3-8b-derived 5e-5, while its kernels held their
# rounding bounds at its heads (FLASH_EDGES gpt2_g1_d64); its limits are
# set as the train phase's were, about 10x the reading.  gemma-2b whole
# (train_gemma: 18 layers, 8 heads over 1 at d 256, the tied head over
# vocab 256128 whose gradient sums the lookup's and the head's) read a
# grad-norm gap of 5.07e-5 (loss 1.34e-5) on an H100, over 5e-5 again,
# while its kernels held their bounds at its heads (FLASH_D256_CASES
# gemma_2b_g8); its limits are about 10x the reading too.  A family named
# here also runs the checked step at f32 compute (the plain versions, the
# same weights and batch, a model without optimizer state): a reading of
# how far the kernels' run and the plain bf16 run each are from it.
FAMILY_TRAIN_LIMITS = {'gpt2': (1e-4, 8e-4), 'gemma-2b': (1e-4, 5e-4)}
# train_gemma: gemma-2b whole (18 layers, dim 2048, 8 heads over 1 at
# head_dim 256, ffn 16384, vocab 256128: 2.51 B parameters, 40 GB of f32
# params, grads and AdamW moments), batch 2 x seq 4096, the loss over
# 1024-position chunks of the tied f32 head: (model, batch, seq, chunk).
GEMMA_TRAIN = ('gemma-2b', 2, 4096, 1024)
# finetune_gemma: the finetune phase's LoRA recipe on gemma-7b at all 28
# layers (8.54 B parameters: a 34 GB f32 base).
GEMMA_FINETUNE = 'gemma-7b'


def _family_server(dev, model: str, max_seq_len: int, overrides=None,
                   extra=()):
    """The CLI's server for `model` (FAMILY_SERVE_ARGS), serving on a free
    localhost port; returns (server, its HTTP thread, base url)."""
    from skypilot_tpu_torch.infer import server as server_lib
    argv = ['--model', model, '--max-seq-len', str(max_seq_len),
            '--device', str(dev), *FAMILY_SERVE_ARGS, *extra]
    if overrides:
        argv += ['--model-overrides', json.dumps(overrides)]
    t0 = time.perf_counter()
    srv = server_lib.server_from_args(argv)
    eng = srv.engine
    cfg = eng.config
    log(f'serve[{model}]: dim {cfg.dim} layers {cfg.n_layers} heads '
        f'{cfg.n_heads}/{cfg.n_kv_heads} (group {cfg.n_heads // cfg.n_kv_heads}'
        f') head_dim {cfg.head_dim} ffn {cfg.ffn_dim} vocab '
        f'{cfg.vocab_size}, {type(eng.model).__name__}, {list(extra)}; '
        f'weights {weight_bytes(eng) / 1e9:.2f} GB, page pool '
        f'{eng._cache.nbytes() / 1e9:.2f} GB; ready in '  # pylint: disable=protected-access
        f'{time.perf_counter() - t0:.1f}s, '
        f'{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated')
    if (eng.decode_kernel, eng.prefill_kernel) != ('fused', 'fused'):
        raise AssertionError(f'{model}: serving runs no kernel')
    srv.start()
    http_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    http_thread.start()
    return srv, http_thread, f'http://127.0.0.1:{srv.port}'


def _stop(srv, http_thread) -> None:
    srv.shutdown()
    http_thread.join(timeout=30)


def phase_serve_qwen(dev) -> dict:
    """qwen2-7b whole: 28 layers, 28 query heads over 4 KV heads (a group
    of 7, not a multiple of kernel 4's 4-row blocks), q/k/v biases, an
    untied head; 7.62 B parameters, 15.2 GB in bf16.  The main path (10
    requests, kernels 4 and 5 counted), decode tokens/s, the first decode
    step kernels vs plain, a decode step replayed vs eager."""
    srv, http_thread, url = _family_server(dev, 'qwen2-7b', 4096)
    eng = srv.engine
    vocab = eng.config.vocab_size
    rng = np.random.RandomState(41)
    _, launches, _ = _serve_main_path(url, vocab, rng, 'auto',
                                      tag='qwen2-7b')
    tps = _decode_rate(url, eng, rng, 'qwen2-7b')
    log(f'serve_qwen: decode {tps:.1f} tokens/s at batch 8 (33- minus '
        '1-token runs over HTTP)')
    _stop(srv, http_thread)
    first_step_check(eng, rng.randint(0, vocab, 700).tolist(), 'serve_qwen')
    graph_check(eng, vocab, 'serve_qwen')
    eng.close()
    del srv, eng
    _free()
    return dict(launches=launches, decode_tps=tps)


@contextlib.contextmanager
def moe_routes(model, record: dict, force=None):
    """Within: every MoE layer of `model` records the experts [T, k] its
    router picks, by layer index, into `record` (the first call of each
    layer: a forward, not the backward's rerun of it); with `force` (an
    earlier run's record of the same forward) each layer takes the
    experts of `force` instead, its gates renormalised from its own
    router probabilities.  Forward pre-hooks on the MoE layers say which
    layer routes; `moe.route` is wrapped for the duration.  For holding
    two runs of the same forward against each other where a flipped
    route would otherwise decide the comparison."""
    from skypilot_tpu_torch.models import moe as moe_lib
    route = moe_lib.route
    layer = [None]

    def routed(cfg, logits):
        gates, experts, aux = route(cfg, logits)
        if force is not None:
            experts = force[layer[0]]
            probs = torch.softmax(logits, dim=-1).gather(1, experts)
            gates = probs / probs.sum(-1, keepdim=True)
        record.setdefault(layer[0], experts)
        return gates, experts, aux

    def at(i):
        def hook(mod, args):
            layer[0] = i
        return hook

    handles = [blk.moe_mlp.register_forward_pre_hook(at(i))
               for i, blk in enumerate(model.layers)]
    moe_lib.route = routed
    try:
        yield record
    finally:
        moe_lib.route = route
        for h in handles:
            h.remove()


def _route_flips(a: dict, b: dict, rows=None) -> list:
    """Routes (token, choice) that differ between two records, by layer."""
    return [int((a[i][rows] != b[i][rows]).sum()) if rows is not None
            else int((a[i] != b[i]).sum()) for i in sorted(a)]


def moe_route_check(eng, vocab: int, tag: str) -> dict:
    """The next decode step of 8 live requests (40-3000 tokens) through
    the kernels and through their plain versions.  bf16 attention
    through other roundings can flip a near-tie of a router; one flipped
    route moves its token's output far more than the rounding does, and,
    with capacity counted over the step's 8 tokens, also which routes of
    the other tokens are dropped, so flips cascade through the layers.
    Printed: how many (token, layer, choice) routes differ between the
    two runs, by layer, and the tokens whose routes all agree.  Held to
    LOGITS_REL_TOL of max |logit|: the logits at every token of the
    kernels' run against a plain run routed as the kernels' run was
    (`moe_routes`), where only the attention's rounding differs; and,
    where a token's routes all agree, at that token between the free
    runs."""
    rng = np.random.RandomState(23)
    rids = _live(eng, [rng.randint(0, vocab, n).tolist()
                       for n in GREEDY_LENS], SERVE_NEW)
    rows = [i for i, s in enumerate(eng._slots) if s is not None]  # pylint: disable=protected-access
    fused_routes, plain_routes = {}, {}
    with moe_routes(eng.model, fused_routes):
        fused = eng.decode_logits('fused').float()
    with moe_routes(eng.model, plain_routes):
        plain = eng.decode_logits('plain').float()
    with moe_routes(eng.model, {}, force=fused_routes):
        forced = eng.decode_logits('plain').float()
    flips = _route_flips(fused_routes, plain_routes, rows)
    agree = [r for r in rows if not any(
        (fused_routes[i][r] != plain_routes[i][r]).any()
        for i in fused_routes)]
    gap = _logit_gap(fused[rows], forced[rows])
    free_gap = (_logit_gap(fused[agree], plain[agree]) if agree
                else float('nan'))
    n_routes = len(fused_routes) * len(rows) * eng.config.experts_per_token
    log(f'{tag}: a decode step of {len(rows)} rows, kernels vs plain: '
        f'{sum(flips)} of {n_routes} (token, layer, choice) routes differ '
        f'(by layer {flips}); {len(agree)} tokens agree on every route, '
        f'their logits max abs diff over max |logit| {free_gap:.4e}; every '
        f'token against the plain run routed as the kernels\' run: '
        f'{gap:.4e} (limit {LOGITS_REL_TOL})')
    _drop(eng, rids)
    if not (gap <= LOGITS_REL_TOL and not free_gap > LOGITS_REL_TOL):
        raise AssertionError(f'{tag}: kernel logits disagree with the plain '
                             'path')
    return dict(routes_differ=sum(flips), routes=n_routes, agree=len(agree),
                gap=gap, free_gap=free_gap)


def phase_serve_mixtral(dev) -> dict:
    """mixtral-8x7b at full width, 16 of its 32 layers (MIXTRAL_SERVE_LAYERS:
    46.4 GB of bf16 weights), 32 query heads over 8 (a group of 4), 8
    experts, 2 a token, capacity 1.25: at a decode step of 8 rows that is
    2 routes an expert.  The main path (10 requests), decode tokens/s, the
    kernels-vs-plain check with the routes of both runs
    (`moe_route_check`), a decode step (the MoE layers inside) replayed
    from its CUDA graph vs eager; then a server with --spec-k 4: one
    n-gram request, so kernel 4 runs at S 5 under capacity."""
    overrides = {'n_layers': MIXTRAL_SERVE_LAYERS}
    srv, http_thread, url = _family_server(dev, 'mixtral-8x7b', 4096,
                                           overrides)
    eng = srv.engine
    vocab = eng.config.vocab_size
    rng = np.random.RandomState(43)
    _, launches, _ = _serve_main_path(url, vocab, rng, 'auto',
                                      tag='mixtral-8x7b')
    tps = _decode_rate(url, eng, rng, 'mixtral-8x7b')
    log(f'serve_mixtral: decode {tps:.1f} tokens/s at batch 8 (33- minus '
        '1-token runs over HTTP)')
    _stop(srv, http_thread)
    routes = moe_route_check(eng, vocab, 'serve_mixtral')
    graph_check(eng, vocab, 'serve_mixtral')
    eng.close()
    del srv, eng
    _free()

    srv, http_thread, url = _family_server(
        dev, 'mixtral-8x7b', 4096, overrides, extra=('--spec-k', '4'))
    eng = srv.engine
    prompt = template_prompts(vocab, 44)[0]
    _reset_launch_counts()
    toks = _post(url + '/generate', dict(prompt_ids=[prompt],
                                         max_new_tokens=SPEC_NEW,
                                         temperature=0.0))['tokens'][0]
    spec_launches = _launch_counts()
    by_s = _by_s()
    info = eng.speculation_info()
    log(f'serve_mixtral spec: one n-gram request of {len(prompt)} tokens, '
        f'{len(toks)} generated; launches {spec_launches}, kernel 4 by S '
        f'{by_s}; speculation {info}')
    _stop(srv, http_thread)
    if len(toks) != SPEC_NEW or not all(0 <= t < vocab for t in toks):
        raise AssertionError(f'serve_mixtral spec: bad completion {toks}')
    if by_s['float'].get(SPEC_K + 1, 0) <= 0 or \
            spec_launches['ragged_prefill'] <= 0:
        raise AssertionError('serve_mixtral spec: kernel 4 did not run at '
                             f'S {SPEC_K + 1}, or kernel 5 did not run')
    eng.close()
    del srv, eng
    _free()
    return dict(launches=launches, spec_launches=spec_launches,
                by_s=by_s, decode_tps=tps, routes=routes)


def phase_serve_gpt2(dev) -> dict:
    """gpt2 (124 M) whole, max_seq_len 1024: multi-head attention (12
    heads over 12, a group of 1) at head_dim 64, learned positions, the
    tied head.  The main path (10 requests of up to 960 tokens), decode
    tokens/s, the first decode step kernels vs plain."""
    srv, http_thread, url = _family_server(dev, 'gpt2', 1024)
    eng = srv.engine
    vocab = eng.config.vocab_size
    rng = np.random.RandomState(47)
    _, launches, _ = _serve_main_path(url, vocab, rng, 'auto', tag='gpt2',
                                      lens=GPT2_LENS)
    tps = _decode_rate(url, eng, rng, 'gpt2')
    log(f'serve_gpt2: decode {tps:.1f} tokens/s at batch 8 (33- minus '
        '1-token runs over HTTP)')
    _stop(srv, http_thread)
    first_step_check(eng, rng.randint(0, vocab, 600).tolist(), 'serve_gpt2')
    eng.close()
    del srv, eng
    _free()
    return dict(launches=launches, decode_tps=tps)


# Gemma at head width 256 (serve_gemma): gemma-7b whole from a bf16 and
# an int8 KV cache, then with gemma-2b as its draft (`--spec-k 4`), then
# gemma-2b alone; serve's settings through the CLI's server.  Every
# launch of kernels 4 and 5 in these phases is at d 256 (both models'
# head width, checked).
GEMMA_DRAFT = 'gemma-2b'


def _gemma_server(dev, model: str, extra=()):
    srv, http_thread, url = _family_server(dev, model, 4096, extra=extra)
    if srv.engine.config.head_dim != GEMMA_D:
        raise AssertionError(f'{model}: head_dim {srv.engine.config.head_dim}')
    return srv, http_thread, url


def phase_serve_gemma(dev) -> dict:
    """gemma-7b whole (28 layers, dim 3072, 16 heads over 16 at head_dim
    256, GeGLU ffn 24576, vocab 256128, the tied head; 8.54 B parameters,
    17.08 GB in bf16), serve's settings, through the CLI's server: with a
    bf16 KV cache the main path (10 requests, kernels 4 and 5 counted
    from 0), decode tokens/s, the first decode step kernels vs plain
    (LOGITS_REL_TOL), a decode step replayed vs eager (GRAPH_LOGITS_GAP);
    the same with --kv-cache-dtype int8, its kernels-vs-plain check being
    `int8_logit_gaps` (INT8_LOGITS_REL_TOL); a --spec-k 4 server with
    gemma-2b as the draft over templated prompts (kernel 4 at S 5 over 16
    KV heads, the draft's kernel 4 at S 1 over one KV head: a group of
    8); and gemma-2b alone: the main path, decode tokens/s, its first
    decode step kernels vs plain.  Returns launches by phase, kernel 4's
    launches by S in the spec server, decode tokens/s and the checks'
    gaps."""
    out = dict(launches={}, decode_tps={}, gaps={})
    for kv in ('auto', 'int8'):
        phase = 'serve_gemma' if kv == 'auto' else 'serve_gemma_int8'
        srv, http_thread, url = _gemma_server(
            dev, 'gemma-7b', () if kv == 'auto'
            else ('--kv-cache-dtype', 'int8'))
        eng = srv.engine
        vocab = eng.config.vocab_size
        rng = np.random.RandomState(51)
        _, out['launches'][phase], _ = _serve_main_path(
            url, vocab, rng, kv, tag=f'gemma-7b[{kv}]')
        tps = out['decode_tps'][phase] = _decode_rate(url, eng, rng, phase)
        log(f'{phase}: decode {tps:.1f} tokens/s at batch 8 (33- minus '
            '1-token runs over HTTP)')
        _stop(srv, http_thread)
        if kv == 'auto':
            first_step_check(eng, rng.randint(0, vocab, 700).tolist(), phase)
        else:
            prompts = int8_check_prompts(vocab)
            gaps, _ = int8_logit_gaps(eng, prompts)
            out['gaps'][phase] = gaps
            log(f'{phase}: logits through the int8 kernels against the int8 '
                f'plain versions, (prefill, first decode step) gap over max '
                f'|logit| for prompts of {[len(p) for p in prompts]} '
                f'tokens: {[(round(a, 5), round(b, 5)) for a, b in gaps]} '
                f'(limit {INT8_LOGITS_REL_TOL})')
            if not max(max(g) for g in gaps) <= INT8_LOGITS_REL_TOL:
                raise AssertionError(f'{phase}: int8 kernel logits disagree '
                                     'with the plain path')
        graph_check(eng, vocab, phase)
        eng.close()
        del srv, eng
        _free()

    srv, http_thread, url = _gemma_server(
        dev, 'gemma-7b', ('--spec-k', str(SPEC_K), '--draft-model',
                          GEMMA_DRAFT))
    eng = srv.engine
    vocab = eng.config.vocab_size
    prompts = template_prompts(vocab, 53)
    _reset_launch_counts()
    toks, burst_s = _post_all(url, [dict(prompt_ids=[p],
                                         max_new_tokens=SPEC_NEW)
                                    for p in prompts])
    launches = out['launches']['serve_gemma_spec'] = _launch_counts()
    by_s = out['by_s'] = _by_s()
    info = eng.speculation_info()
    log(f'serve_gemma_spec: {len(prompts)} greedy requests over templated '
        f'prompts with a {GEMMA_DRAFT} draft in {burst_s:.2f}s; verify '
        f'steps {info["steps"]}, proposed {info["proposed_tokens"]}, '
        f'accepted {info["accepted_tokens"]}, committed '
        f'{info["committed_tokens"]}; kernel 4 launches by S {by_s}; '
        f'launches {launches}')
    _stop(srv, http_thread)
    for t in toks:
        if len(t) != SPEC_NEW or not all(0 <= x < vocab for x in t):
            raise AssertionError(f'serve_gemma_spec: bad completion {t}')
    if not (by_s['float'].get(SPEC_K + 1, 0) > 0
            and by_s['float'].get(1, 0) > 0
            and launches['ragged_prefill'] > 0
            and info['proposed_tokens'] > 0):
        raise AssertionError('serve_gemma_spec: kernel 4 at S '
                             f'{SPEC_K + 1} (target) or S 1 (draft), or '
                             'kernel 5, did not launch, or nothing was '
                             'proposed')
    eng.close()
    del srv, eng
    _free()

    srv, http_thread, url = _gemma_server(dev, 'gemma-2b')
    eng = srv.engine
    vocab = eng.config.vocab_size
    rng = np.random.RandomState(55)
    _, out['launches']['serve_gemma_2b'], _ = _serve_main_path(
        url, vocab, rng, 'auto', tag='gemma-2b')
    tps = out['decode_tps']['serve_gemma_2b'] = _decode_rate(
        url, eng, rng, 'gemma-2b')
    log(f'serve_gemma_2b: decode {tps:.1f} tokens/s at batch 8 (33- minus '
        '1-token runs over HTTP)')
    _stop(srv, http_thread)
    first_step_check(eng, rng.randint(0, vocab, 700).tolist(),
                     'serve_gemma_2b')
    eng.close()
    del srv, eng
    _free()
    return out


def family_gaps_and_memorize(dev, model: str, overrides: dict, batch: int,
                             seq: int, loss_chunk: int = 0,
                             tag: str = 'train_families') -> dict:
    """One step's loss and global grad norm with the kernels and with their
    plain versions at one batch and the same weights, within
    FAMILY_TRAIN_LIMITS; a MoE model's plain run is routed as the kernels'
    run was (`moe_routes`), and its free run's gaps are printed beside.
    Then FAMILY_MEMORIZE_STEPS steps on that batch (warmup 2): the loss
    must fall.  Returns the gaps."""
    from skypilot_tpu_torch import models as models_lib
    from skypilot_tpu_torch.train import data as data_lib
    from skypilot_tpu_torch.train import trainer as trainer_lib
    config = trainer_lib.TrainConfig(
        model=model, global_batch_size=batch, seq_len=seq, warmup_steps=2,
        total_steps=20, model_overrides=dict(overrides, max_seq_len=seq),
        loss_chunk=loss_chunk)
    tr = trainer_lib.Trainer(config, device=dev)
    tr.init_state()
    data = next(data_lib.synthetic_data(batch, seq,
                                        tr.model_config.vocab_size, seed=1,
                                        device=dev))
    moe = hasattr(tr.model.layers[0], 'moe_mlp')

    def step(kernel, model=tr.model, **routes):
        ctx = (moe_routes(model, **routes) if moe
               else contextlib.nullcontext())
        with ctx:
            m = trainer_lib.compute_grads(model, data, kernel=kernel,
                                          loss_chunk=loss_chunk)
        gn = trainer_lib.global_norm({k: p.grad for k, p in
                                      model.named_parameters()})
        model.zero_grad(set_to_none=True)
        return float(m['loss']), float(m['aux_loss']), float(gn)

    def rel(a, b):
        return (abs(a[0] - b[0]) / abs(b[0]), abs(a[2] - b[2]) / abs(b[2]))

    routes = {}
    fused = step('fused', record=routes)
    plain = step('xla', record={}, force=routes) if moe else step('xla')
    gaps = rel(fused, plain)
    if model in FAMILY_TRAIN_LIMITS:
        f32 = models_lib.build(models_lib.get_config(
            model, **dict(config.model_overrides, dtype='float32')), dev)
        f32.load_state_dict(tr.model.state_dict())
        f32.requires_grad_(True)
        ref = step('xla', model=f32)
        log(f'{tag}[{model}]: against the same step at f32 '
            f'(plain versions): the kernels\' run rel gaps '
            f'{rel(fused, ref)[0]:.3e} (loss) and {rel(fused, ref)[1]:.3e} '
            f'(grad norm); the plain bf16 run {rel(plain, ref)[0]:.3e} and '
            f'{rel(plain, ref)[1]:.3e}')
        del f32
        _free()
    loss_tol, norm_tol = FAMILY_TRAIN_LIMITS.get(
        model, (TRAIN_LOSS_REL_TOL, TRAIN_GNORM_REL_TOL))
    free = ''
    if moe:
        free_routes = {}
        free_gaps = rel(fused, step('xla', record=free_routes))
        free = (f'; the free plain run ({sum(_route_flips(routes, free_routes))}'
                f' of {sum(r.numel() for r in routes.values())} routes '
                f'differ): rel gaps {free_gaps[0]:.3e} and {free_gaps[1]:.3e}')
    log(f'{tag}[{model}]: one step, kernels vs plain: loss '
        f'{fused[0]:.6f} vs {plain[0]:.6f} (rel gap {gaps[0]:.3e}, limit '
        f'{loss_tol}); aux_loss {fused[1]:.6f} vs {plain[1]:.6f}; grad norm '
        f'{fused[2]:.6f} vs {plain[2]:.6f} (rel gap {gaps[1]:.3e}, limit '
        f'{norm_tol}){free}')
    if not (np.isfinite([*fused, *gaps]).all() and gaps[0] <= loss_tol
            and gaps[1] <= norm_tol):
        raise AssertionError(f'{tag}[{model}]: kernels disagree '
                             'with the plain versions')
    losses = [float(tr.step(data)['loss'])
              for _ in range(FAMILY_MEMORIZE_STEPS)]
    log(f'{tag}[{model}]: {FAMILY_MEMORIZE_STEPS} steps on one '
        f'repeated batch: losses {[round(x, 4) for x in losses]}')
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f'{tag}[{model}]: loss did not fall '
                             'on a repeated batch')
    del tr, data
    _free()
    return dict(loss_gap=gaps[0], grad_norm_gap=gaps[1])


def train_family(dev, model: str, overrides: dict, batch: int, seq: int,
                 loss_chunk: int = 0, tag: str = 'train_families') -> dict:
    """`model` through `python -m skypilot_tpu_torch.train` (its `main`),
    TRAIN_STEPS steps, every count set to 0 just before and read just
    after: flash forward 2 L steps (remat reruns it), dq and dk/dv L steps
    each, the serving kernels 0; every loss, aux_loss and grad_norm
    finite.  Then `family_gaps_and_memorize`.  Returns the launches, the
    mean ms and tokens/s of steps 2 on, the peak memory and the gaps."""
    from skypilot_tpu_torch import models as models_lib
    from skypilot_tpu_torch.train import __main__ as train_main
    _free()
    torch.cuda.reset_peak_memory_stats()
    argv = ['--model', model, '--model-overrides', json.dumps(overrides),
            '--global-batch-size', str(batch), '--seq-len', str(seq),
            '--loss-chunk', str(loss_chunk), '--steps', str(TRAIN_STEPS),
            '--log-every', '1', '--device', str(dev)]
    _reset_launch_counts()
    t0 = time.perf_counter()
    metrics = train_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    L = models_lib.get_config(model, **overrides).n_layers
    n = TRAIN_STEPS
    want = {'paged_decode': 0, 'ragged_prefill': 0,
            'paged_decode_int8': 0, 'ragged_prefill_int8': 0,
            'flash_fwd': 2 * L * n, 'flash_bwd_dq': L * n,
            'flash_bwd_dkv': L * n}
    hist = metrics['history']
    peak = metrics['peak_memory_bytes']
    log(f'{tag}[{model}]: {L} layers, batch {batch} x seq {seq}, loss_chunk '
        f'{loss_chunk}, {n} steps in {wall:.1f}s (model init included), '
        f'{metrics["n_params"]} parameters; launches {launches}, '
        f'expected {want}; peak memory allocated {peak} bytes '
        f'({peak / 2**30:.2f} GiB)')
    for r in hist:
        log(f'{tag}[{model}] step {r["step"]}: loss '
            f'{r["loss"]:.4f} aux_loss {r["aux_loss"]:.6f} grad_norm '
            f'{r["grad_norm"]:.4f} step {r["step_ms"]:.1f} ms '
            f'{r["tokens_per_sec"]:.1f} tokens/s')
    if launches != want:
        raise AssertionError(f'{tag}[{model}] launches {launches} != {want}')
    if len(hist) != n or not all(
            np.isfinite([r['loss'], r['aux_loss'], r['grad_norm']]).all()
            for r in hist):
        raise AssertionError(f'{tag}[{model}]: missing or non-finite steps: '
                             f'{hist}')
    if model.startswith('mixtral') and not all(r['aux_loss'] > 0
                                               for r in hist):
        raise AssertionError(f'{tag}: no router aux loss')
    step_ms = sum(r['step_ms'] for r in hist[1:]) / (n - 1)
    tps = batch * seq / step_ms * 1e3
    log(f'{tag}[{model}]: steps 2-{n}: {step_ms:.1f} ms/step, {tps:.1f} '
        'tokens/s')
    del metrics
    _free()
    gaps = family_gaps_and_memorize(dev, model, overrides, batch, seq,
                                    loss_chunk, tag)
    return dict(launches=launches, step_ms=step_ms, tokens_per_s=tps,
                peak_bytes=peak, gaps=gaps)


def phase_train_families(dev) -> dict:
    """TRAIN_FAMILIES, each through `train_family`.  Returns the launches
    by family."""
    return {model: train_family(dev, model, overrides, batch, seq)[
        'launches'] for model, overrides, batch, seq in TRAIN_FAMILIES}


def phase_train_gemma(dev) -> dict:
    """gemma-2b whole (GEMMA_TRAIN) through `train_family`: flash kernels
    1-3 at head width 256 on the trainer's main path."""
    model, batch, seq, chunk = GEMMA_TRAIN
    return train_family(dev, model, {}, batch, seq, loss_chunk=chunk,
                        tag='train_gemma')


def main() -> int:
    t0 = time.perf_counter()

    def lap(phase: str) -> None:
        log(f'{phase} phase done at {time.perf_counter() - t0:.1f}s')

    card = phase_device()
    dev = torch.device('cuda')
    phase_build()
    lap('build')
    kernels = phase_kernels(dev)
    kernels.update(phase_flash_kernels(dev))
    kernels.update(phase_kernels_d256(dev))
    kernels.update(phase_flash_d256(dev))
    lap('kernel')
    bf16 = phase_serve(dev)
    launches = dict(bf16['launches'])
    by_phase = {'serve': bf16['launches']}
    lap('serve')
    by_phase['serve_prefix'] = phase_serve_prefix(
        dev, bf16.pop('engine'))['launches']
    lap('serve_prefix')
    int8 = phase_serve_int8(dev, bf16)
    launches.update({k: int8['launches'][k] for k in SERVE_KERNELS_INT8})
    by_phase['serve_int8'] = int8['launches']
    lap('serve_int8')
    by_phase['serve_wint8'] = phase_serve_wint8(dev, bf16)['launches']
    del bf16, int8
    lap('serve_wint8')
    unpaged = phase_serve_unpaged(dev)
    by_phase['serve_unpaged'] = unpaged['launches']
    lap('serve_unpaged')
    by_phase['serve_static'] = phase_serve_static(dev, unpaged)['launches']
    lap('serve_static')
    spec = phase_serve_spec(dev)
    by_phase['serve_spec'] = spec['launches']
    lap('serve_spec')
    mixed = phase_serve_mixed(dev)
    by_phase['serve_mixed'] = mixed['launches']
    lap('serve_mixed')
    pipelined = phase_serve_async(dev, card)
    by_phase['serve_async'] = pipelined['launches']
    lap('serve_async')
    phase_invariants(dev)
    lap('invariants')
    by_phase['train'] = phase_train(dev)
    launches.update({k: v for k, v in by_phase['train'].items()
                     if k.startswith('flash')})
    lap('train')
    by_phase['finetune'] = phase_finetune(dev, card)['launches']
    lap('finetune')
    by_phase['checkpoint'] = phase_checkpoint(dev, card)['launches']
    lap('checkpoint')
    by_phase['serve_qwen'] = phase_serve_qwen(dev)['launches']
    lap('serve_qwen')
    mixtral = phase_serve_mixtral(dev)
    by_phase['serve_mixtral'] = mixtral['launches']
    by_phase['serve_mixtral_spec'] = mixtral['spec_launches']
    lap('serve_mixtral')
    by_phase['serve_gpt2'] = phase_serve_gpt2(dev)['launches']
    lap('serve_gpt2')
    # Kept apart from by_phase: the gemma phases launch only the
    # head-width-256 instantiations, listed under their own entries.
    gemma = phase_serve_gemma(dev)
    lap('serve_gemma')
    for model, counts in phase_train_families(dev).items():
        by_phase[f'train_families:{model}'] = counts
    lap('train_families')
    # Kept apart from by_phase too: these launch only the head-width-256
    # flash instantiations, listed under their own entries.
    flash_d256_by_phase = {'train_gemma': phase_train_gemma(dev)['launches']}
    lap('train_gemma')
    flash_d256_by_phase['finetune_gemma'] = phase_finetune(
        dev, card, model=GEMMA_FINETUNE, tag='finetune_gemma')['launches']
    lap('finetune_gemma')
    entries = []
    for name, src, replaces in (
            ('paged_decode', 'paged_decode',
             'skypilot_tpu/ops/paged_attention.py:56'),
            ('ragged_prefill', 'ragged_prefill',
             'skypilot_tpu/ops/ragged_prefill.py:61'),
            ('paged_decode_int8', 'paged_decode',
             'skypilot_tpu/ops/paged_attention.py:56'),
            ('ragged_prefill_int8', 'ragged_prefill',
             'skypilot_tpu/ops/ragged_prefill.py:61'),
            ('flash_fwd', 'flash_fwd',
             'skypilot_tpu/ops/flash_attention.py:165'),
            ('flash_bwd_dq', 'flash_bwd',
             'skypilot_tpu/ops/flash_attention.py:326'),
            ('flash_bwd_dkv', 'flash_bwd',
             'skypilot_tpu/ops/flash_attention.py:364')):
        entries.append(dict(
            name=name, route='cuda',
            source=f'skypilot_tpu_torch/csrc/{src}.cu',
            replaces=replaces, launches=launches[name],
            launches_by_phase={p: c[name] for p, c in by_phase.items()},
            # By S in each run of the two phases; 'int8_check' is the
            # int8 cache's kernels-vs-plain check, not the main path.
            **({'launches_by_s': dict({
                phase: {m: c['int8' if name.endswith('_int8') else 'float']
                        for m, c in runs['by_s'].items()}
                for phase, runs in (('serve_spec', spec),
                                    ('serve_mixed', mixed))},
                serve_async=pipelined['by_s'][
                    'int8' if name.endswith('_int8') else 'float'],
                serve_mixtral_spec=mixtral['by_s'][
                    'int8' if name.endswith('_int8') else 'float'])}
               if name.startswith('paged_decode') else {}),
            **({'branch': 'quant'} if name.endswith('_int8') else {}),
            **kernels[name]))
    # The head-width-256 instantiations: launched only by the gemma
    # phases; the float branch's main path is serve_gemma, the int8
    # branch's serve_gemma_int8.
    gemma_by_phase = gemma['launches']
    for entry in entries[:4]:
        name = entry['name']
        quant = name.endswith('_int8')
        entries.append(dict(
            name=f'{name}_d256', route='cuda', source=entry['source'],
            replaces=entry['replaces'], head_dim=GEMMA_D,
            launches=gemma_by_phase['serve_gemma_int8' if quant
                                    else 'serve_gemma'][name],
            launches_by_phase={p: c[name] for p, c in gemma_by_phase.items()},
            **({'launches_by_s': {'serve_gemma_spec': gemma['by_s'][
                'int8' if quant else 'float']}}
               if name.startswith('paged_decode') else {}),
            **({'branch': 'quant'} if quant else {}),
            **kernels[f'{name}_d256']))
    # Flash kernels 1-3 at head width 256: their main path is train_gemma.
    for entry in entries[4:7]:
        name = entry['name']
        entries.append(dict(
            name=f'{name}_d256', route='cuda', source=entry['source'],
            replaces=entry['replaces'],
            launches=flash_d256_by_phase['train_gemma'][name],
            launches_by_phase={p: c[name] for p, c in
                               flash_d256_by_phase.items()},
            **kernels[f'{name}_d256']))
    log(f'card: {card}')
    log(json.dumps({'kernels': entries}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

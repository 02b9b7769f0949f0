#!/usr/bin/env python3
"""Where a serving or training step's time goes in the PyTorch/H100 port.

    python3 scripts/port_profile.py [--trace-dir DIR] [--windows train]

Builds the port's ContinuousBatchingEngine on llama3-8b (random bf16
weights from a seed; page 16, prefill chunk 512, 8 slots, max_seq_len
4096, the CUDA kernels) and profiles five windows with torch.profiler:

  prefill - one 3000-token prompt: its six 512-token chunks and the
            decode step that emits its token (the engine's default decode
            loop: pipelined, the S = 1 decode forward replayed from CUDA
            graphs; one such prompt first, outside the window, so that
            the window captures no graph);
  decode_sync_eager, decode_async_eager, decode_async_graphs - 16 decode
            steps at batch 8 (8 live slots, 64-token prompts) in each of
            chip_smoke.DECODE_MODES: the synchronous loop with the eager
            forward, the pipelined loop with the eager forward, and the
            pipelined loop replaying the decode graphs (the default);
  prefill_int8, decode_int8 - the same two with the engine freed and
            rebuilt with an int8 KV cache (kv_cache_dtype='int8');
  prefill_wint8, decode_wint8 - the same two with int8 weights
            (quantize='int8') and a bf16 KV cache;
  train   - with the engine freed, the port's Trainer on llama3-8b widths
            cut to 4 layers, batch 2 x seq 4096 (random weights from a
            seed): 2 steps after one unprofiled step;
  finetune_nothing, finetune_unchunked, finetune - the same shape with
            rank-16 LoRA adapters and train_only='lora': remat 'nothing',
            then remat_policy='save_attn', then save_attn with the chunked
            loss (loss_chunk 1024, the recipe's settings);
            finetune_full - chip_smoke.py's finetune phase: all 32
            layers, batch 2 x seq 8192 in two microbatches, the recipe's
            settings;
  train_gemma, finetune_gemma - chip_smoke.py's gemma phases: gemma-2b
            whole, batch 2 x seq 4096, the loss in 1024-position chunks;
            gemma-7b whole (28 layers) under the finetune recipe, batch
            2 x seq 8192 in two microbatches.

For each window it prints one JSON line: host wall time per step (host
clock around work that ends in a device synchronize), device busy time
(the union of the kernels' intervals in the trace), the device's idle
share, the attention kernels' share, the device kernels and the host's
launch calls (kernel launches and graph launches) a step, the peak
device memory allocated in the window, the share of
busy time in f32 GEMMs (`_is_f32_gemm`: in a train step only the f32
head's products run in f32), and the kernels that took the most device
time.  With --trace-dir it also
writes each window's Chrome trace there; --windows picks some of serve
(prefill, the three decode modes), serve_int8 (their int8-cache twins),
serve_wint8 (their int8-weight twins), train, finetune and gemma
(default: all six).
Needs one NVIDIA card.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  pylint: disable=wrong-import-position

_ATTENTION = ('paged_decode_kernel', 'ragged_prefill_', 'flash_fwd_kernel',
              'flash_bwd_')


def _is_f32_gemm(name: str) -> bool:
    """cuBLAS's and CUTLASS's f32 (SIMT, ffma) GEMM kernels."""
    return 'sgemm' in name or 'gemm_f32f32_f32f32' in name


def _kernel_events(prof):
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _summary(name, prof, wall_s, steps):
    events = _kernel_events(prof)
    busy = chip_smoke.union_us((s, e) for _, s, e in events)
    by_name = collections.Counter()
    for n, s, e in events:
        by_name[n] += e - s
    attn = sum(v for k, v in by_name.items()
               if any(a in k for a in _ATTENTION))
    wall_us = wall_s * 1e6
    return {
        'window': name, 'steps': steps,
        'wall_ms_per_step': wall_us / steps / 1e3,
        'device_busy_ms_per_step': busy / steps / 1e3,
        'device_idle_share': (1.0 - busy / wall_us) if events else None,
        'attention_kernel_share_of_busy': (attn / busy) if busy else None,
        'f32_gemm_share_of_busy': (sum(
            v for k, v in by_name.items() if _is_f32_gemm(k)) / busy)
        if busy else None,
        'kernel_launches_per_step': len(events) / steps,
        'host_launches_per_step': sum(
            e.name in chip_smoke.LAUNCH_CALLS for e in prof.events()) / steps,
        'top_kernels_ms_per_step': [
            [k[:90], v / steps / 1e3] for k, v in by_name.most_common(8)],
    }


def _serve_windows(window, tag, kv_cache_dtype, quantize=None):
    from skypilot_tpu_torch.infer import engine as engine_lib
    eng = engine_lib.ContinuousBatchingEngine(
        model='llama3-8b', n_slots=8, max_seq_len=4096, prefill_chunk=512,
        page_size=16, seed=0, kv_cache_dtype=kv_cache_dtype,
        quantize=quantize)
    eng.generate([[1, 2, 3]], engine_lib.SamplingConfig(max_new_tokens=2))
    rng = np.random.RandomState(0)
    vocab = eng.config.vocab_size

    def prefill():
        eng.submit(rng.randint(0, vocab, 3000).tolist(),
                   engine_lib.SamplingConfig(max_new_tokens=1))
        steps = 0
        while eng.step():
            steps += 1
        return steps

    # A first 3000-token prompt captures the decode graph of its read
    # bucket outside the window (a capture happens once a bucket).
    prefill()
    window('prefill' + tag, prefill)
    graphs = eng._graphs  # pylint: disable=protected-access

    def decode():
        for _ in range(16):
            eng.step()
        return 16

    for mode in chip_smoke.DECODE_MODES:
        chip_smoke.set_decode_mode(eng, mode, graphs)
        for _ in range(8):
            eng.submit(rng.randint(0, vocab, 64).tolist(),
                       engine_lib.SamplingConfig(max_new_tokens=40))
        eng.step()      # admits and prefills all 8, first decode step
        eng.step()
        window(f'decode_{mode}' + tag, decode)
        eng.run_until_idle()


def _train_window(window, name='train', n_layers=4, seq=4096,
                  model='llama3-8b', **kw):
    """Two steps of a Trainer (batch 2 x `seq`) after one unprofiled step;
    `n_layers` None keeps the config's depth."""
    from skypilot_tpu_torch.train import data as data_lib
    from skypilot_tpu_torch.train import trainer as trainer_lib
    overrides = {'max_seq_len': seq}
    if n_layers is not None:
        overrides['n_layers'] = n_layers
    overrides.update(kw.pop('model_overrides', {}))
    config = trainer_lib.TrainConfig(
        model=model, global_batch_size=2, seq_len=seq,
        model_overrides=overrides, **kw)
    tr = trainer_lib.Trainer(config, device='cuda')
    tr.init_state()
    stream = data_lib.synthetic_data(2, seq, tr.model_config.vocab_size,
                                     device='cuda')
    tr.step(next(stream))
    batches = [next(stream) for _ in range(2)]

    def train():
        for batch in batches:
            tr.step(batch)
        return len(batches)

    window(name, train)
    del tr, batches
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--trace-dir', default=None)
    parser.add_argument('--windows',
                        default='serve,serve_int8,serve_wint8,train,'
                                'finetune,gemma',
                        help='comma-separated: serve, serve_int8, '
                             'serve_wint8, train, finetune, gemma')
    args = parser.parse_args()
    picked = set(args.windows.split(','))
    if not picked <= {'serve', 'serve_int8', 'serve_wint8', 'train',
                      'finetune', 'gemma'}:
        raise SystemExit(f'port_profile: unknown windows {args.windows}')
    if not torch.cuda.is_available():
        raise SystemExit('port_profile: needs an NVIDIA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def window(name, steps_fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            steps = steps_fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if args.trace_dir:
            os.makedirs(args.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                args.trace_dir, f'port_profile_{name}.json'))
        summary = _summary(name, prof, wall, steps)
        summary['peak_memory_bytes'] = torch.cuda.max_memory_allocated()
        print(json.dumps(summary), flush=True)

    for name, tag, kv_cache_dtype, quantize in (
            ('serve', '', 'auto', None), ('serve_int8', '_int8', 'int8', None),
            ('serve_wint8', '_wint8', 'auto', 'int8')):
        if name in picked:
            _serve_windows(window, tag, kv_cache_dtype, quantize)
            gc.collect()
            torch.cuda.empty_cache()
    if 'train' in picked:
        _train_window(window)
    if 'finetune' in picked:
        adapters = {'lora_rank': 16, 'lora_alpha': 16}
        _train_window(window, 'finetune_nothing', train_only='lora',
                      model_overrides=adapters)
        lora = dict(train_only='lora', model_overrides=dict(
            adapters, remat_policy='save_attn'))
        _train_window(window, 'finetune_unchunked', **lora)
        _train_window(window, 'finetune', loss_chunk=1024, **lora)
        _train_window(window, 'finetune_full', n_layers=32, seq=8192,
                      grad_accum_steps=2, loss_chunk=1024, **lora)
    if 'gemma' in picked:
        model, _, seq, chunk = chip_smoke.GEMMA_TRAIN
        _train_window(window, 'train_gemma', n_layers=None, seq=seq,
                      model=model, loss_chunk=chunk)
        _train_window(window, 'finetune_gemma', n_layers=None,
                      seq=chip_smoke.FT_SEQ,
                      model=chip_smoke.GEMMA_FINETUNE,
                      grad_accum_steps=chip_smoke.FT_ACCUM,
                      loss_chunk=chip_smoke.FT_CHUNK, train_only='lora',
                      model_overrides=dict(chip_smoke.FT_OVERRIDES))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    print(json.dumps({'card': smi.stdout.strip().splitlines()[0]}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Train entry point: `python -m skypilot_tpu_torch.train --model ...`

Port of `python -m skypilot_tpu.train` for one device, on the synthetic
token stream:

    python -m skypilot_tpu_torch.train --model llama3-8b \\
        --model-overrides '{"n_layers": 4}' --global-batch-size 2 \\
        --seq-len 4096 --steps 5

`--device` defaults to cuda (without a card it raises; `--device cpu`
runs the kernels' plain versions).  The LoRA finetuning recipe (the
reference's examples/llm/llama3_finetune_lora.yaml, on random base
weights and the synthetic stream):

    python -m skypilot_tpu_torch.train --model llama3-8b \
        --model-overrides '{"lora_rank": 16, "lora_alpha": 16,
                            "remat_policy": "save_attn"}' \
        --train-only lora --loss-chunk 1024 --seq-len 8192 \
        --global-batch-size 16 --grad-accum-steps 16 --checkpoint-dir DIR

With `--checkpoint-dir` a run resumes as the reference's does: the
latest checkpoint there is restored (`checkpoint.restore_or_init`; with
`--train-only` a base checkpoint without adapters loads through the
params-only partial restore at step 0), the synthetic stream restarts
at the restored step (token-exact), the remaining steps of `--steps`
run, saving every `--checkpoint-every` steps, and a final checkpoint is
saved.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description='skypilot_tpu_torch trainer')
    parser.add_argument('--model', default='llama-tiny')
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--global-batch-size', type=int, default=8)
    parser.add_argument('--seq-len', type=int, default=512)
    parser.add_argument('--learning-rate', type=float, default=3e-4)
    parser.add_argument('--grad-accum-steps', type=int, default=1)
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--json-metrics', action='store_true',
                        help='Print final metrics as one JSON line '
                             '(SKYTPU_METRICS {...}).')
    parser.add_argument('--model-overrides', default=None,
                        help='JSON dict of model-config overrides, '
                             "e.g. '{\"n_layers\": 4}'")
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--checkpoint-every', type=int, default=0)
    parser.add_argument('--loss-chunk', type=int, default=0,
                        help='Chunked cross-entropy: apply the lm_head '
                             'per this many sequence tokens so the '
                             'full [B,S,vocab] f32 logits never '
                             'materialize (0 = off).')
    parser.add_argument('--train-only', default=None,
                        help='Train only params whose path contains '
                             "this substring (e.g. 'lora'); the rest "
                             'are frozen.')
    args = parser.parse_args(argv)

    import torch

    from skypilot_tpu_torch import models as models_lib
    from skypilot_tpu_torch.train import checkpoint as ckpt_lib
    from skypilot_tpu_torch.train import data as data_lib
    from skypilot_tpu_torch.train import trainer as trainer_lib

    overrides = {'max_seq_len': args.seq_len}
    if args.model_overrides:
        overrides.update(json.loads(args.model_overrides))
    config = trainer_lib.TrainConfig(
        model=args.model, global_batch_size=args.global_batch_size,
        seq_len=args.seq_len, learning_rate=args.learning_rate,
        grad_accum_steps=args.grad_accum_steps, total_steps=args.steps,
        model_overrides=overrides, train_only=args.train_only,
        loss_chunk=args.loss_chunk)
    trainer = trainer_lib.Trainer(config, device=args.device)
    manager = None
    if args.checkpoint_dir:
        manager = ckpt_lib.make_manager(args.checkpoint_dir)
        ckpt_lib.restore_or_init(manager, trainer)
    else:
        trainer.init_state()
    # Resume token-exact: the stream starts where the lost run's left off.
    start_step = trainer.step_count
    data_iter = data_lib.synthetic_data(
        config.global_batch_size, config.seq_len,
        trainer.model_config.vocab_size, seed=config.seed,
        start_step=start_step, device=trainer.device)
    metrics = dict(trainer.train(data_iter,
                                 num_steps=max(args.steps - start_step, 0),
                                 log_every=args.log_every,
                                 checkpoint_manager=manager,
                                 checkpoint_every=args.checkpoint_every))
    if manager is not None:
        ckpt_lib.save(manager, trainer, wait=True)
    dev = trainer.device
    metrics.update({
        'n_params': models_lib.num_params(trainer.model_config),
        'n_devices': 1,
        'device_kind': (torch.cuda.get_device_name(dev)
                        if dev.type == 'cuda' else 'cpu'),
        'global_batch_size': config.global_batch_size,
        'seq_len': config.seq_len,
        'start_step': start_step,
        'history': trainer.history,
    })
    if dev.type == 'cuda':
        metrics['peak_memory_bytes'] = torch.cuda.max_memory_allocated(dev)
    if args.json_metrics:
        print('SKYTPU_METRICS ' + json.dumps(metrics), flush=True)
    return metrics


if __name__ == '__main__':
    main()

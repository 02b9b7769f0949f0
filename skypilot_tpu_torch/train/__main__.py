"""Train entry point: `python -m skypilot_tpu_torch.train --model ...`

Port of `python -m skypilot_tpu.train` for one device, on the synthetic
token stream:

    python -m skypilot_tpu_torch.train --model llama3-8b \\
        --model-overrides '{"n_layers": 4}' --global-batch-size 2 \\
        --seq-len 4096 --steps 5

`--device` defaults to cuda (without a card it raises; `--device cpu`
runs the kernels' plain versions).  Checkpointing is not ported yet.
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
    parser.add_argument('--checkpoint-dir', default=None,
                        help='Not ported yet: raises.')
    args = parser.parse_args(argv)
    if args.checkpoint_dir:
        raise ValueError("--checkpoint-dir: checkpointing is not ported yet "
                         "(ROADMAP.md queue 1: 'Checkpoint and launch')")

    import torch

    from skypilot_tpu_torch import models as models_lib
    from skypilot_tpu_torch.train import data as data_lib
    from skypilot_tpu_torch.train import trainer as trainer_lib

    overrides = {'max_seq_len': args.seq_len}
    if args.model_overrides:
        overrides.update(json.loads(args.model_overrides))
    config = trainer_lib.TrainConfig(
        model=args.model, global_batch_size=args.global_batch_size,
        seq_len=args.seq_len, learning_rate=args.learning_rate,
        grad_accum_steps=args.grad_accum_steps, total_steps=args.steps,
        model_overrides=overrides)
    trainer = trainer_lib.Trainer(config, device=args.device)
    trainer.init_state()
    data_iter = data_lib.synthetic_data(
        config.global_batch_size, config.seq_len,
        trainer.model_config.vocab_size, seed=config.seed,
        start_step=trainer.step_count, device=trainer.device)
    metrics = dict(trainer.train(data_iter, num_steps=args.steps,
                                 log_every=args.log_every))
    dev = trainer.device
    metrics.update({
        'n_params': models_lib.num_params(trainer.model_config),
        'n_devices': 1,
        'device_kind': (torch.cuda.get_device_name(dev)
                        if dev.type == 'cuda' else 'cpu'),
        'global_batch_size': config.global_batch_size,
        'seq_len': config.seq_len,
        'history': trainer.history,
    })
    if dev.type == 'cuda':
        metrics['peak_memory_bytes'] = torch.cuda.max_memory_allocated(dev)
    if args.json_metrics:
        print('SKYTPU_METRICS ' + json.dumps(metrics), flush=True)
    return metrics


if __name__ == '__main__':
    main()

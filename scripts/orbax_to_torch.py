#!/usr/bin/env python3
"""Convert a checkpoint of the JAX trainer (Orbax, a local directory)
into the port's format (skypilot_tpu_torch/train/checkpoint.py).

    python scripts/orbax_to_torch.py --src ORBAX_DIR --dst PORT_DIR \\
        --model llama3-8b [--model-overrides JSON] [--src-step N] \\
        [--params-only [--step N]]

Reads one step of the source (the latest unless --src-step) in the
reference's split layout (Composite items params / opt_state / step),
passes its params through `skypilot_tpu_torch.bridge.params_from_jax`
(any ported family: llama, qwen, gpt2, Mixtral, gemma; scanned or
unscanned layers, LoRA adapters; --model and --model-overrides name the
config, as for the trainer) and writes the port's checkpoint under
--dst:

  - by default a resumable checkpoint at the saved step: params, the
    step, and the AdamW state (its count, and its first and second
    moments mu and nu, which have the params' layout and go through the
    same bridge; under the reference's `train_only` the frozen
    parameters have no moments, and neither do they in the port);
  - with --params-only the params alone, at --step (default 0): the
    weights to serve (`python -m skypilot_tpu_torch.infer.server
    --checkpoint-dir PORT_DIR`) or a base model to finetune from (the
    port's trainer restores it through `restore_params_partial`).

Orbax and JAX are imported here only: the port's package never imports
them.  The source's legacy single-'state' layout is not read.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from skypilot_tpu_torch import bridge  # noqa: E402
from skypilot_tpu_torch import models as models_lib  # noqa: E402
from skypilot_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402


def _numpy(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def _adam_state(tree: Any) -> Optional[Mapping[str, Any]]:
    """The {'count', 'mu', 'nu'} node of an optax state tree (inside
    chain, multi_transform and masked wrappers), or None."""
    if isinstance(tree, Mapping):
        if {'count', 'mu', 'nu'} <= set(tree):
            return tree
        children = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        children = list(tree)
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def _filled(tree: Any, like: Any, fill) -> Any:
    """`like`'s structure with `fill(tree leaf, like leaf)` at each leaf;
    a missing or None subtree of `tree` gives None leaves."""
    if isinstance(like, Mapping):
        return {k: _filled(tree.get(k) if isinstance(tree, Mapping)
                           else None, v, fill) for k, v in like.items()}
    return fill(tree, like)


def _moments(adam: Mapping[str, Any], params: Any,
             cfg: Any) -> Dict[str, Any]:
    """The port's opt_state item from the reference's Adam node: mu and
    nu of the parameters that have moments (the trainable ones)."""
    has = bridge.params_from_jax(_filled(
        adam['mu'], params,
        lambda m, p: np.full(p.shape, m is not None, np.float32)), cfg)
    keep = {k for k, t in has.items() if bool(t.all())}
    out: Dict[str, Any] = {'count': torch.tensor(int(adam['count']))}
    for name in ('mu', 'nu'):
        full = bridge.params_from_jax(_filled(
            adam[name], params,
            lambda m, p: np.zeros(p.shape, p.dtype) if m is None else m),
            cfg)
        out[name] = {k: t for k, t in full.items() if k in keep}
    return out


def convert(src: str, dst: str, *, model: str,
            model_overrides: Optional[Dict[str, Any]] = None,
            src_step: Optional[int] = None, params_only: bool = False,
            step: int = 0) -> int:
    """Write the port's checkpoint of `src` under `dst`; returns the
    step written."""
    import orbax.checkpoint as ocp
    manager = ocp.CheckpointManager(
        os.path.abspath(src),
        item_handlers={'params': ocp.StandardCheckpointHandler(),
                       'opt_state': ocp.StandardCheckpointHandler(),
                       'step': ocp.ArrayCheckpointHandler()})
    saved = src_step if src_step is not None else manager.latest_step()
    if saved is None:
        raise FileNotFoundError(f'no checkpoint step under {src!r}')
    items = {'params': ocp.args.StandardRestore()}
    if not params_only:
        items['opt_state'] = ocp.args.StandardRestore()
    restored = manager.restore(saved, args=ocp.args.Composite(**items))
    manager.close()
    cfg = models_lib.get_config(model, **(model_overrides or {}))
    params_np = _numpy(restored['params'])
    params = bridge.params_from_jax(params_np, cfg)
    out = ckpt_lib.make_manager(dst)
    if params_only:
        return ckpt_lib.save_params(out, params, step=step)
    adam = _adam_state(_numpy(restored['opt_state']))
    if adam is None:
        raise ValueError(f'no Adam state (count, mu, nu) in the opt_state '
                         f'of step {saved}: convert with --params-only')
    opt = _moments(adam, params_np, cfg)
    if int(opt['count']) != saved:
        raise ValueError(f'the optimizer count {int(opt["count"])} is not '
                         f'the saved step {saved}')
    out.save(saved, {ckpt_lib.PARAMS: params, ckpt_lib.OPT_STATE: opt,
                     ckpt_lib.STEP: torch.tensor(saved)})
    return saved


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--src', required=True,
                        help='The Orbax checkpoint directory.')
    parser.add_argument('--dst', required=True,
                        help="The port's checkpoint directory.")
    parser.add_argument('--model', default='llama-tiny')
    parser.add_argument('--model-overrides', default=None,
                        help='JSON dict of model-config overrides (the '
                             'trainer\'s, e.g. \'{"lora_rank": 16}\').')
    parser.add_argument('--src-step', type=int, default=None)
    parser.add_argument('--params-only', action='store_true',
                        help='Write the params alone (serving, or a base '
                             'to finetune from).')
    parser.add_argument('--step', type=int, default=0,
                        help='The step of a --params-only checkpoint.')
    args = parser.parse_args(argv)
    overrides = json.loads(args.model_overrides) if args.model_overrides \
        else {}
    step = convert(args.src, args.dst, model=args.model,
                   model_overrides=overrides, src_step=args.src_step,
                   params_only=args.params_only, step=args.step)
    print(f'wrote step {step} under {os.path.abspath(args.dst)}')
    return step


if __name__ == '__main__':
    main()

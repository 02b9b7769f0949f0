"""Checkpoints of the port's trainer: save, resume, base-into-LoRA
restore, and the params-only load for serving.

Port of skypilot_tpu/train/checkpoint.py in the port's own on-disk
format, written with torch (the reference writes Orbax;
`scripts/orbax_to_torch.py` converts its checkpoints).  As the
reference's Composite, a step holds three separate items:

    <directory>/<step>/params.pt      the model's state_dict
    <directory>/<step>/opt_state.pt   {'count', 'mu', 'nu'}: AdamW's
                                      moments of the trainable parameters
    <directory>/<step>/step.pt        the step, a 0-d int64 tensor

so a base checkpoint's params load into another live tree (a LoRA
finetune from pretrained weights) without its optimizer state.  A
params-only checkpoint (`save_params`: a converted base model, or
weights for serving) holds `params.pt` alone.  A step is written into
`<directory>/.tmp-<step>` and renamed to `<step>` once every item is on
disk, so a step directory is whole or absent; the manager keeps the
newest `max_to_keep` steps and `latest_step()` reads the directory.
Items load with `torch.load(weights_only=True)`, memory-mapped, so a
params-only read touches no optimizer bytes.

Divergence by design: saves are synchronous.  `save(..., wait=...)`
takes the reference's argument and always returns once the step is on
disk, where the reference's Orbax saves run in the background.
"""
from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional

import torch

logger = logging.getLogger(__name__)

PARAMS, OPT_STATE, STEP = 'params', 'opt_state', 'step'


class CheckpointManager:
    """Step directories under `directory`, the newest `max_to_keep`
    kept."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.max_to_keep = max_to_keep

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int, item: str) -> str:
        return os.path.join(self.directory, str(step), item + '.pt')

    def save(self, step: int, items: Mapping[str, Any]) -> bool:
        """Write `items` ({item name: object of tensors}) as step `step`;
        False (and nothing written) when that step exists already, as an
        Orbax manager skips a step it has saved."""
        if step in self.all_steps():
            return False
        tmp = os.path.join(self.directory, f'.tmp-{step}')
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name, obj in items.items():
            torch.save(obj, os.path.join(tmp, name + '.pt'))
        os.rename(tmp, os.path.join(self.directory, str(step)))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def load(self, step: int, item: str,
             map_location: Any = 'cpu') -> Any:
        path = self._path(step, item)
        if not os.path.isfile(path):
            raise FileNotFoundError(f'checkpoint step {step} under '
                                    f'{self.directory!r} has no {item!r}')
        return torch.load(path, map_location=map_location,
                          weights_only=True, mmap=True)


def make_manager(directory: str, *,
                 max_to_keep: int = 3) -> CheckpointManager:
    """A manager over `directory` keeping the newest `max_to_keep`
    steps (the save interval is the trainer's `checkpoint_every`)."""
    return CheckpointManager(directory, max_to_keep=max_to_keep)


def save(manager: CheckpointManager, trainer: Any, *,
         wait: bool = False) -> int:
    """Save the trainer's params, optimizer state and step; returns the
    step.  Synchronous whatever `wait` says (module docstring)."""
    del wait
    step = trainer.step_count
    opt = trainer.opt_state
    manager.save(step, {
        PARAMS: trainer.model.state_dict(),
        OPT_STATE: {'count': torch.tensor(opt.count), 'mu': opt.mu,
                    'nu': opt.nu},
        STEP: torch.tensor(step)})
    logger.info(f'Checkpoint step {step} saved.')
    return step


def save_params(manager: CheckpointManager,
                params: Mapping[str, torch.Tensor], step: int = 0) -> int:
    """A params-only checkpoint at `step`: a base model to finetune from
    (`restore_params_partial`) or weights to serve."""
    manager.save(step, {PARAMS: dict(params)})
    return step


def _mismatches(saved: Mapping[str, torch.Tensor],
                live: Mapping[str, torch.Tensor], what: str) -> List[str]:
    out = [f'{what} {k!r} missing from the checkpoint'
           for k in live if k not in saved]
    out += [f'{what} {k!r} not in the live tree' for k in saved
            if k not in live]
    out += [f'{what} {k!r}: saved {tuple(v.shape)} {v.dtype}, live '
            f'{tuple(live[k].shape)} {live[k].dtype}'
            for k, v in saved.items() if k in live and (
                v.shape != live[k].shape or v.dtype != live[k].dtype)]
    return out


@torch.no_grad()
def _copy_into(live: Mapping[str, torch.Tensor],
               saved: Mapping[str, torch.Tensor]) -> None:
    for k, t in saved.items():
        live[k].copy_(t)


def restore(manager: CheckpointManager, trainer: Any) -> Optional[int]:
    """Exact restore of the latest step into the trainer's live model and
    optimizer state (after `init_state`): the same parameter names,
    shapes and dtypes, and moments for exactly the trainable parameters.
    Returns the step, None when there is no checkpoint; raises on any
    mismatch: a broken resume must be loud, not a silent restart."""
    latest = manager.latest_step()
    if latest is None:
        return None
    params = manager.load(latest, PARAMS)
    opt = manager.load(latest, OPT_STATE)
    step = int(manager.load(latest, STEP))
    live = trainer.model.state_dict()
    trainable = trainer.trainable_params()
    bad = _mismatches(params, live, 'param')
    for moment in ('mu', 'nu'):
        bad += _mismatches(opt[moment], trainer.opt_state.mu,
                           f'opt_state.{moment}')
    if set(trainer.opt_state.mu) != set(trainable):
        bad.append('the live optimizer state does not cover the trainable '
                   'parameters')
    if int(opt['count']) != step:
        bad.append(f'optimizer count {int(opt["count"])} != step {step}')
    if bad:
        raise ValueError(f'checkpoint step {latest} under '
                         f'{manager.directory!r} does not match the live '
                         f'tree ({len(bad)} mismatches): {bad[:5]}')
    _copy_into(live, params)
    _copy_into(trainer.opt_state.mu, opt['mu'])
    _copy_into(trainer.opt_state.nu, opt['nu'])
    trainer.opt_state.count = step
    logger.info(f'Restored checkpoint step {latest}.')
    return step


def restore_params_partial(manager: CheckpointManager,
                           trainer: Any) -> Optional[int]:
    """Base weights into a different live tree: every saved parameter
    whose name and shape match a live one is loaded (cast to the live
    dtype); the rest (fresh LoRA adapters) keep their init.  The
    optimizer state is rebuilt and the step is 0: a finetune start, not
    a resume.  Returns 0, None when there is no checkpoint."""
    latest = manager.latest_step()
    if latest is None:
        return None
    saved = manager.load(latest, PARAMS)
    live = trainer.model.state_dict()
    match = {k: v for k, v in saved.items()
             if k in live and v.shape == live[k].shape}
    _copy_into(live, match)
    kept = [k for k in live if k not in match]
    trainer.reset_optimizer()
    logger.info(f'Partial restore from step {latest}: {len(match)} params '
                f'loaded, {len(kept)} kept from init (e.g. {kept[:3]}); '
                'optimizer state reset, step reset to 0.')
    return 0


def restore_or_init(manager: CheckpointManager, trainer: Any) -> int:
    """Preemption-transparent init: `init_state`, then the latest
    checkpoint restored exactly if there is one.  Only a frozen-base
    finetune (`train_only` set) falls back to the params-only partial
    restore when the exact restore finds another tree (a base checkpoint
    opened with a LoRA config, or a params-only one); any other failed
    restore raises, since restarting at step 0 would then overwrite the
    real checkpoints.  Returns the trainer's step."""
    trainer.init_state()
    try:
        restore(manager, trainer)
    except (ValueError, KeyError, FileNotFoundError) as e:
        if manager.latest_step() is None or \
                not getattr(trainer.config, 'train_only', None):
            raise
        logger.info(f'Exact restore failed ({type(e).__name__}: {e}) and '
                    'train_only is set: params-only partial restore of '
                    'the base checkpoint.')
        restore_params_partial(manager, trainer)
    return trainer.step_count


def load_params_for_serving(manager: CheckpointManager,
                            step: Optional[int] = None
                            ) -> Dict[str, torch.Tensor]:
    """The params item alone (CPU tensors, memory-mapped) of `step`, or
    of the latest step: the optimizer state is never read."""
    latest = step if step is not None else manager.latest_step()
    if latest is None:
        raise FileNotFoundError(
            f'no checkpoint step found under {manager.directory!r}')
    return dict(manager.load(latest, PARAMS))

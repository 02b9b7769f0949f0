"""The training loop on one device: init -> train_step -> metrics.

Port of skypilot_tpu/train/trainer.py for one card.  The step is the
reference's: next-token cross entropy in f32 with masking, a bf16
forward and backward over f32 parameters (blocks rerun in the backward
pass), gradient accumulation over microbatches, then
optax.chain(clip_by_global_norm, adamw) with the warmup-cosine schedule,
reproduced in PyTorch and applied in place.

This slice trains on one device without LoRA or a chunked loss.  Every
config field of the reference that would need more raises a ValueError
that names the ROADMAP.md item it waits for, rather than being ignored.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch import models as models_lib

_AXES = ('data', 'fsdp', 'expert', 'pipe', 'context', 'tensor')


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The reference's mesh degrees (parallel/mesh.py); -1 absorbs the
    remaining devices.  One device here: every axis must come to 1."""
    data: int = 1
    fsdp: int = -1
    expert: int = 1
    pipe: int = 1
    context: int = 1
    tensor: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: str = 'llama-tiny'
    global_batch_size: int = 8
    seq_len: int = 512
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    grad_accum_steps: int = 1
    pipeline_microbatches: Optional[int] = None
    pipeline_circular_repeats: int = 1
    mesh: MeshConfig = MeshConfig()
    model_overrides: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    train_only: Optional[str] = None
    compilation_cache_dir: Optional[str] = None
    loss_chunk: int = 0
    seed: int = 0


def check_supported(config: TrainConfig) -> None:
    """Raise for every setting this slice does not port."""
    big = [a for a in _AXES if getattr(config.mesh, a) > 1]
    if big:
        raise ValueError(f'mesh axes {big} > 1: multi-device training is not '
                         "ported yet (ROADMAP.md queue 1: 'Parallelism')")
    if (config.pipeline_microbatches is not None
            or config.pipeline_circular_repeats != 1):
        raise ValueError('pipeline settings: pipeline parallelism is not '
                         "ported yet (ROADMAP.md queue 1: 'Parallelism')")
    if config.train_only is not None:
        raise ValueError("train_only: freezing params (LoRA finetuning) is "
                         "not ported yet (ROADMAP.md queue 1: 'Training, "
                         "the rest')")
    if config.loss_chunk > 0:
        raise ValueError("loss_chunk > 0: the chunked cross entropy is not "
                         "ported yet (ROADMAP.md queue 1: 'Training, the "
                         "rest')")
    if config.model_overrides.get('lora_rank', 0) > 0:
        raise ValueError("lora_rank > 0: LoRA adapters are not ported yet "
                         "(ROADMAP.md queue 1: 'Training, the rest')")
    if config.compilation_cache_dir is not None:
        raise ValueError("compilation_cache_dir: the port compiles nothing "
                         "per run; a persistent cache of built kernels "
                         "comes with 'Checkpoint and launch' (ROADMAP.md "
                         "queue 1)")
    if config.grad_accum_steps < 1 or \
            config.global_batch_size % config.grad_accum_steps:
        raise ValueError(f'grad_accum_steps ({config.grad_accum_steps}) '
                         f'must divide global_batch_size '
                         f'({config.global_batch_size})')


# ---------------------------------------------------------------------------
# optimizer: optax.chain(clip_by_global_norm, adamw(warmup_cosine))
# ---------------------------------------------------------------------------
def warmup_cosine_decay(count: int, *, init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float) -> float:
    """optax.warmup_cosine_decay_schedule at `count`: linear from
    init_value to peak_value over warmup_steps, then cosine to end_value
    at decay_steps."""
    if count < warmup_steps:
        frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
        return (init_value - peak_value) * frac + peak_value
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    steps = decay_steps - warmup_steps
    c = min(count - warmup_steps, steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / steps))
    return peak_value * ((1.0 - alpha) * cosine + alpha)


@dataclasses.dataclass
class OptState:
    count: int                      # updates applied so far
    mu: Dict[str, torch.Tensor]     # first moments
    nu: Dict[str, torch.Tensor]     # second moments


class AdamW:
    """Global-norm clipping, then decoupled AdamW, as
    optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, b1, b2,
    eps, weight_decay)): weight decay on every parameter, the learning
    rate of update n (from 1) is schedule(n - 1), so the first update of
    a warmup from 0 moves nothing.  Updates parameters in place."""

    def __init__(self, schedule, *, clip_norm: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        zeros = lambda: {k: torch.zeros_like(p, memory_format=torch.
                                             contiguous_format)
                         for k, p in params.items()}
        return OptState(0, zeros(), zeros())

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: OptState,
               norm: Optional[torch.Tensor] = None) -> None:
        """One update; `norm` is the gradients' global norm when the
        caller has it already."""
        norm = global_norm(grads) if norm is None else norm
        state.count += 1
        lr = self.schedule(state.count - 1)
        bc1 = 1.0 - self.b1 ** state.count
        bc2 = 1.0 - self.b2 ** state.count
        for name, p in params.items():
            # Clipped one tensor at a time: no second copy of every grad.
            g = clip_to_global_norm(grads[name], norm, self.clip_norm)
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (mu / bc1) / ((nu / bc2).sqrt_() + self.eps)
            upd.add_(p, alpha=self.weight_decay)
            p.add_(upd, alpha=-lr)


def global_norm(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm),
    as a 0-d f32 tensor on the tensors' device (no host sync)."""
    return torch.sqrt(sum(t.float().square().sum()
                          for t in tensors.values()))


def clip_to_global_norm(g: torch.Tensor, norm: torch.Tensor,
                        max_norm: float) -> torch.Tensor:
    """One tensor of optax.clip_by_global_norm, given the global `norm`:
    unchanged while norm < max_norm, else (g / norm) * max_norm; no
    epsilon."""
    return torch.where(norm < max_norm, g, (g / norm) * max_norm)


def make_optimizer(config: TrainConfig) -> AdamW:
    peak = config.learning_rate

    def schedule(count: int) -> float:
        return warmup_cosine_decay(
            count, init_value=0.0, peak_value=peak,
            warmup_steps=config.warmup_steps,
            decay_steps=max(config.total_steps, config.warmup_steps + 1),
            end_value=peak * 0.1)

    return AdamW(schedule, clip_norm=config.grad_clip_norm, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=config.weight_decay)


# ---------------------------------------------------------------------------
# loss and step
# ---------------------------------------------------------------------------
def loss_fn(model, batch: Dict[str, torch.Tensor], *, kernel: str = 'auto'
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked mean next-token cross entropy of f32 logits, and the
    masked accuracy (the reference's `loss_fn`)."""
    logits = model.train_forward(batch['inputs'], kernel=kernel).float()
    targets = batch['targets'].long()
    mask = batch['mask'].float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1),
                         reduction='none').reshape(mask.shape)
    total = mask.sum().clamp_min(1.0)
    loss = (ce * mask).sum() / total
    correct = ((logits.argmax(-1) == targets) * mask).sum()
    return loss, {'loss': loss.detach(), 'accuracy': correct / total,
                  'tokens': total}


def compute_grads(model, batch: Dict[str, torch.Tensor], *,
                  grad_accum_steps: int = 1, kernel: str = 'auto'
                  ) -> Dict[str, torch.Tensor]:
    """Leave the mean gradient over `grad_accum_steps` equal microbatches
    in each parameter's `.grad`; return the mean metrics."""
    model.zero_grad(set_to_none=True)
    n = grad_accum_steps
    metrics: Dict[str, torch.Tensor] = {}
    for i in range(n):
        micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                 for k, v in batch.items()}
        loss, m = loss_fn(model, micro, kernel=kernel)
        (loss / n if n > 1 else loss).backward()
        for k, val in m.items():
            metrics[k] = metrics.get(k, 0.0) + val.detach() / n
    return metrics


def train_step(model, optimizer: AdamW, opt_state: OptState,
               batch: Dict[str, torch.Tensor], *, grad_accum_steps: int = 1,
               kernel: str = 'auto') -> Dict[str, torch.Tensor]:
    """One optimizer step in place; metrics as 0-d tensors, grad_norm
    the global norm of the unclipped gradient."""
    metrics = compute_grads(model, batch, grad_accum_steps=grad_accum_steps,
                            kernel=kernel)
    params = {k: p for k, p in model.named_parameters() if p.requires_grad}
    grads = {k: p.grad for k, p in params.items()}
    metrics['grad_norm'] = global_norm(grads)
    optimizer.update(params, grads, opt_state, norm=metrics['grad_norm'])
    model.zero_grad(set_to_none=True)
    return metrics


class Trainer:
    """Owns the model, the optimizer state and the step, on one device."""

    def __init__(self, config: TrainConfig, device: DeviceLike = 'cuda'):
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        overrides = dict(config.model_overrides)
        overrides.pop('lora_rank', None)
        self.model_config = models_lib.get_config(config.model, **overrides)
        self.optimizer = make_optimizer(config)
        self.model = None
        self.opt_state: Optional[OptState] = None
        self.history: List[Dict[str, float]] = []

    @property
    def step_count(self) -> int:
        return self.opt_state.count if self.opt_state is not None else 0

    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> None:
        """Random weights from `config.seed`, or `params` (a state_dict,
        e.g. `bridge.params_from_jax` of the reference's params)."""
        from skypilot_tpu_torch.models import llama
        model = llama.Llama(self.model_config, self.device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.config.seed)
            model.init_weights(gen)
        else:
            model.load_state_dict(params)
        model.requires_grad_(True)
        self.model = model
        self.opt_state = self.optimizer.init(dict(model.named_parameters()))

    def step(self, batch: Dict[str, torch.Tensor], *,
             kernel: str = 'auto') -> Dict[str, torch.Tensor]:
        if self.model is None:
            raise RuntimeError('call init_state() first')
        return train_step(self.model, self.optimizer, self.opt_state, batch,
                          grad_accum_steps=self.config.grad_accum_steps,
                          kernel=kernel)

    def train(self, data_iter: Iterator[Dict[str, torch.Tensor]],
              num_steps: Optional[int] = None,
              log_every: int = 10) -> Dict[str, float]:
        """Run `num_steps` steps (default total_steps); every `log_every`
        steps and at the end, record loss, accuracy, grad_norm and
        tokens/s of the window in `history` and print them.  Returns the
        last record."""
        cfg = self.config
        if self.model is None:
            self.init_state()
        steps = num_steps if num_steps is not None else cfg.total_steps
        tokens_per_step = cfg.global_batch_size * cfg.seq_len
        t0 = time.perf_counter()
        window_steps = 0
        last: Dict[str, float] = {}
        for i in range(steps):
            metrics = self.step(next(data_iter))
            window_steps += 1
            if (i + 1) % log_every == 0 or i + 1 == steps:
                values = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                last = {
                    'step': self.step_count,
                    'loss': values['loss'],
                    'accuracy': values['accuracy'],
                    'grad_norm': values['grad_norm'],
                    'tokens_per_sec': (window_steps * tokens_per_step / dt
                                       if dt > 0 else 0.0),
                    'step_ms': dt / window_steps * 1e3,
                }
                self.history.append(last)
                print(f'step {last["step"]} loss {last["loss"]:.4f} acc '
                      f'{last["accuracy"]:.3f} grad_norm '
                      f'{last["grad_norm"]:.4f} '
                      f'{last["tokens_per_sec"]:,.0f} tok/s', flush=True)
                t0 = time.perf_counter()
                window_steps = 0
        return last

"""The training loop on one device: init -> train_step -> metrics.

Port of skypilot_tpu/train/trainer.py for one card.  The step is the
reference's: next-token cross entropy in f32 with masking, a bf16
forward and backward over f32 parameters (blocks rerun in the backward
pass), gradient accumulation over microbatches, then
optax.chain(clip_by_global_norm, adamw) with the warmup-cosine schedule,
reproduced in PyTorch and applied in place.  The model is the
config's family's (models/__init__.py `build`); a routed family's aux
loss (Mixtral's router load balance) is added to the loss and reported
as `aux_loss`, 0 for the others, as the reference's `loss_fn` does.

`train_only` freezes every parameter whose name has no dotted part
containing the substring (the reference's `_trainable_mask`; 'lora'
trains only the adapters): frozen parameters do not require grad, so
no weight-gradient GEMM runs for them (the reference's stop_gradient),
get no update, no weight decay and no AdamW moments (its
multi_transform with set_to_zero), and the grad norm and its clipping
cover the trainable parameters alone.  `loss_chunk` > 0 applies the f32
head per chunk of the sequence under activation checkpointing
(`loss_fn_chunked`), so at most [B, chunk, V] f32 logits are live.  The
head is the model's own (`model.head`): a tied head reads tok_embed, and
gemma's softcaps each chunk's f32 logits, cap * tanh(logits / cap), as
the reference's `_chunked_ce_sums` does.
`Trainer.train` saves checkpoints (train/checkpoint.py) every
`checkpoint_every` steps.

This slice trains on one device.  Every config field of the reference
that would need more raises a ValueError that names the ROADMAP.md item
it waits for, rather than being ignored.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as checkpoint_lib

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
    if config.loss_chunk and config.seq_len % config.loss_chunk:
        raise ValueError(f'loss_chunk={config.loss_chunk} must divide '
                         f'seq_len={config.seq_len}.')


def trainable_mask(names, needle: str) -> Dict[str, bool]:
    """True exactly for the names one of whose dotted parts contains
    `needle` (the reference's `_trainable_mask` over flax paths: the
    port's names are its paths, `layers.0.attention.q_proj_lora.a`)."""
    return {n: any(needle in part for part in n.split('.')) for n in names}


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
    eps, weight_decay)) over the parameters it is given (the trainable
    ones): weight decay on each of them, the learning
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
    """Masked mean next-token cross entropy of f32 logits plus the
    model's router aux loss (0 without a router), and the masked
    accuracy (the reference's `loss_fn`; its 'loss' metric is the cross
    entropy alone, 'aux_loss' the rest)."""
    logits, aux = model.train_forward(batch['inputs'], kernel=kernel,
                                      return_aux=True)
    logits = logits.float()
    targets = batch['targets'].long()
    mask = batch['mask'].float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1),
                         reduction='none').reshape(mask.shape)
    total = mask.sum().clamp_min(1.0)
    ce_loss = (ce * mask).sum() / total
    correct = ((logits.argmax(-1) == targets) * mask).sum()
    return ce_loss + aux, {'loss': ce_loss.detach(),
                           'accuracy': correct / total, 'tokens': total,
                           'aux_loss': aux.detach()}


def _chunk_sums(head, hidden: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked CE sum and correct-prediction sum of one sequence chunk."""
    logits = head(hidden)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1).long(),
                         reduction='none').reshape(mask.shape)
    correct = ((logits.argmax(-1) == targets) * mask).sum()
    return (ce * mask).sum(), correct


def chunked_ce_sums(head, hidden: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's `_chunked_ce_sums`: masked CE sum and correct sum
    of `head(hidden)` (f32 logits) taken one chunk of `chunk` positions
    at a time, in order, each chunk checkpointed under autograd, so at
    most [B, chunk, V] f32 logits are live in the forward and in the
    backward."""
    s = hidden.shape[1]
    if s % chunk:
        raise ValueError(f'loss_chunk={chunk} must divide seq_len={s}.')
    ce_sum = hidden.new_zeros((), dtype=torch.float32)
    correct = hidden.new_zeros((), dtype=torch.float32)
    remat = torch.is_grad_enabled()
    for i in range(0, s, chunk):
        args = (head, hidden[:, i:i + chunk], targets[:, i:i + chunk],
                mask[:, i:i + chunk])
        ce_c, correct_c = (checkpoint_lib.checkpoint(
            _chunk_sums, *args, use_reentrant=False) if remat
            else _chunk_sums(*args))
        ce_sum = ce_sum + ce_c
        correct = correct + correct_c
    return ce_sum, correct


def loss_fn_chunked(model, batch: Dict[str, torch.Tensor], *, chunk: int,
                    kernel: str = 'auto'
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`loss_fn` with the head applied chunk by chunk
    (`chunked_ce_sums`, over lm_head or a tied tok_embed): the same loss,
    accuracy and gradients."""
    hidden, aux = model.train_forward(batch['inputs'], kernel=kernel,
                                      return_hidden=True, return_aux=True)
    mask = batch['mask'].float()
    total = mask.sum().clamp_min(1.0)
    ce_sum, correct = chunked_ce_sums(model.head, hidden, batch['targets'],
                                      mask, chunk)
    ce_loss = ce_sum / total
    return ce_loss + aux, {'loss': ce_loss.detach(),
                           'accuracy': correct / total, 'tokens': total,
                           'aux_loss': aux.detach()}


def compute_grads(model, batch: Dict[str, torch.Tensor], *,
                  grad_accum_steps: int = 1, kernel: str = 'auto',
                  loss_chunk: int = 0) -> Dict[str, torch.Tensor]:
    """Leave the mean gradient over `grad_accum_steps` equal microbatches
    in the `.grad` of each parameter that requires grad; return the mean
    metrics.  `loss_chunk` > 0 takes `loss_fn_chunked`."""
    model.zero_grad(set_to_none=True)
    n = grad_accum_steps
    metrics: Dict[str, torch.Tensor] = {}
    for i in range(n):
        micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                 for k, v in batch.items()}
        if loss_chunk:
            loss, m = loss_fn_chunked(model, micro, chunk=loss_chunk,
                                      kernel=kernel)
        else:
            loss, m = loss_fn(model, micro, kernel=kernel)
        (loss / n if n > 1 else loss).backward()
        for k, val in m.items():
            metrics[k] = metrics.get(k, 0.0) + val.detach() / n
    return metrics


def train_step(model, optimizer: AdamW, opt_state: OptState,
               batch: Dict[str, torch.Tensor], *, grad_accum_steps: int = 1,
               kernel: str = 'auto', loss_chunk: int = 0
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step in place over the parameters that require
    grad; metrics as 0-d tensors, grad_norm the global norm of their
    unclipped gradient."""
    metrics = compute_grads(model, batch, grad_accum_steps=grad_accum_steps,
                            kernel=kernel, loss_chunk=loss_chunk)
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
        self.model_config = models_lib.get_config(
            config.model, **config.model_overrides)
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
        e.g. `bridge.params_from_jax` of the reference's params); the
        parameters `train_only` selects (all without it) require grad,
        and the optimizer state covers them alone, at step 0.  The model
        is the config's family's (models/__init__.py `build`)."""
        model = models_lib.build(self.model_config, self.device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.config.seed)
            model.init_weights(gen)
        else:
            model.load_state_dict(params)
        needle = self.config.train_only
        if needle is None:
            model.requires_grad_(True)
        else:
            mask = trainable_mask(dict(model.named_parameters()), needle)
            if not any(mask.values()):
                raise ValueError(f'train_only={needle!r} matches no '
                                 'parameter: nothing would train')
            for name, p in model.named_parameters():
                p.requires_grad_(mask[name])
        self.model = model
        self.reset_optimizer()

    def trainable_params(self) -> Dict[str, torch.Tensor]:
        return {k: p for k, p in self.model.named_parameters()
                if p.requires_grad}

    def reset_optimizer(self) -> None:
        """Fresh optimizer state for the trainable parameters: step 0."""
        self.opt_state = self.optimizer.init(self.trainable_params())

    def step(self, batch: Dict[str, torch.Tensor], *,
             kernel: str = 'auto') -> Dict[str, torch.Tensor]:
        if self.model is None:
            raise RuntimeError('call init_state() first')
        return train_step(self.model, self.optimizer, self.opt_state, batch,
                          grad_accum_steps=self.config.grad_accum_steps,
                          kernel=kernel, loss_chunk=self.config.loss_chunk)

    def train(self, data_iter: Iterator[Dict[str, torch.Tensor]],
              num_steps: Optional[int] = None,
              log_every: int = 10, checkpoint_manager: Any = None,
              checkpoint_every: int = 0) -> Dict[str, float]:
        """Run `num_steps` steps (default total_steps); every `log_every`
        steps and at the end, record loss, accuracy, grad_norm and
        tokens/s of the window in `history` and print them; with a
        `checkpoint_manager` (train/checkpoint.py), save a checkpoint
        after every `checkpoint_every` steps.  Returns the last record."""
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
                    'aux_loss': values['aux_loss'],
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
            if checkpoint_manager is not None and checkpoint_every and \
                    (i + 1) % checkpoint_every == 0:
                from skypilot_tpu_torch.train import checkpoint as ckpt_lib
                ckpt_lib.save(checkpoint_manager, self)
        return last

"""Optimizer and LR schedule of the reference training recipe (counterpart
of maa3_tpu/train/optim.py).

- LambdaLinearScheduler (ldm/lr_scheduler.py:41-77), single cycle: linear
  warm-up from f_start to f_max over warm_up_steps, then linear decay toward
  f_min over cycle_length (the configs make it constant after warm-up);
- `Optimizer`: optax.chain(clip_by_global_norm(c), adamw(schedule)) —
  gradients scaled by min(1, c / ||g||) over all parameters together (no
  epsilon, unlike torch.nn.utils.clip_grad_norm_), then AdamW with
  betas 0.9 / 0.999, eps 1e-8 and decoupled weight decay, the LR of update n
  being schedule(n) (base * f_start for the first);
- `ema_update`: LitEma's warm-up decay min(decay, (1 + n) / (10 + n)).
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch

Schedule = Callable[[int], float]


def lambda_linear_schedule(base_lr: float, warm_up_steps: int = 10000,
                           f_start: float = 1e-6, f_max: float = 1.0,
                           f_min: float = 1.0, cycle_length: float = 1e13) -> Schedule:
    def schedule(step: int) -> float:
        if step < warm_up_steps:
            f = f_start + (f_max - f_start) * step / max(warm_up_steps, 1)
        else:
            f = f_min + (f_max - f_min) * (cycle_length - (step - warm_up_steps)) / cycle_length
        return base_lr * f

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (a 0-d tensor)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


class Optimizer:
    """Global-norm clip, then AdamW at the scheduled LR, over `params`."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule,
                 grad_clip: float = 1.0, weight_decay: float = 1e-2):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, count: int) -> torch.Tensor:
        """Apply update number `count` from the parameters' .grad (clipped
        in place); returns the norm of the gradients before clipping."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        # on the device, without a host sync; a factor of exactly 1 below the clip
        torch._foreach_mul_(grads, (self.grad_clip / norm).clamp(max=1.0))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(count)
        self.adamw.step()
        return norm


def make_optimizer(params: Iterable[torch.nn.Parameter], base_lr: float = 3.0e-6,
                   lr_multiplier: float = 16.0, warm_up_steps: int = 10000,
                   grad_clip: float = 1.0, weight_decay: float = 1e-2) -> Optimizer:
    """lr_multiplier mirrors accumulate_grad_batches * ngpu * batch_size
    (main.py:786-790)."""
    return Optimizer(params, lambda_linear_schedule(base_lr * lr_multiplier,
                                                    warm_up_steps),
                     grad_clip, weight_decay)


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: Iterable[torch.Tensor],
               decay: float, step: int) -> None:
    """In place: e <- e * d + (1 - d) * p with d = min(decay, (1+n)/(10+n))."""
    d = min(decay, (1.0 + step) / (10.0 + step))
    for e, p in zip(ema, params):
        e.mul_(d).add_(p.detach(), alpha=1.0 - d)

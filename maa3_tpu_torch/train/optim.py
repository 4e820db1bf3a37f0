"""Optimizer and LR schedule of the reference training recipe (counterpart
of maa3_tpu/train/optim.py).

- LambdaLinearScheduler (ldm/lr_scheduler.py:41-77), single cycle: linear
  warm-up from f_start to f_max over warm_up_steps, then linear decay toward
  f_min over cycle_length (the configs make it constant after warm-up);
- `Optimizer`: optax.chain(clip_by_global_norm(c), adamw(schedule)) —
  gradients scaled by min(1, c / ||g||) over all parameters together (no
  epsilon, unlike torch.nn.utils.clip_grad_norm_), then AdamW with
  betas 0.9 / 0.999, eps 1e-8 and decoupled weight decay, the LR of update n
  being schedule(n) (base * f_start for the first). `mu_dtype` stores the
  first moment in that dtype: the new moment is computed in fp32 from the
  stored one and the update uses it before it is rounded for storage
  (optax's scale_by_adam). `factored` swaps AdamW for optax's adafactor
  chain as maa3_tpu/train/optim.py:63-71 configures it. `accum_steps` > 1
  wraps either in optax.MultiSteps: gradients averaged over k micro-steps,
  the clip applied to the average, parameters unchanged by the other
  micro-steps, and the schedule counting updates;
- `ema_update`: LitEma's warm-up decay min(decay, (1 + n) / (10 + n)).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]
BETAS, EPS = (0.9, 0.999), 1e-8
# adafactor as maa3_tpu/train/optim.py:63-71 calls it
FACTORED_DECAY, FACTORED_EPS, MOMENTUM = 0.999, 1e-30, 0.9


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


def factored_dims(shape, min_dim_size_to_factor: int = 128) -> Optional[Tuple[int, int]]:
    """optax's _factored_dims: (second largest, largest) axis when the second
    largest dimension reaches min_dim_size_to_factor, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Optimizer:
    """Global-norm clip, then AdamW (or adafactor) at the scheduled LR, over
    `params`, applied every `accum_steps` micro-steps.

    State (`state_dict`): `count` updates applied, `mini_step` micro-steps
    into the current accumulation and the running mean of their gradients
    (`acc`), and per parameter the AdamW moments `mu` (mu_dtype) and `nu`
    (fp32), or adafactor's second-moment factors `v_row` / `v_col` (or a
    full `v` where the shape is not factored) and its momentum `mu`."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule,
                 grad_clip: float = 1.0, weight_decay: float = 1e-2,
                 mu_dtype: torch.dtype = torch.float32, factored: bool = False,
                 accum_steps: int = 1, min_dim_size_to_factor: int = 128):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype
        self.factored = factored
        self.accum_steps = max(1, accum_steps)
        self.count = 0
        self.mini_step = 0
        self.last_lr: Optional[float] = None
        # the global norm of a list of gradients (train/loop.py replaces it
        # by the norm over every rank's shards)
        self.norm_fn: Callable[[List[torch.Tensor]], torch.Tensor] = global_norm
        ps = self.params
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in ps]
        self.acc = ([torch.zeros_like(p) for p in ps] if self.accum_steps > 1 else None)
        if factored:
            self.dims = [factored_dims(p.shape, min_dim_size_to_factor) for p in ps]
            self.v_row, self.v_col, self.v = [], [], []
            for p, d in zip(ps, self.dims):
                shape = list(p.shape)
                z = torch.zeros((1,), dtype=p.dtype, device=p.device)
                if d is None:  # optax keeps (1,) placeholders for the unused ones
                    self.v_row.append(z)
                    self.v_col.append(z.clone())
                    self.v.append(torch.zeros_like(p))
                else:
                    self.v_row.append(p.new_zeros(shape[:d[1]] + shape[d[1] + 1:]))
                    self.v_col.append(p.new_zeros(shape[:d[0]] + shape[d[0] + 1:]))
                    self.v.append(z)
        else:
            self.nu = [torch.zeros_like(p) for p in ps]

    @property
    def kind(self) -> dict:
        """What a checkpoint's state must match to be loaded here."""
        return {"kind": "adafactor" if self.factored else "adamw",
                "mu_dtype": str(self.mu_dtype).replace("torch.", ""),
                "accum_steps": self.accum_steps, "n_params": len(self.params)}

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Take one micro-step from the parameters' .grad; every accum_steps-th
        applies update number `count` from the mean of the micro-steps'
        gradients, clipped. Returns the norm of this micro-step's gradients
        (before any clip)."""
        grads = [p.grad for p in self.params]
        norm = self.norm_fn(grads)
        if self.acc is not None:  # optax.MultiSteps: a running mean (Welford)
            n = self.mini_step
            deltas = torch._foreach_sub(grads, self.acc)
            torch._foreach_add_(self.acc, deltas, alpha=1.0 / (n + 1))
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return norm
            grads = self.acc
            clip_norm = self.norm_fn(grads)
        else:
            clip_norm = norm
        # on the device, without a host sync; a factor of exactly 1 below the clip
        torch._foreach_mul_(grads, (self.grad_clip / clip_norm).clamp(max=1.0))
        self.last_lr = self.schedule(self.count)
        (self._adafactor if self.factored else self._adamw)(grads, self.last_lr)
        self.count += 1
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return norm

    def _momentum(self) -> List[torch.Tensor]:
        """The first moments in fp32 (the stored tensors themselves when they
        are fp32)."""
        return [m.float() for m in self.mu]

    def _store_momentum(self, mu32: List[torch.Tensor]) -> None:
        if self.mu_dtype != torch.float32:
            torch._foreach_copy_(self.mu, mu32)

    def _adamw(self, grads: List[torch.Tensor], lr: float) -> None:
        """optax.adamw: mu, nu <- EMAs of g, g^2; p <- p - lr (mu_hat /
        (sqrt(nu_hat) + eps) + wd p), as p (1 - lr wd) - lr / (1 - b1^t) mu /
        (sqrt(nu) / sqrt(1 - b2^t) + eps) in eight passes over the tensors."""
        b1, b2 = BETAS
        t = self.count + 1
        mu = self._momentum()
        torch._foreach_lerp_(mu, grads, 1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(self.nu)  # the one temporary list
        torch._foreach_div_(denom, math.sqrt(1.0 - b2 ** t))
        torch._foreach_add_(denom, EPS)
        torch._foreach_mul_(self.params, 1.0 - lr * self.weight_decay)
        torch._foreach_addcdiv_(self.params, mu, denom, value=-lr / (1.0 - b1 ** t))
        self._store_momentum(mu)

    def _adafactor(self, grads: List[torch.Tensor], lr: float) -> None:
        """optax.adafactor(lr, decay_rate=0.999, momentum=0.9, eps=1e-30,
        weight_decay_rate=wd, no clipping or parameter scale): the factored
        rms scaling with decay 1 - (t+1)^-0.999, then the LR, then the
        non-debiased momentum, then + wd p (after the LR: each update shrinks
        the parameters by wd whatever the LR)."""
        decay = 1.0 - (self.count + 1.0) ** -FACTORED_DECAY
        mu = self._momentum()
        for i, (p, g, d) in enumerate(zip(self.params, grads, self.dims)):
            gsq = g * g + FACTORED_EPS
            if d is None:
                self.v[i].mul_(decay).add_(gsq, alpha=1.0 - decay)
                u = g * self.v[i].pow(-0.5)
            else:
                d1, d0 = d
                vr, vc = self.v_row[i], self.v_col[i]
                vr.mul_(decay).add_(gsq.mean(dim=d0), alpha=1.0 - decay)
                vc.mul_(decay).add_(gsq.mean(dim=d1), alpha=1.0 - decay)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (vr / vr.mean(dim=reduced_d1, keepdim=True)).pow(-0.5)
                u = g * row_factor.unsqueeze(d0) * vc.pow(-0.5).unsqueeze(d1)
            mu[i].mul_(MOMENTUM).add_(u * lr, alpha=1.0 - MOMENTUM)
            p.sub_(mu[i] + self.weight_decay * p)
        self._store_momentum(mu)

    def state_dict(self) -> dict:
        state = {"count": self.count, "mini_step": self.mini_step, "mu": self.mu,
                 **self.kind}
        if self.acc is not None:
            state["acc"] = self.acc
        if self.factored:
            state.update(v_row=self.v_row, v_col=self.v_col, v=self.v)
        else:
            state["nu"] = self.nu
        return state

    def load_state_dict(self, state: dict) -> None:
        """Raises ValueError for the state of another kind of optimizer
        (AdamW / adafactor, first-moment dtype, accumulation, parameters)."""
        mine = self.kind
        theirs = {k: state.get(k) for k in mine}
        if theirs != mine:
            raise ValueError(f"optimizer state of {theirs}, this optimizer is {mine}")
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        names = ["mu"] + (["acc"] if self.acc is not None else []) + (
            ["v_row", "v_col", "v"] if self.factored else ["nu"])
        with torch.no_grad():
            for name in names:  # per tensor: the state may lie on another device
                for dst, src in zip(getattr(self, name), state[name], strict=True):
                    dst.copy_(src)


def make_optimizer(params: Iterable[torch.nn.Parameter], base_lr: float = 3.0e-6,
                   lr_multiplier: float = 16.0, warm_up_steps: int = 10000,
                   grad_clip: float = 1.0, weight_decay: float = 1e-2,
                   mu_dtype: torch.dtype = torch.float32, factored: bool = False,
                   accum_steps: int = 1, min_dim_size_to_factor: int = 128) -> Optimizer:
    """lr_multiplier mirrors accumulate_grad_batches * ngpu * batch_size
    (main.py:786-790)."""
    return Optimizer(params, lambda_linear_schedule(base_lr * lr_multiplier,
                                                    warm_up_steps),
                     grad_clip, weight_decay, mu_dtype, factored, accum_steps,
                     min_dim_size_to_factor)


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: Iterable[torch.Tensor],
               decay: float, step: int) -> None:
    """In place: e <- e * d + (1 - d) * p with d = min(decay, (1+n)/(10+n))."""
    d = min(decay, (1.0 + step) / (10.0 + step))
    for e, p in zip(ema, params):
        e.mul_(d).add_(p.detach(), alpha=1.0 - d)

"""The conditional flow-matching loss of Make-An-Audio 3 (cfm1_audio.py) and
the optimizer update of its recipe (global-norm clip, then AdamW), in
plain PyTorch."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

SIGMA_MIN = 1e-4
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-2


def posterior_sample(moments: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    mean, logvar = moments.chunk(2, dim=1)
    return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise


def cfm_rows(pred_fn, x1, t_int, x0, num_timesteps: int = 1000) -> torch.Tensor:
    """The per-row mean squared error of the velocity at
    x_t = t x1 + (1 - (1 - s) t) x0 against u = x1 - (1 - s) x0."""
    t = (t_int.float() / num_timesteps).reshape(-1, 1, 1)
    xt = t * x1 + (1.0 - (1.0 - SIGMA_MIN) * t) * x0
    ut = x1 - (1.0 - SIGMA_MIN) * x0
    return (pred_fn(xt, t_int) - ut).square().mean(dim=(1, 2))


@torch.no_grad()
def clip_adamw(params: List[torch.Tensor], state: Dict[str, list], lr: float,
               clip: float, count: int) -> None:
    """One update, in place: gradients scaled by min(1, clip / global norm),
    then AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled decay 1e-2), update
    number `count` (from 0)."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    factor = torch.clamp(clip / norm, max=1.0)
    b1, b2 = BETAS
    t = count + 1
    if not state:
        state["mu"] = [torch.zeros_like(p) for p in params]
        state["nu"] = [torch.zeros_like(p) for p in params]
    for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
        g = g * factor
        mu.mul_(b1).add_(g, alpha=1.0 - b1)
        nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
        denom = nu.sqrt() / math.sqrt(1.0 - b2 ** t) + EPS
        p.mul_(1.0 - lr * WEIGHT_DECAY)
        p.add_(mu / denom, alpha=-lr / (1.0 - b1 ** t))

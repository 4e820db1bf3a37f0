"""DDPM eps / x0-prediction training losses and the FiLM / concat
conditioning routes (counterpart of maa3_tpu/diffusion/ddpm_loss.py;
DDPM.p_losses, ldm/models/diffusion/ddpm.py:295-322, and the AudioLDM
FiLM variant, ldm/models/diffusion/audioldm.py:20):

- parameterization "eps" (default) or "x0"; l1 or l2;
- l_simple plus the l_vlb weighting (ELBO weights from the posterior
  variances);
- 'film' pools the context into a (B, D) vector that the backbone adds to
  its timestep embedding; 'concat' stacks channels.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from maa3_tpu_torch.diffusion.ddim import q_sample
from maa3_tpu_torch.diffusion.schedules import DDPMSchedule


def vlb_weights(schedule: DDPMSchedule) -> np.ndarray:
    """lvlb_weights (ddpm.py:160-170) for the eps parameterization."""
    betas = schedule.betas
    ac = schedule.alphas_cumprod
    with np.errstate(divide="ignore"):
        w = betas ** 2 / (2 * schedule.posterior_variance * (1 - betas) * (1 - ac))
    w[0] = w[1]  # the t=0 term is infinite; the reference overwrites it
    return w


def ddpm_loss(model_fn: Callable, schedule: DDPMSchedule, x_start: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              context: Optional[torch.Tensor] = None,
              parameterization: str = "eps", loss_type: str = "l2",
              l_simple_weight: float = 1.0, original_elbo_weight: float = 0.0,
              t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
    """t ~ U{0..T-1} and the noise (drawn from `generator` unless given),
    diffuse, regress eps (or x0). Returns (loss, dict)."""
    b, dev = x_start.shape[0], x_start.device
    if t is None:
        t = torch.randint(0, len(schedule.betas), (b,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=dev,
                            dtype=x_start.dtype)
    pred = model_fn(q_sample(schedule, x_start, t, noise), t, context)
    target = noise if parameterization == "eps" else x_start
    per_elem = (pred - target).abs() if loss_type == "l1" else (pred - target).square()
    per_sample = per_elem.reshape(b, -1).mean(-1)
    loss_simple = per_sample.mean()
    loss = l_simple_weight * loss_simple
    out = {"loss_simple": loss_simple}
    if original_elbo_weight > 0:
        w = torch.as_tensor(vlb_weights(schedule), dtype=torch.float32, device=dev)[t]
        loss_vlb = (w * per_sample).mean()
        loss = loss + original_elbo_weight * loss_vlb
        out["loss_vlb"] = loss_vlb
    out["loss"] = loss
    return loss, out


def film_pool(context: torch.Tensor) -> torch.Tensor:
    """'film' conditioning: the tokens' mean, (B, L, D) -> (B, D)
    (DiffusionWrapper c_film branch, ddpm.py:1429-1431); (B, D) passes."""
    return context.mean(dim=1) if context.dim() == 3 else context


def concat_condition(x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """'concat' conditioning: channel-stack (DiffusionWrapper c_concat)."""
    return torch.cat([x, cond], dim=1)

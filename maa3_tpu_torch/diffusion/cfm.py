"""Conditional flow matching: the training loss, and Euler ODE sampling
with and without classifier-free guidance (counterpart of
maa3_tpu/diffusion/cfm.py).

Loss (cfm1_audio.py:37-58): integer t in [0, 1000) for the model, t / 1000
for the interpolant x_t = t x1 + (1 - (1 - s) t) x0 with target
u_t = x1 - (1 - s) x0, s = sigma_min = 1e-4, and the MSE of the velocity.

t_span = linspace(0, 1, steps); the model sees floor(t * 1000); CFG runs the
dual batch [uncond; cond] and combines e_uc + scale * (e_c - e_uc)
(cfm1_audio.py:60-161). The time grid is built in fp32 exactly as
jnp.linspace builds it (iota * step, last point pinned to 1), so the step
sizes and integer timesteps match the JAX package bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

SIGMA_MIN = 1e-4


def cfm_interpolate(x1: torch.Tensor, x0: torch.Tensor, t01: torch.Tensor,
                    sigma_min: float = SIGMA_MIN):
    """(x_t, u_t) for t01 in [0, 1], one value per batch row."""
    t = t01.reshape((-1,) + (1,) * (x1.dim() - 1)).to(x1.dtype)
    return t * x1 + (1.0 - (1.0 - sigma_min) * t) * x0, x1 - (1.0 - sigma_min) * x0


def cfm_loss(velocity_fn: Callable, x1: torch.Tensor, context: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             num_timesteps: int = 1000, sigma_min: float = SIGMA_MIN,
             t_int: Optional[torch.Tensor] = None,
             x0: Optional[torch.Tensor] = None):
    """CFM training loss -> (loss, {"loss_simple": loss}). t_int (B,) and the
    noise x0 are drawn from `generator` unless given."""
    b = x1.shape[0]
    if t_int is None:
        t_int = torch.randint(0, num_timesteps, (b,), generator=generator,
                              device=x1.device)
    if x0 is None:
        x0 = torch.randn(x1.shape, generator=generator, device=x1.device,
                         dtype=x1.dtype)
    xt, ut = cfm_interpolate(x1, x0, t_int.float() / num_timesteps, sigma_min)
    pred = velocity_fn(xt, t_int, context)
    loss = (pred - ut).square().mean(dim=tuple(range(1, x1.dim()))).mean()
    return loss, {"loss_simple": loss}


def euler_t_grid(steps: int, t_start: Optional[int] = None) -> np.ndarray:
    """fp32 linspace(0, 1, steps)[t_start:]."""
    grid = np.arange(steps, dtype=np.float32)
    if steps > 1:
        grid = grid * (np.float32(1.0) / np.float32(steps - 1))
        grid[-1] = 1.0
    return grid[t_start:] if t_start is not None else grid


def planned_t_ints(steps: int, t_start: Optional[int] = None,
                   num_timesteps: int = 1000) -> np.ndarray:
    """Integer model timesteps for each Euler step of the grid."""
    grid = euler_t_grid(steps, t_start)
    return np.floor(grid[:-1] * np.float32(num_timesteps)).astype(np.int32)


def _pairs(steps: int, t_start: Optional[int]):
    grid = euler_t_grid(steps, t_start)
    return [(float(a), float(np.float32(b - a)))
            for a, b in zip(grid[:-1], grid[1:])]


def _t_int(t: float, b: int, num_timesteps: int, device) -> torch.Tensor:
    return torch.full((b,), int(np.floor(np.float32(t) * np.float32(num_timesteps))),
                      dtype=torch.int32, device=device)


def sample(velocity_fn: Callable, x0: torch.Tensor, context: torch.Tensor,
           steps: int = 25, t_start: Optional[int] = None,
           num_timesteps: int = 1000) -> torch.Tensor:
    """Euler ODE without guidance (CFM.sample, maa3_tpu/diffusion/cfm.py:72);
    velocity_fn(x, t_int, context) on the batch as given."""
    x = x0
    for t, dt in _pairs(steps, t_start):
        x = x + dt * velocity_fn(x, _t_int(t, x0.shape[0], num_timesteps, x0.device),
                                 context)
    return x


def sample_cfg(velocity_fn: Callable, x0: torch.Tensor, context: torch.Tensor,
               uncond_context: torch.Tensor, guidance_scale: float,
               steps: int = 25, t_start: Optional[int] = None,
               num_timesteps: int = 1000) -> torch.Tensor:
    """CFG Euler ODE; velocity_fn(x, t_int, context) on the dual batch."""
    b = x0.shape[0]
    ctx_in = torch.cat([uncond_context, context], dim=0)
    x = x0
    for t, dt in _pairs(steps, t_start):
        t_int = _t_int(t, 2 * b, num_timesteps, x0.device)
        e_uc, e_c = velocity_fn(torch.cat([x, x]), t_int, ctx_in).chunk(2)
        x = x + dt * (e_uc + guidance_scale * (e_c - e_uc))
    return x


def sample_cfg_planned(step_velocity_fn: Callable, x0: torch.Tensor,
                       n_steps_xs: int, guidance_scale: float, steps: int = 25,
                       t_start: Optional[int] = None) -> torch.Tensor:
    """CFG Euler ODE whose latent-independent per-step tensors were
    precomputed (models/dit.py::dit_sample_plan): step_velocity_fn(x_in, s)
    gets the dual batch and the step index s."""
    pairs = _pairs(steps, t_start)
    if len(pairs) != n_steps_xs:
        raise ValueError(f"the plan covers {n_steps_xs} steps, the grid {len(pairs)}")
    x = x0
    for s, (_, dt) in enumerate(pairs):
        e_uc, e_c = step_velocity_fn(torch.cat([x, x]), s).chunk(2)
        x = x + dt * (e_uc + guidance_scale * (e_c - e_uc))
    return x


def sample_cfg_inpaint(velocity_fn: Callable, x0: torch.Tensor, context: torch.Tensor,
                       uncond_context: torch.Tensor, guidance_scale: float,
                       known: torch.Tensor, keep_mask: torch.Tensor, steps: int = 25,
                       num_timesteps: int = 1000,
                       sigma_min: float = SIGMA_MIN) -> torch.Tensor:
    """Mask-guided CFG Euler ODE (maa3_tpu/diffusion/cfm.py:123): after every
    step the positions with keep_mask = 1 are set to the OT path toward the
    known latent, x_t = t known + (1 - (1 - s) t) x0, so only keep_mask = 0
    is synthesized. known: (B, C, T); keep_mask broadcasts to it."""
    b = x0.shape[0]
    ctx_in = torch.cat([uncond_context, context], dim=0)
    keep = keep_mask.to(x0.dtype)
    grid = euler_t_grid(steps)
    one, decay = np.float32(1.0), np.float32(1.0 - sigma_min)
    x = x0
    for t, t_next in zip(grid[:-1], grid[1:]):
        t_int = _t_int(float(t), 2 * b, num_timesteps, x0.device)
        e_uc, e_c = velocity_fn(torch.cat([x, x]), t_int, ctx_in).chunk(2)
        x = x + float(t_next - t) * (e_uc + guidance_scale * (e_c - e_uc))
        known_t = float(t_next) * known + float(one - decay * t_next) * x0
        x = keep * known_t + (1.0 - keep) * x
    return x

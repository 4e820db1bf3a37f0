"""Legacy DDIM / PLMS samplers with CFG for eps-prediction models over the
DDPM schedule (counterpart of maa3_tpu/diffusion/ddim.py; DDIMSampler,
ldm/models/diffusion/ddim.py:12-234, and PLMSSampler, plms.py:11-236).

The reverse trajectory is a Python loop over the selected timesteps (JAX
runs it as one `lax.scan`); each step's coefficients are fp32 scalars
taken from the same tables, so every step computes in fp32 as JAX's does.
CFG runs the dual batch [uncond; cond], skipped at scale 1.0 or without
an uncond. DDIM with eta > 0 draws one normal per step, from `generator`
or from `draws` (one tensor per step, in sampling order).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from maa3_tpu_torch.diffusion.schedules import (DDPMSchedule, make_ddim_sampling_parameters,
                                                make_ddim_timesteps)

EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _cfg_eps(eps_fn: EpsFn, x: torch.Tensor, t_int: torch.Tensor, cond: torch.Tensor,
             uncond: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    if uncond is None or scale == 1.0:
        return eps_fn(x, t_int, cond)
    e_uc, e_c = eps_fn(torch.cat([x, x]), torch.cat([t_int, t_int]),
                       torch.cat([uncond, cond])).chunk(2)
    return e_uc + scale * (e_c - e_uc)


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _reversed_tables(schedule: DDPMSchedule, steps: int, eta: float):
    ts = make_ddim_timesteps(steps, len(schedule.betas))
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
        schedule.alphas_cumprod, ts, eta)
    return ts[::-1], alphas[::-1], alphas_prev[::-1], sigmas[::-1]


def ddim_sample(eps_fn: EpsFn, x0_noise: torch.Tensor, cond: torch.Tensor,
                schedule: DDPMSchedule, steps: int = 50, eta: float = 0.0,
                uncond: Optional[torch.Tensor] = None, guidance_scale: float = 1.0,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """DDIM reverse process (ddim.py:120-201), x starts from pure noise."""
    ts, alphas, alphas_prev, sigmas = _reversed_tables(schedule, steps, eta)
    x, dev = x0_noise, x0_noise.device
    b = x.shape[0]
    for i, t in enumerate(ts):
        a_t, a_prev, sigma = (_f32(v, dev) for v in (alphas[i], alphas_prev[i], sigmas[i]))
        t_int = torch.full((b,), int(t), dtype=torch.long, device=dev)
        e_t = _cfg_eps(eps_fn, x, t_int, cond, uncond, guidance_scale)
        pred_x0 = (x - torch.sqrt(1.0 - a_t) * e_t) / torch.sqrt(a_t)
        dir_xt = torch.sqrt(1.0 - a_prev - sigma ** 2) * e_t
        x = torch.sqrt(a_prev) * pred_x0 + dir_xt
        if sigmas[i] > 0:
            z = draws[i] if draws is not None else torch.randn(
                x.shape, generator=generator, device=dev, dtype=x.dtype)
            x = x + sigma * z
    return x


def plms_sample(eps_fn: EpsFn, x0_noise: torch.Tensor, cond: torch.Tensor,
                schedule: DDPMSchedule, steps: int = 50,
                uncond: Optional[torch.Tensor] = None,
                guidance_scale: float = 1.0) -> torch.Tensor:
    """PLMS (pseudo linear multistep, plms.py:171-236): Adams-Bashforth over
    eps; the first step averages eps at x and at its DDIM successor
    (plms.py:214-216), the next two use the 2nd and 3rd order formulas."""
    ts, alphas, alphas_prev, _ = _reversed_tables(schedule, steps, 0.0)
    ts_next = np.append(ts[1:], 0)
    x, dev = x0_noise, x0_noise.device
    b = x.shape[0]

    def x_prev_from_eps(x, e_t, a_t, a_prev):
        pred_x0 = (x - torch.sqrt(1.0 - a_t) * e_t) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * e_t

    def eps_at(x, t):
        t_int = torch.full((b,), int(t), dtype=torch.long, device=dev)
        return _cfg_eps(eps_fn, x, t_int, cond, uncond, guidance_scale)

    hist = []  # the previous steps' eps, newest first
    for i, t in enumerate(ts):
        a_t, a_prev = _f32(alphas[i], dev), _f32(alphas_prev[i], dev)
        e_t = eps_at(x, t)
        if i == 0:
            e_next = eps_at(x_prev_from_eps(x, e_t, a_t, a_prev), ts_next[i])
            e_prime = (e_t + e_next) / 2
        elif i == 1:
            e_prime = (3 * e_t - hist[0]) / 2
        elif i == 2:
            e_prime = (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            e_prime = (55 * e_t - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24
        x = x_prev_from_eps(x, e_prime, a_t, a_prev)
        hist = [e_t] + hist[:2]
    return x


def q_sample(schedule: DDPMSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) (ddpm.py DDPM.q_sample)."""
    dev = x_start.device
    sa = torch.as_tensor(schedule.sqrt_alphas_cumprod, dtype=torch.float32, device=dev)[t]
    so = torch.as_tensor(schedule.sqrt_one_minus_alphas_cumprod, dtype=torch.float32,
                         device=dev)[t]
    shape = (-1,) + (1,) * (x_start.dim() - 1)
    return sa.reshape(shape) * x_start + so.reshape(shape) * noise

"""DDPM beta schedules + derived buffers (legacy checkpoints/samplers);
a copy of maa3_tpu/diffusion/schedules.py (numpy only), so that the port
imports nothing of the JAX package.

Parity targets: make_beta_schedule (ldm/modules/diffusionmodules/util.py:21-47)
and DDPM.register_schedule (ldm/models/diffusion/ddpm.py:118-170) — linear
(sqrt-space), cosine, sqrt_linear, sqrt variants; alphas_cumprod and the
posterior coefficients; DDIM timestep subsetting + sigmas
(util.py make_ddim_timesteps / make_ddim_sampling_parameters).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    if schedule == "linear":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = (np.arange(n_timestep + 1, dtype=np.float64) / n_timestep
                     + cosine_s)
        alphas = timesteps / (1 + cosine_s) * np.pi / 2
        alphas = np.cos(alphas) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas.astype(np.float64)


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @classmethod
    def create(cls, timesteps: int = 1000, beta_schedule: str = "linear",
               linear_start: float = 1e-4, linear_end: float = 2e-2,
               cosine_s: float = 8e-3, v_posterior: float = 0.0) -> "DDPMSchedule":
        betas = make_beta_schedule(beta_schedule, timesteps, linear_start,
                                   linear_end, cosine_s)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        acp = np.append(1.0, ac[:-1])
        post_var = ((1 - v_posterior) * betas * (1.0 - acp) / (1.0 - ac)
                    + v_posterior * betas)
        return cls(
            betas=betas,
            alphas_cumprod=ac,
            alphas_cumprod_prev=acp,
            sqrt_alphas_cumprod=np.sqrt(ac),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1),
            posterior_variance=post_var,
            posterior_log_variance_clipped=np.log(np.maximum(post_var, 1e-20)),
            posterior_mean_coef1=betas * np.sqrt(acp) / (1.0 - ac),
            posterior_mean_coef2=(1.0 - acp) * np.sqrt(alphas) / (1.0 - ac),
        )


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                        method: str = "uniform") -> np.ndarray:
    """util.py make_ddim_timesteps: uniform or quad subset, +1 shift."""
    if method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif method == "quad":
        ddim_timesteps = ((np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                                       num_ddim_timesteps)) ** 2).astype(int)
    else:
        raise NotImplementedError(method)
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(alphacums: np.ndarray,
                                  ddim_timesteps: np.ndarray,
                                  eta: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                           * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev

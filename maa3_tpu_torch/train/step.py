"""The CFM training step (counterpart of maa3_tpu/train/step.py): frozen fp32
VAE encode -> posterior sample -> x scale_factor -> CFM loss through
dit_apply(training=True) -> backward -> global-norm clip -> AdamW -> EMA.

The DiT's parameters are the fp32 master weights; with a bf16 compute dtype
every matmul casts its operands to bf16 (ops/basic.py `dense`) and the
gradients flow back to the fp32 weights. Batches carry either a mel
(B, 80, T) or cached posterior `moments`, and a precomputed `context`
(the conditioner is frozen and runs outside the step).

Random draws (posterior noise, timesteps, flow noise) come from a
torch.Generator, or from `draws` ({"noise", "t_int", "x0"}) so that a test
can replay another implementation's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from maa3_tpu_torch.diffusion import cfm
from maa3_tpu_torch.models.dit import DiT, dit_apply
from maa3_tpu_torch.models.vae1d import AutoencoderKL, gaussian_sample, vae_encode_moments
from maa3_tpu_torch.train.optim import Optimizer, ema_update


@dataclasses.dataclass
class TrainState:
    step: int
    dit: DiT                    # trainable, fp32 master weights
    optimizer: Optimizer
    ema: Optional[List[torch.Tensor]]  # shadows of dit.parameters()
    vae: AutoencoderKL          # frozen first stage
    scale_factor: float         # latent std rescale (ddpm_audio.py:88-103)


def create_train_state(dit: DiT, vae: AutoencoderKL, optimizer: Optimizer,
                       use_ema: bool = False, scale_factor: float = 1.0) -> TrainState:
    ema = [p.detach().clone() for p in dit.parameters()] if use_ema else None
    return TrainState(0, dit, optimizer, ema, vae, float(scale_factor))


def _latent(state: TrainState, batch: dict, generator, noise) -> torch.Tensor:
    with torch.no_grad():
        moments = (batch["moments"] if "moments" in batch
                   else vae_encode_moments(state.vae, batch["mel"]))
        return gaussian_sample(moments, generator, noise) * state.scale_factor


def _loss(state: TrainState, batch: dict, generator, draws, compute_dtype,
          num_timesteps):
    draws = draws or {}
    z = _latent(state, batch, generator, draws.get("noise"))

    def velocity(x, t_int, c):
        return dit_apply(state.dit, x, t_int, c, compute_dtype=compute_dtype,
                         training=True)

    return cfm.cfm_loss(velocity, z, batch["context"], generator,
                        num_timesteps=num_timesteps, t_int=draws.get("t_int"),
                        x0=draws.get("x0"))


def make_train_step(num_timesteps: int = 1000, ema_decay: float = 0.9999,
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16):
    """train_step(state, batch, generator=None, draws=None) -> metrics
    {loss, loss_simple, grad_norm} as 0-d tensors; updates `state` in place
    (parameters, optimizer moments, EMA shadows, step)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad()
        loss, aux = _loss(state, batch, generator, draws, compute_dtype,
                          num_timesteps)
        loss.backward()
        grad_norm = state.optimizer.step(state.step)
        if state.ema is not None:
            ema_update(state.ema, state.dit.parameters(), ema_decay, state.step)
        state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()},
                "grad_norm": grad_norm}

    return train_step


def make_eval_step(num_timesteps: int = 1000,
                   compute_dtype: Optional[torch.dtype] = torch.bfloat16):
    """Validation loss: the same objective, no gradient or update."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[dict] = None) -> torch.Tensor:
        return _loss(state, batch, generator, draws, compute_dtype, num_timesteps)[0]

    return eval_step

"""The CFM training step (counterpart of maa3_tpu/train/step.py): frozen fp32
VAE encode -> posterior sample -> x scale_factor -> conditioning -> CFM loss
through dit_apply(training=True) -> backward -> global-norm clip -> AdamW ->
EMA. With gradient accumulation (train/optim.py `accum_steps`) a step is a
micro-step, as the JAX step under optax.MultiSteps: the optimizer updates
the parameters every k-th, while `state.step` and the EMA advance on every
one (the EMA decay at the micro-step count, as LitEma under
accumulate_grad_batches), and `grad_norm` is the micro-batch's.

The trainable modules are the DiT and, when the config trains the cond stage
(cond_stage_trainable), the CLAP+FLAN conditioner; their parameters are the
fp32 master weights. With a bf16 compute dtype every DiT matmul casts its
operands to bf16 (ops/basic.py `dense`) and the gradients flow back to the
fp32 weights. The VAE encode and the conditioner run in fp32 without TF32
(`full_fp32`), as on the CPU. Batches carry either a mel (B, 80, T) or cached
posterior `moments`, and either a precomputed `context` or the conditioner's
token batch (`MAA3System.tokenize`), which `conditioner` encodes inside the
loss so that its gradients flow.

Random draws (posterior noise, timesteps, flow noise) come from a
torch.Generator, or from `draws` ({"noise", "t_int", "x0"}) so that a test
can replay another implementation's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from maa3_tpu_torch.diffusion import cfm
from maa3_tpu_torch.models.dit import DiT, dit_apply
from maa3_tpu_torch.models.vae1d import AutoencoderKL, gaussian_sample, vae_encode_moments
from maa3_tpu_torch.pipeline import full_fp32
from maa3_tpu_torch.train.optim import Optimizer, ema_update

# conditioner(cond module, batch) -> context (B, Ly, context_dim)
Conditioner = Callable[[nn.Module, Dict[str, torch.Tensor]], torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    dit: DiT                    # trainable, fp32 master weights
    optimizer: Optimizer
    ema: Optional[List[torch.Tensor]]  # shadows of trainable_parameters()
    vae: AutoencoderKL          # frozen first stage
    scale_factor: float         # latent std rescale (ddpm_audio.py:88-103)
    cond: Optional[nn.Module] = None  # trainable conditioner, or None (frozen)

    def trainable(self) -> Dict[str, nn.Module]:
        """The trainable modules by name, as the JAX state's params tree."""
        return {"dit": self.dit} | ({"cond": self.cond} if self.cond is not None else {})

    def trainable_parameters(self) -> List[nn.Parameter]:
        return [p for m in self.trainable().values() for p in m.parameters()]


def create_train_state(dit: DiT, vae: AutoencoderKL, optimizer: Optimizer,
                       use_ema: bool = False, scale_factor: float = 1.0,
                       cond: Optional[nn.Module] = None) -> TrainState:
    state = TrainState(0, dit, optimizer, None, vae, float(scale_factor), cond)
    if use_ema:
        state.ema = [p.detach().clone() for p in state.trainable_parameters()]
    return state


def sample_latent(vae: AutoencoderKL, batch: dict, generator=None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The posterior sample of the batch's mel (or cached moments), before the
    scale factor: the frozen encoder runs in fp32, without TF32."""
    with torch.no_grad(), full_fp32():
        moments = (batch["moments"] if "moments" in batch
                   else vae_encode_moments(vae, batch["mel"]))
        return gaussian_sample(moments, generator, noise)


def _loss(state: TrainState, batch: dict, generator, draws, compute_dtype,
          num_timesteps, conditioner: Optional[Conditioner]):
    draws = draws or {}
    z = sample_latent(state.vae, batch, generator, draws.get("noise")) * state.scale_factor
    if "context" in batch:
        context = batch["context"]
    else:
        with full_fp32():
            context = conditioner(state.cond, batch)

    def velocity(x, t_int, c):
        return dit_apply(state.dit, x, t_int, c, compute_dtype=compute_dtype,
                         training=True)

    return cfm.cfm_loss(velocity, z, context, generator,
                        num_timesteps=num_timesteps, t_int=draws.get("t_int"),
                        x0=draws.get("x0"))


def make_train_step(num_timesteps: int = 1000, ema_decay: float = 0.9999,
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                    conditioner: Optional[Conditioner] = None):
    """train_step(state, batch, generator=None, draws=None) -> metrics
    {loss, loss_simple, grad_norm} as 0-d tensors; updates `state` in place
    (parameters, optimizer moments, EMA shadows, step). `conditioner` encodes
    batches without a `context` from state.cond, inside the loss."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad()
        loss, aux = _loss(state, batch, generator, draws, compute_dtype,
                          num_timesteps, conditioner)
        loss.backward()
        grad_norm = state.optimizer.step()
        if state.ema is not None:
            ema_update(state.ema, state.trainable_parameters(), ema_decay, state.step)
        state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()},
                "grad_norm": grad_norm}

    return train_step


def make_eval_step(num_timesteps: int = 1000,
                   compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                   conditioner: Optional[Conditioner] = None):
    """Validation loss: the same objective, no gradient or update."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[dict] = None) -> torch.Tensor:
        return _loss(state, batch, generator, draws, compute_dtype, num_timesteps,
                     conditioner)[0]

    return eval_step

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

`apply_fn(dit, x, t_int, context)` replaces the backbone's training forward
(dit_apply(training=True)); the Trainer passes moe_dit_apply for the video
MoE DiT, whose conditioner encodes the batch's `video_feat`.

Random draws (posterior noise, timesteps, flow noise) come from a
torch.Generator, or from `draws` ({"noise", "t_int", "x0"}) so that a test
can replay another implementation's draws.

With tracing on (maa3_tpu_torch/trace.py) the step records, each with its
device time, `train.vae_encode` (the posterior sample), `train.cond` (the
trainable conditioner's encode), `train.forward` (the CFM loss through the
DiT), `train.backward` (with the data-parallel gradient average) and
`train.optimizer` (clip, update, EMA); the validation loss records the
first three.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from maa3_tpu_torch import trace
from maa3_tpu_torch.diffusion import cfm
from maa3_tpu_torch.models.dit import dit_apply
from maa3_tpu_torch.models.vae1d import AutoencoderKL, gaussian_sample, vae_encode_moments
from maa3_tpu_torch.pipeline import full_fp32
from maa3_tpu_torch.train.optim import Optimizer, ema_update

# conditioner(cond module, batch) -> context (B, Ly, context_dim)
Conditioner = Callable[[nn.Module, Dict[str, torch.Tensor]], torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    dit: nn.Module              # trainable DiT or MoEDiT, fp32 master weights
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


def create_train_state(dit: nn.Module, vae: AutoencoderKL, optimizer: Optimizer,
                       use_ema: bool = False, scale_factor: float = 1.0,
                       cond: Optional[nn.Module] = None) -> TrainState:
    state = TrainState(0, dit, optimizer, None, vae, float(scale_factor), cond)
    if use_ema:
        state.ema = [p.detach().clone() for p in state.trainable_parameters()]
    return state


def _rows_of(rows, generator, draw, shape, **kw) -> torch.Tensor:
    """draw(shape) for the whole batch of rows[2] rows from the shared
    generator, this rank's rows rows[0]:rows[1] of it."""
    lo, hi, n = rows
    return draw((n,) + tuple(shape[1:]), generator=generator, **kw)[lo:hi]


def sample_latent(vae: AutoencoderKL, batch: dict, generator=None,
                  noise: Optional[torch.Tensor] = None, rows=None) -> torch.Tensor:
    """The posterior sample of the batch's mel (or cached moments), before the
    scale factor: the frozen encoder runs in fp32, without TF32. rows
    (lo, hi, n): the batch is rows lo:hi of a data-parallel batch of n, and
    the noise is drawn for all n (train/loop.py)."""
    with torch.no_grad(), full_fp32():
        moments = (batch["moments"] if "moments" in batch
                   else vae_encode_moments(vae, batch["mel"]))
        if noise is None and rows is not None:
            mean = moments.chunk(2, dim=1)[0]
            noise = _rows_of(rows, generator, torch.randn, mean.shape,
                             device=mean.device, dtype=mean.dtype)
        return gaussian_sample(moments, generator, noise)


def _loss(state: TrainState, batch: dict, generator, draws, compute_dtype,
          num_timesteps, conditioner: Optional[Conditioner], apply_fn=None,
          rows=None):
    draws = dict(draws or {})
    with trace.span("train.vae_encode", device_time=True):
        z = sample_latent(state.vae, batch, generator, draws.get("noise"),
                          rows) * state.scale_factor
    if rows is not None:  # the timesteps, then the flow noise, as cfm_loss draws them
        if "t_int" not in draws:
            draws["t_int"] = _rows_of(rows, generator, functools.partial(
                torch.randint, 0, num_timesteps), z.shape[:1], device=z.device)
        if "x0" not in draws:
            draws["x0"] = _rows_of(rows, generator, torch.randn, z.shape,
                                   device=z.device, dtype=z.dtype)
    if "context" in batch:
        context = batch["context"]
    else:
        with trace.span("train.cond", device_time=True), full_fp32():
            context = conditioner(state.cond, batch)

    def velocity(x, t_int, c):
        if apply_fn is not None:
            return apply_fn(state.dit, x, t_int, c)
        return dit_apply(state.dit, x, t_int, c, compute_dtype=compute_dtype,
                         training=True)

    with trace.span("train.forward", device_time=True):
        return cfm.cfm_loss(velocity, z, context, generator,
                            num_timesteps=num_timesteps, t_int=draws.get("t_int"),
                            x0=draws.get("x0"))


def make_train_step(num_timesteps: int = 1000, ema_decay: float = 0.9999,
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                    conditioner: Optional[Conditioner] = None, apply_fn=None,
                    grad_sync: Optional[Callable[[], None]] = None):
    """train_step(state, batch, generator=None, draws=None, rows=None) ->
    metrics {loss, loss_simple, grad_norm} as 0-d tensors; updates `state`
    in place (parameters, optimizer moments, EMA shadows, step).
    `conditioner` encodes batches without a `context` from state.cond,
    inside the loss. rows: see sample_latent; grad_sync() runs between the
    backward and the update (the data-parallel gradient average)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None, rows=None) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad()
        loss, aux = _loss(state, batch, generator, draws, compute_dtype,
                          num_timesteps, conditioner, apply_fn, rows)
        with trace.span("train.backward", device_time=True):
            loss.backward()
            if grad_sync is not None:
                grad_sync()
        with trace.span("train.optimizer", device_time=True):
            grad_norm = state.optimizer.step()
            if state.ema is not None:
                ema_update(state.ema, state.trainable_parameters(), ema_decay, state.step)
        state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()},
                "grad_norm": grad_norm}

    return train_step


def make_eval_step(num_timesteps: int = 1000,
                   compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                   conditioner: Optional[Conditioner] = None, apply_fn=None):
    """Validation loss: the same objective, no gradient or update."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[dict] = None, rows=None) -> torch.Tensor:
        return _loss(state, batch, generator, draws, compute_dtype, num_timesteps,
                     conditioner, apply_fn, rows)[0]

    return eval_step

"""Noisy-latent classifier and classifier guidance (counterpart of
maa3_tpu/diffusion/classifier_guidance.py; the reference's
ldm/models/diffusion/classifier.py NoisyLatentImageClassifier, :28).

A compact t-conditioned conv net over (B, C, T) latents, trained on
q-sampled noisy latents; guidance adds grad_x log p(y | x_t), taken with
torch.autograd.grad, to a velocity. Keys follow the JAX tree: temb1,
temb2, conv_in, blocks.{i}.{conv1, conv2, film}, head.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from maa3_tpu_torch.diffusion.ddim import q_sample
from maa3_tpu_torch.diffusion.schedules import DDPMSchedule
from maa3_tpu_torch.ops.basic import linear, silu, timestep_embedding
from maa3_tpu_torch.ops.conv import conv1d


@dataclasses.dataclass(frozen=True)
class NoisyClfConfig:
    in_channels: int = 20
    hidden: int = 128
    num_blocks: int = 3
    num_classes: int = 10
    temb_dim: int = 128


class NoisyClfBlock(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.conv1 = nn.Conv1d(hidden, hidden, 3)
        self.conv2 = nn.Conv1d(hidden, hidden, 3)
        self.film = nn.Linear(hidden, hidden)


class NoisyClf(nn.Module):
    def __init__(self, cfg: NoisyClfConfig):
        super().__init__()
        self.cfg = cfg
        self.temb1 = nn.Linear(cfg.temb_dim, cfg.hidden)
        self.temb2 = nn.Linear(cfg.hidden, cfg.hidden)
        self.conv_in = nn.Conv1d(cfg.in_channels, cfg.hidden, 3)
        self.blocks = nn.ModuleList(NoisyClfBlock(cfg.hidden) for _ in range(cfg.num_blocks))
        self.head = nn.Linear(cfg.hidden, cfg.num_classes)


@torch.no_grad()
def noisy_clf_init_(clf: NoisyClf, generator: torch.Generator) -> NoisyClf:
    """As noisy_clf_init: dense weights Xavier-uniform with zero bias, convs
    U(+-1/sqrt(fan_in)) for weight and bias."""
    for m in clf.modules():
        if isinstance(m, nn.Linear):
            limit = (6.0 / (m.in_features + m.out_features)) ** 0.5
            m.weight.uniform_(-limit, limit, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Conv1d):
            bound = (m.in_channels * m.kernel_size[0]) ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
    return clf


def _conv(m: nn.Conv1d, x):
    return conv1d(x, m.weight, m.bias, padding=1)


def noisy_clf_apply(clf: NoisyClf, x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, C, T) noisy latent + (B,) timestep -> (B, classes) logits."""
    temb = timestep_embedding(t, clf.cfg.temb_dim)
    temb = linear(clf.temb2, silu(linear(clf.temb1, temb)))
    h = _conv(clf.conv_in, x_t)
    for blk in clf.blocks:
        r = _conv(blk.conv1, silu(h))
        r = r + linear(blk.film, silu(temb))[:, :, None]
        h = h + _conv(blk.conv2, silu(r))
    return linear(clf.head, h.mean(dim=-1))


def noisy_clf_loss(clf: NoisyClf, schedule: DDPMSchedule, x_start: torch.Tensor,
                   labels: torch.Tensor, generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
    """Cross-entropy on q-sampled noisy latents (classifier.py training);
    t and the noise are drawn from `generator` unless given."""
    b, dev = x_start.shape[0], x_start.device
    if t is None:
        t = torch.randint(0, len(schedule.betas), (b,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=dev,
                            dtype=x_start.dtype)
    logits = noisy_clf_apply(clf, q_sample(schedule, x_start, t, noise), t)
    loss = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "acc": acc}


def classifier_grad(clf: NoisyClf, x_t: torch.Tensor, t: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """grad_x log p(y | x_t): the guidance direction."""
    with torch.enable_grad():
        x = x_t.detach().requires_grad_(True)
        logp = F.log_softmax(noisy_clf_apply(clf, x, t), dim=-1)
        (g,) = torch.autograd.grad(logp.gather(1, labels[:, None]).sum(), x)
    return g


def guided_velocity(velocity_fn, clf: NoisyClf, labels: torch.Tensor,
                    guidance_scale: float = 1.0):
    """A velocity with classifier guidance: the flow pushed toward latents
    the classifier assigns to `labels`."""

    def vel(x, t_int, context):
        return (velocity_fn(x, t_int, context)
                + guidance_scale * classifier_grad(clf, x, t_int, labels))

    return vel

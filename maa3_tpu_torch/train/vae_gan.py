"""VAE-GAN training of the first stage (counterpart of
maa3_tpu/train/vae_gan.py): a hinge-GAN KL autoencoder with two optimizers
(AutoencoderKL.training_step + LPAPSWithDiscriminator,
ldm/models/autoencoder1d.py:79-150, ldm/modules/losses_audio/
contperceptual.py:22-150).

  ae step:   L = sum|x - x_hat| / exp(logvar) + logvar (per sample)
                 + kl_weight * KL(q)
                 + d_weight * adopt_weight * (-mean D(x_hat))
             d_weight = clip(||dNLL/dW|| / (||dG/dW|| + 1e-4), 0, 1e4)
                        * disc_weight, W = decoder.conv_out.weight, detached
  disc step: adopt_weight * hinge(D(x), D(x_hat)) (+ r1_weight * R1 on x)

Only the ae step advances `step`, so the disc step's adopt_weight sees the
advanced step (maa3_tpu/train/vae_gan.py:149, :155). Both steps of one
iteration take the same posterior noise. The configs in use set
perceptual_weight 0 (contperceptual.py:32-33), so there is no LPAPS term.
All in fp32; callers on the card run the steps under pipeline.full_fp32()
where they want fp32 convolutions, not cuDNN's TF32 default.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch
from torch import nn

from maa3_tpu_torch.models.discriminators import (NLayerDiscriminator, adopt_weight,
                                                  disc_init_, hinge_d_loss)
from maa3_tpu_torch.models.vae1d import (AutoencoderKL, VAEConfig, gaussian_kl,
                                         gaussian_sample, vae_decode,
                                         vae_encode_moments)

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class VAEGanState:
    vae: AutoencoderKL
    disc: NLayerDiscriminator
    logvar: nn.Parameter            # the learned scalar of the L1 NLL
    vae_opt: torch.optim.Optimizer  # over the VAE's parameters and logvar
    disc_opt: torch.optim.Optimizer
    step: int = 0

    def ae_parameters(self) -> Sequence[nn.Parameter]:
        return [*self.vae.parameters(), self.logvar]


def make_vae_optimizers(ae_params, disc_params, lr: float = 4.5e-6,
                        lr_multiplier: float = 16.0):
    """Adam with betas (0.5, 0.9) at lr * lr_multiplier for both
    (autoencoder1d.py:141-150)."""
    return tuple(torch.optim.Adam(p, lr=lr * lr_multiplier, betas=(0.5, 0.9))
                 for p in (ae_params, disc_params))


def create_vae_gan_state(vae: AutoencoderKL, generator: torch.Generator,
                         lr: float = 4.5e-6, lr_multiplier: float = 16.0,
                         disc_ndf: int = 64, disc_layers: int = 3) -> VAEGanState:
    """A PatchGAN drawn from `generator` (on the CPU, then moved to the VAE's
    device), logvar 0, and the two optimizers."""
    device = next(vae.parameters()).device
    disc = disc_init_(NLayerDiscriminator(1, disc_ndf, disc_layers), generator).to(device)
    logvar = nn.Parameter(torch.zeros((), device=device))
    vae_opt, disc_opt = make_vae_optimizers([*vae.parameters(), logvar],
                                            disc.parameters(), lr, lr_multiplier)
    return VAEGanState(vae, disc, logvar, vae_opt, disc_opt)


def posterior_noise(cfg: VAEConfig, batch: int, mel_len: int, seed: int) -> torch.Tensor:
    """N(0, 1) posterior noise for a batch of mel_len frames, drawn on the CPU
    from `seed` (the same numbers on every device): (batch, embed_dim,
    mel_len halved once per downsampling level)."""
    t = mel_len
    for _ in cfg.down_layers:
        t //= 2
    return torch.randn(batch, cfg.embed_dim, t, generator=torch.Generator().manual_seed(seed))


def ae_loss_terms(disc: NLayerDiscriminator, logvar: torch.Tensor, mel, rec, moments):
    """(nll_loss, kl, g_loss, mean |mel - rec|) of the generator pass
    (contperceptual.py:75-104): the per-sample-summed L1 NLL with the learned
    logvar, the posterior's KL, the hinge G loss through the PatchGAN."""
    rec_l1 = (mel - rec).abs()
    nll_loss = (rec_l1 / torch.exp(logvar) + logvar).sum() / mel.shape[0]
    kl = gaussian_kl(moments).sum() / mel.shape[0]
    g_loss = -disc(rec[:, None]).mean()
    return nll_loss, kl, g_loss, rec_l1.mean()


def adaptive_d_weight(nll_loss, g_loss, w_last: torch.Tensor, disc_weight: float):
    """calculate_adaptive_weight (contperceptual.py:61-72): the ratio of the
    gradient norms of the NLL and the G loss with respect to the decoder's
    last weight, clipped to [0, 1e4], times disc_weight, detached."""
    nll_g, = torch.autograd.grad(nll_loss, w_last, retain_graph=True)
    g_g, = torch.autograd.grad(g_loss, w_last, retain_graph=True)
    return (nll_g.norm() / (g_g.norm() + 1e-4)).clamp(0.0, 1e4).detach() * disc_weight


def disc_loss_terms(disc: NLayerDiscriminator, mel, rec, factor: float,
                    r1_weight: float = 0.0):
    """(d_loss, mean real logit, mean fake logit) of the discriminator pass
    (contperceptual.py:125-150): the adopt-weighted hinge loss, plus
    r1_weight x the mean squared gradient of sum D(mel) with respect to mel
    (R1), which keeps its graph (a double backward through train-mode
    BatchNorm). Real and fake go through D apart, each with its own batch
    statistics, as in JAX."""
    mel = mel.detach().requires_grad_(r1_weight > 0)
    logits_real = disc(mel[:, None])
    logits_fake = disc(rec[:, None])
    d = factor * hinge_d_loss(logits_real, logits_fake)
    if r1_weight > 0:
        grad, = torch.autograd.grad(logits_real.sum(), mel, create_graph=True)
        d = d + r1_weight * grad.square().mean()
    return d, logits_real.mean(), logits_fake.mean()


def apply_loss(opt: torch.optim.Optimizer, loss, params) -> None:
    """One update of `opt` from the gradients of loss with respect to params
    (and no other tensor)."""
    params = list(params)
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    opt.step()


def make_vae_gan_steps(cfg: VAEConfig, kl_weight: float = 1e-6,
                       disc_weight: float = 0.5, disc_factor: float = 1.0,
                       disc_start: int = 50001, r1_weight: float = 0.0):
    """(ae_step, disc_step), each (state, mel (B, 80, T), noise) -> metrics,
    updating the state in place; noise is the posterior's N(0, 1) draw
    (posterior_noise), the same for both steps of an iteration."""

    def reconstruct(vae, mel, noise):
        moments = vae_encode_moments(vae, mel)
        z = gaussian_sample(moments, noise=noise.to(moments.device))
        return vae_decode(vae, z), moments

    def ae_step(state: VAEGanState, mel: torch.Tensor, noise: torch.Tensor) -> Metrics:
        rec, moments = reconstruct(state.vae, mel, noise)
        nll_loss, kl, g_loss, rec_l1 = ae_loss_terms(state.disc, state.logvar, mel,
                                                     rec, moments)
        d_weight = adaptive_d_weight(nll_loss, g_loss, state.vae.decoder.conv_out.weight,
                                     disc_weight)
        factor = adopt_weight(disc_factor, state.step, disc_start)
        loss = nll_loss + kl_weight * kl + d_weight * factor * g_loss
        apply_loss(state.vae_opt, loss, state.ae_parameters())
        state.step += 1
        return {k: v.detach() for k, v in (
            ("aeloss", loss), ("nll_loss", nll_loss), ("kl_loss", kl),
            ("g_loss", g_loss), ("rec_loss", rec_l1), ("d_weight", d_weight))}

    def disc_step(state: VAEGanState, mel: torch.Tensor, noise: torch.Tensor) -> Metrics:
        with torch.no_grad():
            rec, _ = reconstruct(state.vae, mel, noise)
        factor = adopt_weight(disc_factor, state.step, disc_start)
        d_loss, lr_mean, lf_mean = disc_loss_terms(state.disc, mel, rec, factor,
                                                   r1_weight)
        apply_loss(state.disc_opt, d_loss, state.disc.parameters())
        return {"discloss": d_loss.detach(), "logits_real": lr_mean.detach(),
                "logits_fake": lf_mean.detach()}

    return ae_step, disc_step


def vae_gan_checkpoint(state: VAEGanState) -> dict:
    """What JAX's train_vae saves: {"vae", "disc", "logvar"}."""
    return {"vae": state.vae.state_dict(), "disc": state.disc.state_dict(),
            "logvar": state.logvar.detach().clone()}


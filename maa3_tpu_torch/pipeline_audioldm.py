"""The AudioLDM-variant generation pipeline (counterpart of
maa3_tpu/pipeline_audioldm.py; the reference's `generate_sample`,
ldm/models/diffusion/audioldm.py:20,635):

  pooled text embedding (film_pool) -> FiLM-conditioned 2-D UNet
  -> DDIM / PLMS CFG sampling over the DDPM beta schedule
  -> 2-D VAE decode (z / scale_factor) -> HiFi-GAN (the port's BigVGAN
     in lrelu mode: no anti-aliased activation, so neither K1 nor K2)

Kept from the reference: n_candidate_gen_per_text tiling with best-of
selection by a caller's scorer (the reference ranks by CLAP score; the
default keeps the tamest candidate), and the blow-up guard (if any |z| of
the whole batch exceeds 1e2, clip to [-10, 10], audioldm.py:700-702). Runs
in fp32, as the JAX pipeline does (on the card without TF32: every stage
runs under full_fp32). The vocoder's num_mels must equal the
VAE's mel bands (4 latent_f for the default VAE): a mismatch is refused
with a ValueError when the pipeline is built.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from maa3_tpu_torch.diffusion.ddim import ddim_sample, plms_sample
from maa3_tpu_torch.diffusion.ddpm_loss import film_pool
from maa3_tpu_torch.diffusion.schedules import DDPMSchedule
from maa3_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, bigvgan_apply, bigvgan_init_
from maa3_tpu_torch.models.unet2d import UNet2D, UNet2DConfig, unet2d_apply, unet2d_init_
from maa3_tpu_torch.models.vae2d import VAE2D, VAE2DConfig, vae2d_decode, vae2d_init_
from maa3_tpu_torch.pipeline import full_fp32


def hifigan_config() -> BigVGANConfig:
    """AudioLDM's HiFi-GAN: the BigVGAN graph with leaky-relu activations
    and no anti-aliased resampling (80 mels, as the JAX package has it)."""
    return BigVGANConfig(activation="lrelu")


def check_mels(voc_cfg: BigVGANConfig, vae_cfg: VAE2DConfig, latent_f: int) -> None:
    """Refuse a vocoder whose num_mels is not the number of mel bands the
    VAE decodes latent_f latent bins to (JAX's pipeline fails later, in
    the vocoder's first conv)."""
    bands = latent_f * 2 ** (vae_cfg.num_levels - 1)
    if voc_cfg.num_mels != bands:
        raise ValueError(
            f"the vocoder takes {voc_cfg.num_mels} mel bands but the VAE decodes "
            f"latent_f {latent_f} to {bands}: pass a vocoder config with "
            f"num_mels={bands} (e.g. dataclasses.replace(hifigan_config(), "
            f"num_mels={bands}))")


@dataclasses.dataclass(eq=False)
class AudioLDMPipeline:
    unet: UNet2D
    vae: VAE2D
    vocoder: BigVGAN
    schedule: DDPMSchedule
    scale_factor: float = 1.0
    latent_f: int = 16                # latent frequency bins (mel bands / 4)
    latent_t: int = 64                # latent frames

    def __post_init__(self):
        check_mels(self.vocoder.cfg, self.vae.cfg, self.latent_f)
        for m in (self.unet, self.vae, self.vocoder):
            m.requires_grad_(False)

    @classmethod
    def random_init(cls, generator: torch.Generator, unet_cfg: UNet2DConfig = None,
                    vae_cfg: VAE2DConfig = None, voc_cfg: BigVGANConfig = None,
                    device="cuda", **kw) -> "AudioLDMPipeline":
        """Random weights from `generator` (a generator of `device`); the
        defaults are JAX's: UNet2DConfig(film_dim=512), VAE2DConfig() and
        hifigan_config(), whose 80 mels do not fit the VAE's 64 bands
        (ValueError)."""
        unet_cfg = unet_cfg or UNet2DConfig(film_dim=512)
        vae_cfg = vae_cfg or VAE2DConfig()
        voc_cfg = voc_cfg or hifigan_config()
        check_mels(voc_cfg, vae_cfg, kw.get("latent_f", cls.latent_f))
        with torch.device(device):
            unet, vae, voc = UNet2D(unet_cfg), VAE2D(vae_cfg), BigVGAN(voc_cfg)
        return cls(unet2d_init_(unet, generator), vae2d_init_(vae, generator),
                   bigvgan_init_(voc, generator), DDPMSchedule.create(), **kw)

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @torch.no_grad()
    def sample(self, x_T: torch.Tensor, film_c: torch.Tensor,
               film_uc: Optional[torch.Tensor], guidance_scale: float = 1.0,
               ddim_steps: int = 200, use_plms: bool = False) -> torch.Tensor:
        """The latent from x_T by DDIM (eta 0: no draws) or PLMS, with the
        blow-up guard."""
        def eps_fn(x, t_int, film):
            return unet2d_apply(self.unet, x, t_int, film=film)

        with full_fp32():
            if use_plms:
                z = plms_sample(eps_fn, x_T, film_c, self.schedule, steps=ddim_steps,
                                uncond=film_uc, guidance_scale=guidance_scale)
            else:
                z = ddim_sample(eps_fn, x_T, film_c, self.schedule, steps=ddim_steps,
                                uncond=film_uc, guidance_scale=guidance_scale)
        # the blow-up guard tests the whole batch (audioldm.py:700-702)
        return torch.where(z.abs().max() > 1e2, z.clamp(-10.0, 10.0), z)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, C, F, T) latent -> (B, M, T_mel) mel."""
        with full_fp32():
            return vae2d_decode(self.vae, z / self.scale_factor)[:, 0]

    @torch.no_grad()
    def vocode(self, mel: torch.Tensor) -> torch.Tensor:
        with full_fp32():
            return bigvgan_apply(self.vocoder, mel, compute_dtype=torch.float32)

    def generate_sample(self, cond_emb: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        ddim_steps: int = 200, n_candidate_gen_per_text: int = 1,
                        unconditional_guidance_scale: float = 1.0,
                        uncond_emb: Optional[torch.Tensor] = None,
                        use_plms: bool = False,
                        select_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                        x_T: Optional[torch.Tensor] = None):
        """cond_emb: (B, Ly, D) or (B, D) text embedding. Returns (wav
        (B, T_samples), mel (B, M, T_mel)). The initial noise is drawn from
        `generator` unless x_T (B n, C, latent_f, latent_t) is given.

        n_candidate_gen_per_text > 1 tiles the batch and keeps each text's
        best candidate by select_fn(wav) -> (N,) scores (the reference ranks
        with CLAP similarity), else the one of least max |wav|."""
        b, n = cond_emb.shape[0], n_candidate_gen_per_text
        cond_emb = cond_emb.to(self.device, torch.float32)
        film_c = film_pool(cond_emb).repeat(n, 1)
        if uncond_emb is None and unconditional_guidance_scale != 1.0:
            uncond_emb = torch.zeros_like(cond_emb)
        film_uc = (film_pool(uncond_emb.to(self.device, torch.float32)).repeat(n, 1)
                   if uncond_emb is not None else None)
        if x_T is None:
            x_T = torch.randn((b * n, self.unet.cfg.in_channels, self.latent_f,
                               self.latent_t), generator=generator, device=self.device)
        z = self.sample(x_T, film_c, film_uc, float(unconditional_guidance_scale),
                        ddim_steps, use_plms)
        mel = self.decode(z)
        wav = self.vocode(mel)
        if n > 1:
            scores = (select_fn(wav) if select_fn is not None
                      else -wav.abs().amax(dim=-1))
            best = scores.reshape(n, b).argmax(dim=0)
            pick = best * b + torch.arange(b, device=best.device)
            wav, mel = wav[pick], mel[pick]
        return wav, mel

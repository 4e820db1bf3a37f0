"""End-to-end generation pipeline (counterpart of maa3_tpu/pipeline.py):

    uc, c = text embeddings;  x0 ~ N(0, (B, 20, T/2))
    z   = CFG Euler ODE (25 steps, planned: per-step constants hoisted;
          sub-batches of ode_chunk() rows)
    mel = VAE.decode(z / scale_factor)     (fp32)
    wav = BigVGAN(mel)                     (compute dtype; K1/K2 kernels on CUDA)
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from maa3_tpu_torch.diffusion import cfm
from maa3_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, bigvgan_apply, bigvgan_init_
from maa3_tpu_torch.models.dit import (DiT, DiTConfig, dit_apply_planned,
                                       dit_init_, dit_sample_plan)
from maa3_tpu_torch.models.dit_moe import (MoEDiT, moe_dit_apply_planned,
                                           moe_dit_sample_plan)
from maa3_tpu_torch.models.vae1d import AutoencoderKL, VAEConfig, vae_decode, vae_init_


@contextlib.contextmanager
def full_fp32():
    """fp32 matmuls and convolutions without TF32 (cuDNN's default for fp32
    convolutions is TF32, which keeps ~3 decimal digits)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def dual_mask(context_mask, uncond_mask, uncond):
    """CFG dual-batch key mask [uncond_mask; context_mask], or None."""
    if context_mask is None:
        return None
    um = (uncond_mask if uncond_mask is not None else
          torch.ones(uncond.shape[:2], dtype=torch.bool, device=uncond.device))
    return torch.cat([um, context_mask.bool()], dim=0)


def ode_chunk() -> int:
    """Rows per ODE sub-batch for large launches, 0 for none: MAA3_ODE_CHUNK,
    else 0 (maa3_tpu/pipeline.py:33). JAX's default of 8 is a TPU
    measurement; on the card chunk 8 did not win (PERF.md section 5,
    chip_smoke.py phase 11), so none is the default everywhere."""
    return int(os.environ.get("MAA3_ODE_CHUNK", 0))


@torch.no_grad()
def sample_planned(dit: DiT, x0, context, uncond, guidance_scale: float,
                   steps: int = 25, context_mask=None, uncond_mask=None,
                   compute_dtype=torch.bfloat16, num_timesteps: int = 1000,
                   chunk: Optional[int] = None):
    """CFG ODE with the adaLN modulations and context K/V of the whole
    timestep grid computed once, up front (dit_sample_plan). A batch of B
    rows runs as B / chunk sequential sub-batches when B > chunk and chunk
    divides B (chunk: ode_chunk() unless given; maa3_tpu/system.py:508-538):
    the rows are independent, so the result is the same. A video MoE DiT
    runs its own plan (models/dit_moe.py) and takes no masks."""
    b = x0.shape[0]
    chunk = ode_chunk() if chunk is None else chunk
    if chunk and b > chunk and b % chunk == 0:
        def rows(t, i):
            return None if t is None else t[i:i + chunk]

        return torch.cat([
            sample_planned(dit, x0[i:i + chunk], context[i:i + chunk],
                           uncond[i:i + chunk], guidance_scale, steps,
                           rows(context_mask, i), rows(uncond_mask, i),
                           compute_dtype, num_timesteps, chunk=0)
            for i in range(0, b, chunk)])
    ctx_in = torch.cat([uncond, context], dim=0)
    mask_in = dual_mask(context_mask, uncond_mask, uncond)
    t_ints = torch.as_tensor(cfm.planned_t_ints(steps, num_timesteps=num_timesteps),
                             device=x0.device)
    if isinstance(dit, MoEDiT):  # the video MoE (maa3_tpu/system.py:471-487)
        if mask_in is not None:
            raise ValueError("context masks are not supported for the video "
                             "MoE backbone (fixed-length features)")
        mplan = moe_dit_sample_plan(dit, t_ints, ctx_in, compute_dtype=compute_dtype)

        def moe_vel(x_in, s):
            return moe_dit_apply_planned(dit, x_in, mplan["mods"][s], mplan["final"][s],
                                         mplan["tidx"][s], mplan["yk"], mplan["yv"],
                                         mplan["freq_sliced"], compute_dtype)

        return cfm.sample_cfg_planned(moe_vel, x0, len(t_ints), guidance_scale,
                                      steps=steps)
    plan = dit_sample_plan(dit, t_ints, ctx_in, context_mask=mask_in,
                           compute_dtype=compute_dtype)

    def step_vel(x_in, s):
        return dit_apply_planned(dit, x_in, plan["mods"][s], plan["final"][s],
                                 plan["yk"], plan["yv"], y_mask=mask_in,
                                 compute_dtype=compute_dtype)

    return cfm.sample_cfg_planned(step_vel, x0, len(t_ints), guidance_scale,
                                  steps=steps)


class T2APipeline:
    """Text-to-audio generation over a DiT, a VAE decoder and a vocoder."""

    def __init__(self, dit: DiT, vae: AutoencoderKL, vocoder: BigVGAN,
                 scale_factor: float = 1.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.dit, self.vae, self.vocoder = dit, vae, vocoder
        self.scale_factor = float(scale_factor)
        self.compute_dtype = compute_dtype

    @classmethod
    def random_init(cls, generator: torch.Generator,
                    dit_cfg: DiTConfig = DiTConfig(),
                    vae_cfg: VAEConfig = VAEConfig(),
                    voc_cfg: BigVGANConfig = BigVGANConfig(),
                    device="cuda", **kw) -> "T2APipeline":
        with torch.device(device):
            dit, vae, voc = DiT(dit_cfg), AutoencoderKL(vae_cfg), BigVGAN(voc_cfg)
        return cls(dit_init_(dit, generator), vae_init_(vae, generator),
                   bigvgan_init_(voc, generator), **kw)

    @torch.no_grad()
    def decode_mel(self, z):
        """fp32 decode even when serving in bf16 (pipeline.py:77)."""
        with full_fp32():
            return vae_decode(self.vae, z / self.scale_factor)

    @torch.no_grad()
    def vocode(self, mel):
        with full_fp32():
            return bigvgan_apply(self.vocoder, mel, compute_dtype=self.compute_dtype)

    @torch.no_grad()
    def generate(self, context, uncond, generator: Optional[torch.Generator] = None,
                 latent_len: int = 312, guidance_scale: float = 5.0,
                 steps: int = 25, context_mask=None, uncond_mask=None,
                 x0: Optional[torch.Tensor] = None):
        """context/uncond: (B, Ly, ctx_dim) text embeddings. x0: the initial
        noise (B, C, latent_len); drawn from `generator` when not given.
        Returns (latent, mel, wav). 312 latent frames = 10 s at 16 kHz."""
        if x0 is None:
            x0 = torch.randn((context.shape[0], self.dit.cfg.in_channels, latent_len),
                             generator=generator, device=context.device)
        z = sample_planned(self.dit, x0.float(), context, uncond, guidance_scale,
                           steps, context_mask, uncond_mask, self.compute_dtype)
        mel = self.decode_mel(z)
        return z, mel, self.vocode(mel)

"""BigVGAN vocoder GAN training (counterpart of maa3_tpu/train/vocoder_gan.py):
MPD + MRD, the mse GAN losses, feature matching and the mel L1
(vocoder/bigvgan/models.py:255-391):

  L_G = mse_g(MPD) + mse_g(MRD) + FM(MPD) + FM(MRD) + 45 |mel(y) - mel(y_hat)|
  L_D = _mse_d(MPD) + _mse_d(MRD)

`_mse_d` sums over the discriminators, without mse_d_loss's 0.5 and
averaging, as the JAX trainer does. The generator step runs the vocoder on
the differentiable route (bigvgan_apply(kernels=False), JAX's
pallas_aa=False). The discriminator step's generator forward needs no
gradient (JAX's stop_gradient), so it takes the kernel route: on the card
K1 and K2 (72 and 37 launches for BigVGAN 1536 AMPBlock1), on the CPU their
plain versions, the same function. Optimizers: optax.adamw(lr, b1=0.8,
b2=0.99) of scripts/train_vocoder.py:69-70, whose weight decay is 1e-4.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from maa3_tpu_torch.models.bigvgan import BigVGAN, bigvgan_apply
from maa3_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                  MultiResolutionDiscriminator,
                                                  feature_matching_loss, mse_g_loss)
from maa3_tpu_torch.ops.stft import MelConfig, mel_spectrogram
from maa3_tpu_torch.train.vae_gan import apply_loss

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class VocoderGanState:
    gen: BigVGAN
    mpd: MultiPeriodDiscriminator
    mrd: MultiResolutionDiscriminator
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer  # over the MPD's and the MRD's parameters
    step: int = 0

    def disc_parameters(self):
        return [*self.mpd.parameters(), *self.mrd.parameters()]


def make_vocoder_optimizer(params, lr: float = 2e-4) -> torch.optim.Optimizer:
    """optax.adamw(lr, b1=0.8, b2=0.99): eps 1e-8, weight decay 1e-4."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.8, 0.99), eps=1e-8,
                             weight_decay=1e-4)


def create_vocoder_gan_state(gen: BigVGAN, mpd: MultiPeriodDiscriminator,
                             mrd: MultiResolutionDiscriminator,
                             lr: float = 2e-4) -> VocoderGanState:
    return VocoderGanState(gen, mpd, mrd, make_vocoder_optimizer(gen.parameters(), lr),
                           make_vocoder_optimizer([*mpd.parameters(), *mrd.parameters()],
                                                  lr))


def _mse_d(reals: Sequence[torch.Tensor], fakes: Sequence[torch.Tensor]):
    return sum(((1 - dr) ** 2).mean() + (dg ** 2).mean() for dr, dg in zip(reals, fakes))


def make_vocoder_gan_steps(mel_cfg: MelConfig, mel_weight: float = 45.0):
    """(gen_step, disc_step), each (state, batch) -> metrics, updating the
    state in place; batch: {"mel": (B, M, T) log-mel input, "wav": (B, T *
    hop) target}."""

    def gen_step(state: VocoderGanState, batch) -> Metrics:
        wav = batch["wav"]
        y_hat = bigvgan_apply(state.gen, batch["mel"], kernels=False)
        with torch.no_grad():
            mel_ref = mel_spectrogram(wav, mel_cfg)
            (_, mpd_fr), (_, mrd_fr) = state.mpd(wav), state.mrd(wav)
        mel_l1 = (mel_spectrogram(y_hat, mel_cfg) - mel_ref).abs().mean()
        mpd_f, mpd_ff = state.mpd(y_hat)
        mrd_f, mrd_ff = state.mrd(y_hat)
        g = mse_g_loss(mpd_f) + mse_g_loss(mrd_f)
        fm = feature_matching_loss(mpd_fr, mpd_ff) + feature_matching_loss(mrd_fr, mrd_ff)
        loss = g + fm + mel_weight * mel_l1
        apply_loss(state.gen_opt, loss, state.gen.parameters())
        state.step += 1
        return {"gen_loss": loss.detach(), "gen_adv": g.detach(), "fm": fm.detach(),
                "mel_l1": mel_l1.detach()}

    def disc_step(state: VocoderGanState, batch) -> Metrics:
        wav = batch["wav"]
        y_hat = bigvgan_apply(state.gen, batch["mel"])
        (mpd_r, _), (mpd_f, _) = state.mpd(wav), state.mpd(y_hat)
        (mrd_r, _), (mrd_f, _) = state.mrd(wav), state.mrd(y_hat)
        loss = _mse_d(mpd_r, mpd_f) + _mse_d(mrd_r, mrd_f)
        apply_loss(state.disc_opt, loss, state.disc_parameters())
        return {"disc_loss": loss.detach()}

    return gen_step, disc_step

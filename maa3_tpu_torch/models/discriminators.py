"""GAN discriminators and losses for VAE and vocoder training (counterpart of
maa3_tpu/models/discriminators.py).

- NLayerDiscriminator: the PatchGAN over (B, 1, 80, T) mels
  (ldm/modules/discriminator/model.py:98-152): stride-2 4x4 convs with
  BatchNorm and LeakyReLU(0.2); keys `main.{i}.*` as in the reference.
- MultiPeriodDiscriminator / MultiResolutionDiscriminator: BigVGAN's wav
  discriminators (vocoder/bigvgan/models.py:218-357), keys
  `discriminators.{i}.convs.{j}.*` and `.conv_post.*` (weight norm folded).
- MultiWindowDiscriminator: conv stacks over random time windows of a mel
  (ldm/modules/discriminator/multi_window_disc.py:6-197), keys as the JAX
  tree names them.

BatchNorm is train-mode only (ops/basic.BatchNorm2d without running
statistics): batch statistics with the biased variance and eps 1e-5, and
no buffers, as the JAX package computes it for GAN training.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maa3_tpu_torch.ops.basic import BatchNorm2d
from maa3_tpu_torch.ops.stft import reflect_pad, stft_magnitude

Logits = List[torch.Tensor]
FeatureMaps = List[List[torch.Tensor]]


class NLayerDiscriminator(nn.Module):
    """main: Conv(s2), LReLU, n_layers - 1 x [Conv(s2), BN, LReLU], Conv(s1),
    BN, LReLU, Conv(s1) -> patch logits (bias-less convs before BN)."""

    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            layers += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, stride, 1, bias=False),
                       BatchNorm2d(ndf * nf, running_stats=False), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * nf, 1, 4, 1, 1))
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        """x (B, C, H, W) -> patch logits (B, 1, H', W')."""
        return self.main(x)


class DiscriminatorP(nn.Module):
    """Period discriminator: the wav folded to (B, 1, T / p, p), five (5, 1)
    convs (stride 3 over time but the last) and a (3, 1) conv_post."""

    def __init__(self, period: int, d_mult: int = 1):
        super().__init__()
        self.period = period
        ch = [1, 32 * d_mult, 128 * d_mult, 512 * d_mult, 1024 * d_mult, 1024 * d_mult]
        self.convs = nn.ModuleList(
            nn.Conv2d(ch[i], ch[i + 1], (5, 1), (3 if i < 4 else 1, 1), (2, 0))
            for i in range(5))
        self.conv_post = nn.Conv2d(ch[-1], 1, (3, 1), 1, (1, 0))

    def forward(self, wav) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        b, t = wav.shape
        if t % self.period:  # reflect-pad to a multiple of the period
            pad = self.period - t % self.period
            wav = F.pad(wav[:, None], (0, pad), mode="reflect")[:, 0]
            t += pad
        x = wav.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.1)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorR(nn.Module):
    """Resolution discriminator over the rectangular-window STFT magnitude
    (B, 1, F, frames): four (3, 9) convs (stride 2 over frames but the
    first), a (3, 3) conv and a (3, 3) conv_post."""

    def __init__(self, resolution: Tuple[int, int, int], d_mult: int = 1):
        super().__init__()
        self.resolution = tuple(resolution)
        c = 32 * d_mult
        self.convs = nn.ModuleList([
            nn.Conv2d(1, c, (3, 9), 1, (1, 4)),
            nn.Conv2d(c, c, (3, 9), (1, 2), (1, 4)),
            nn.Conv2d(c, c, (3, 9), (1, 2), (1, 4)),
            nn.Conv2d(c, c, (3, 9), (1, 2), (1, 4)),
            nn.Conv2d(c, c, (3, 3), 1, (1, 1))])
        self.conv_post = nn.Conv2d(c, 1, (3, 3), 1, (1, 1))

    def forward(self, wav) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        n_fft, hop, win = self.resolution
        y = reflect_pad(wav, (n_fft - hop) // 2)
        x = stft_magnitude(y, n_fft, hop, win, window="ones")[:, None]
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.1)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


DEFAULT_PERIODS = (2, 3, 5, 7, 11)
DEFAULT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = DEFAULT_PERIODS, d_mult: int = 1):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p, d_mult) for p in periods)

    def forward(self, wav) -> Tuple[Logits, FeatureMaps]:
        outs = [d(wav) for d in self.discriminators]
        return [o[0] for o in outs], [o[1] for o in outs]


class MultiResolutionDiscriminator(nn.Module):
    def __init__(self, resolutions=DEFAULT_RESOLUTIONS, d_mult: int = 1):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorR(r, d_mult)
                                            for r in resolutions)

    def forward(self, wav) -> Tuple[Logits, FeatureMaps]:
        outs = [d(wav) for d in self.discriminators]
        return [o[0] for o in outs], [o[1] for o in outs]


class WindowBlock(nn.Module):
    def __init__(self, cin: int, hidden: int, bn: bool):
        super().__init__()
        self.conv = nn.Conv2d(cin, hidden, 3, 2, 1)
        if bn:
            self.bn = BatchNorm2d(hidden, running_stats=False)


class WindowDiscriminator(nn.Module):
    """Three [stride-2 3x3 conv, LReLU(0.2), BN but in the first] blocks over
    a (B, 1, time_length, freq_length) window, then a linear validity head."""

    def __init__(self, time_length: int, freq_length: int = 80, hidden: int = 128):
        super().__init__()
        self.blocks = nn.ModuleList(WindowBlock(1 if i == 0 else hidden, hidden, i > 0)
                                    for i in range(3))
        self.adv = nn.Linear(hidden * (time_length // 8) * ((freq_length + 7) // 8), 1)

    def forward(self, x):
        for blk in self.blocks:
            x = F.leaky_relu(blk.conv(x), 0.2)
            if hasattr(blk, "bn"):
                x = blk.bn(x)
        return self.adv(x.reshape(x.shape[0], -1))


class MultiWindowDiscriminator(nn.Module):
    def __init__(self, time_lengths: Sequence[int] = (32, 64, 128),
                 freq_length: int = 80, hidden: int = 128):
        super().__init__()
        self.time_lengths = tuple(time_lengths)
        self.discriminators = nn.ModuleList(WindowDiscriminator(t, freq_length, hidden)
                                            for t in time_lengths)

    def forward(self, mel, starts: Sequence[int]):
        """mel (B, T, F); starts: one window start per discriminator. Returns
        the summed validity (B, 1)."""
        total = 0.0
        for d, tl, s in zip(self.discriminators, self.time_lengths, starts):
            total = total + d(mel[:, None, s:s + tl, :])
        return total


@torch.no_grad()
def disc_init_(disc: nn.Module, generator: torch.Generator) -> nn.Module:
    """As the JAX package's _conv2d_init: conv weights N(0, 0.02), biases
    U(+-1/sqrt(fan_in)); BatchNorm weight 1, bias 0; the linear head
    xavier-uniform with zero bias (dense_init)."""
    for m in disc.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if m.bias is not None:
                bound = (m.in_channels * m.kernel_size[0] * m.kernel_size[1]) ** -0.5
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            limit = (6.0 / (m.in_features + m.out_features)) ** 0.5
            m.weight.uniform_(-limit, limit, generator=generator)
            m.bias.zero_()
    return disc


# ---------------------------------------------------------------------------
# GAN losses (ldm/modules/losses_audio/vqperceptual.py, models.py:360-391)
# ---------------------------------------------------------------------------

def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def mse_d_loss(reals: Sequence[torch.Tensor], fakes: Sequence[torch.Tensor]):
    r = sum(((1 - dr) ** 2).mean() for dr in reals) / len(reals)
    g = sum((df ** 2).mean() for df in fakes) / len(fakes)
    return 0.5 * (r + g)


def mse_g_loss(fakes: Sequence[torch.Tensor]):
    return sum(((1 - df) ** 2).mean() for df in fakes)


def feature_matching_loss(fmap_real: FeatureMaps, fmap_fake: FeatureMaps):
    return 2.0 * sum((rl - gl).abs().mean()
                     for dr, dg in zip(fmap_real, fmap_fake) for rl, gl in zip(dr, dg))


def adopt_weight(weight: float, global_step: int, threshold: int = 0) -> float:
    return 0.0 if global_step < threshold else weight

"""1-D mel KL-VAE: (B, 80, T) log-mel <-> (B, 20, T/2) latent, in fp32
(counterpart of maa3_tpu/models/vae1d.py).

Keys follow AutoencoderKL (autoencoder1d.py): encoder.conv_in,
encoder.down.{lvl}.block.{i}, encoder.down.{lvl}.downsample.conv,
encoder.mid.*, encoder.norm_out, encoder.conv_out, quant_conv, and on the
decode side decoder.conv_in, decoder.mid.{block_1,attn_1,block_2},
decoder.up.{lvl}.block.{i}, decoder.up.{lvl}.upsample.conv,
decoder.norm_out, decoder.conv_out and post_quant_conv. The encoder's blocks
use kernel_size; the decoder's res/up blocks use kernel 3 while its conv_in
and conv_out use kernel_size (the asymmetry the checkpoints bake in).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from maa3_tpu_torch.ops.basic import group_norm
from maa3_tpu_torch.ops.conv import conv1d


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 80
    out_ch: int = 80
    ch: int = 384
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_layers: Tuple[int, ...] = ()
    down_layers: Tuple[int, ...] = (0,)
    kernel_size: int = 5
    z_channels: int = 20
    double_z: bool = True
    embed_dim: int = 20

    @property
    def num_layers(self) -> int:
        return len(self.ch_mult)

    @property
    def downsample_rate(self) -> int:
        return 2 ** len(self.down_layers)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _gn(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-6)


def _norm(m: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return group_norm(x, m.weight, m.bias, m.num_groups, m.eps)


def _conv(m: nn.Conv1d, x, padding=0, stride=1):
    return conv1d(x, m.weight, m.bias, padding=padding, stride=stride)


class ResnetBlock1D(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.k = k
        self.norm1 = _gn(cin)
        self.conv1 = nn.Conv1d(cin, cout, k)
        self.norm2 = _gn(cout)
        self.conv2 = nn.Conv1d(cout, cout, k)
        if cin != cout:
            self.nin_shortcut = nn.Conv1d(cin, cout, 1)

    def forward(self, x):
        p = self.k // 2
        h = _conv(self.conv1, swish(_norm(self.norm1, x)), p)
        h = _conv(self.conv2, swish(_norm(self.norm2, h)), p)
        if hasattr(self, "nin_shortcut"):
            x = _conv(self.nin_shortcut, x)
        return x + h


class AttnBlock1D(nn.Module):
    """Single-head attention over time; logits scaled by channels^-0.5 (the
    reference's quirk, autoencoder1d.py:265-269)."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = _gn(ch)
        self.q = nn.Conv1d(ch, ch, 1)
        self.k = nn.Conv1d(ch, ch, 1)
        self.v = nn.Conv1d(ch, ch, 1)
        self.proj_out = nn.Conv1d(ch, ch, 1)

    def forward(self, x):
        h = _norm(self.norm, x)
        q, k, v = _conv(self.q, h), _conv(self.k, h), _conv(self.v, h)
        w = torch.softmax(torch.matmul(q.transpose(1, 2), k) * (q.shape[1] ** -0.5),
                          dim=-1)
        return x + _conv(self.proj_out, torch.matmul(v, w.transpose(1, 2)))


class Resample1D(nn.Module):
    """Holds the `conv` of an Upsample1D (2x nearest, then conv3) or a
    Downsample1D (stride-2 conv3 after a (0, 1) zero pad)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv1d(ch, ch, 3)


class Encoder1D(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        k = cfg.kernel_size
        self.conv_in = nn.Conv1d(cfg.in_channels, cfg.ch, k)
        in_mult = (1,) + tuple(cfg.ch_mult)
        levels = []
        for lvl in range(cfg.num_layers):
            block_in = cfg.ch * in_mult[lvl]
            block_out = cfg.ch * cfg.ch_mult[lvl]
            lvl_m = nn.Module()
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock1D(block_in, block_out, k))
                block_in = block_out
                if lvl in cfg.attn_layers:
                    attns.append(AttnBlock1D(block_in))
            lvl_m.block = nn.ModuleList(blocks)
            lvl_m.attn = nn.ModuleList(attns)
            if lvl in cfg.down_layers:
                lvl_m.downsample = Resample1D(block_in)
            levels.append(lvl_m)
        self.down = nn.ModuleList(levels)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock1D(block_in, block_in, k)
        self.mid.attn_1 = AttnBlock1D(block_in)
        self.mid.block_2 = ResnetBlock1D(block_in, block_in, k)
        self.norm_out = _gn(block_in)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = nn.Conv1d(block_in, out_ch, k)

    def forward(self, x):
        k = self.cfg.kernel_size
        h = _conv(self.conv_in, x, k // 2)
        for lp in self.down:
            for i, blk in enumerate(lp.block):
                h = blk(h)
                if len(lp.attn):
                    h = lp.attn[i](h)
            if hasattr(lp, "downsample"):
                h = _conv(lp.downsample.conv, h, (0, 1), stride=2)
        h = self.mid.block_1(h)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h)
        return _conv(self.conv_out, swish(_norm(self.norm_out, h)), k // 2)


class Decoder1D(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv1d(cfg.z_channels, block_in, cfg.kernel_size)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock1D(block_in, block_in, 3)
        self.mid.attn_1 = AttnBlock1D(block_in)
        self.mid.block_2 = ResnetBlock1D(block_in, block_in, 3)
        up_layers = tuple(d + 1 for d in cfg.down_layers)
        levels = [None] * cfg.num_layers
        for lvl in reversed(range(cfg.num_layers)):
            block_out = cfg.ch * cfg.ch_mult[lvl]
            lvl_m = nn.Module()
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock1D(block_in, block_out, 3))
                block_in = block_out
                if lvl in cfg.attn_layers:
                    attns.append(AttnBlock1D(block_in))
            lvl_m.block = nn.ModuleList(blocks)
            lvl_m.attn = nn.ModuleList(attns)
            if lvl in up_layers:
                lvl_m.upsample = Resample1D(block_in)
            levels[lvl] = lvl_m
        self.up = nn.ModuleList(levels)
        self.norm_out = _gn(block_in)
        self.conv_out = nn.Conv1d(block_in, cfg.out_ch, cfg.kernel_size)

    def forward(self, z):
        cfg = self.cfg
        k = cfg.kernel_size
        h = _conv(self.conv_in, z, k // 2)
        h = self.mid.block_1(h)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h)
        for lvl in reversed(range(cfg.num_layers)):
            lp = self.up[lvl]
            for i, blk in enumerate(lp.block):
                h = blk(h)
                if len(lp.attn):
                    h = lp.attn[i](h)
            if hasattr(lp, "upsample"):
                h = h.repeat_interleave(2, dim=-1)  # 2x nearest + conv3
                h = _conv(lp.upsample.conv, h, 1)
        return _conv(self.conv_out, swish(_norm(self.norm_out, h)), k // 2)


class AutoencoderKL(nn.Module):
    """encoder + quant_conv (encode), post_quant_conv + decoder (decode)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder1D(cfg)
        self.decoder = Decoder1D(cfg)
        zc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.quant_conv = nn.Conv1d(zc, 2 * cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv1d(cfg.embed_dim, cfg.z_channels, 1)


@torch.no_grad()
def vae_init_(vae: AutoencoderKL, generator: torch.Generator) -> AutoencoderKL:
    """Kaiming-uniform conv init (torch.nn.Conv1d's bounds), unit norms."""
    for m in vae.modules():
        if isinstance(m, nn.Conv1d):
            bound = (m.in_channels * m.kernel_size[0]) ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return vae


def decoder_apply(vae: AutoencoderKL, h: torch.Tensor) -> torch.Tensor:
    return vae.decoder(h.float())


def vae_decode(vae: AutoencoderKL, z: torch.Tensor) -> torch.Tensor:
    """z (B, embed_dim, T/2) -> mel (B, 80, T), in fp32."""
    return decoder_apply(vae, _conv(vae.post_quant_conv, z.float()))


def vae_encode_moments(vae: AutoencoderKL, x: torch.Tensor) -> torch.Tensor:
    """mel (B, 80, T) -> posterior moments (B, 2 * embed_dim, T/2), in fp32."""
    return _conv(vae.quant_conv, vae.encoder(x.float()))


def gaussian_sample(moments: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DiagonalGaussianDistribution.sample() (logvar clamped to [-30, 20])
    with N(0, 1) noise drawn from `generator`, or the given `noise`."""
    mean, logvar = moments.chunk(2, dim=1)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    return mean + std * noise


def gaussian_kl(moments: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, 1)) of the posterior (logvar clamped to [-30, 20]),
    summed over (C, T): one value per sample."""
    mean, logvar = moments.chunk(2, dim=1)
    logvar = logvar.clamp(-30.0, 20.0)
    return 0.5 * (mean * mean + torch.exp(logvar) - 1.0 - logvar).sum(dim=(1, 2))

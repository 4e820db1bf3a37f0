"""Legacy 2-D VAE family: KL and VQ autoencoders over (B, 1, M, T) mels
(counterpart of maa3_tpu/models/vae2d.py; the reference's
ldm/models/autoencoder.py AutoencoderKL:305 and VQModel:14 over the 2-D
Encoder / Decoder of ldm/modules/diffusionmodules/model.py:368-517).

Conv-resnet stacks with GroupNorm (32 groups, eps 1e-6) and swish,
stride-2 downsamples after a (0, 1, 0, 1) zero pad, 2x nearest upsamples,
optional self-attention at the chosen resolutions, a mid attention block;
VQ quantizes to the nearest codebook row with a straight-through gradient.
Keys follow the reference: encoder.*, decoder.*, quant_conv,
post_quant_conv and, for VQ, quantize.embedding.weight. fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maa3_tpu_torch.ops.basic import group_norm


@dataclasses.dataclass(frozen=True)
class VAE2DConfig:
    in_channels: int = 1
    out_ch: int = 1
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    z_channels: int = 4
    double_z: bool = True
    embed_dim: int = 4
    resolution: int = 80          # the frequency axis; drives attn_resolutions
    n_embed: int = 0              # > 0: the VQ model

    @property
    def num_levels(self) -> int:
        return len(self.ch_mult)


class GroupNorm(nn.Module):
    """GroupNorm's weight and bias, applied with ops.basic.group_norm: the
    groups split the flattened (C, H, W) positions, so C need not divide by
    them (JAX's reshape to (B, G, -1), which nn.GroupNorm refuses)."""

    def __init__(self, groups: int, ch: int, eps: float):
        super().__init__()
        self.num_groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)


def _gn(c: int) -> GroupNorm:
    return GroupNorm(32, c, 1e-6)



def _swish(x):
    return x * torch.sigmoid(x)


def _conv(m: nn.Conv2d, x, stride: int = 1, padding: int = 1):
    return F.conv2d(x, m.weight, m.bias, stride=stride, padding=padding)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _gn(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3)
        self.norm2 = _gn(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = _conv(self.conv1, _swish(self.norm1(x)))
        h = _conv(self.conv2, _swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = _conv(self.nin_shortcut, x, padding=0)
        return x + h


class AttnBlock2D(nn.Module):
    """Single-head attention over the H x W positions, logits scaled by
    channels^-0.5."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = _gn(ch)
        self.q = nn.Conv2d(ch, ch, 1)
        self.k = nn.Conv2d(ch, ch, 1)
        self.v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q, k, v = (_conv(m, hn, padding=0).reshape(b, c, h * w)
                   for m in (self.q, self.k, self.v))
        wts = torch.softmax(torch.matmul(q.transpose(1, 2), k) * c ** -0.5, dim=-1)
        out = torch.matmul(v, wts.transpose(1, 2)).reshape(b, c, h, w)
        return x + _conv(self.proj_out, out, padding=0)


class Resample2D(nn.Module):
    """Holds the `conv` of a Downsample (stride 2 after the (0, 1) pad) or
    an Upsample (2x nearest, then conv3)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3)


def _mid(ch: int) -> nn.Module:
    m = nn.Module()
    m.block_1 = ResnetBlock2D(ch, ch)
    m.attn_1 = AttnBlock2D(ch)
    m.block_2 = ResnetBlock2D(ch, ch)
    return m


def _mid_apply(m: nn.Module, h):
    return m.block_2(m.attn_1(m.block_1(h)))


class Encoder2D(nn.Module):
    def __init__(self, cfg: VAE2DConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3)
        in_mult = (1,) + tuple(cfg.ch_mult)
        res = cfg.resolution
        levels = []
        for lvl in range(cfg.num_levels):
            block_in, block_out = cfg.ch * in_mult[lvl], cfg.ch * cfg.ch_mult[lvl]
            lvl_m = nn.Module()
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock2D(block_in, block_out))
                block_in = block_out
                if res in cfg.attn_resolutions:
                    attns.append(AttnBlock2D(block_in))
            lvl_m.block, lvl_m.attn = nn.ModuleList(blocks), nn.ModuleList(attns)
            if lvl != cfg.num_levels - 1:
                lvl_m.downsample = Resample2D(block_in)
                res //= 2
            levels.append(lvl_m)
        self.down = nn.ModuleList(levels)
        self.mid = _mid(block_in)
        self.norm_out = _gn(block_in)
        self.conv_out = nn.Conv2d(block_in, 2 * cfg.z_channels if cfg.double_z
                                  else cfg.z_channels, 3)

    def forward(self, x):
        h = _conv(self.conv_in, x)
        for lp in self.down:
            for i, blk in enumerate(lp.block):
                h = blk(h)
                if len(lp.attn):
                    h = lp.attn[i](h)
            if hasattr(lp, "downsample"):
                h = _conv(lp.downsample.conv, F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
        h = _mid_apply(self.mid, h)
        return _conv(self.conv_out, _swish(self.norm_out(h)))


class Decoder2D(nn.Module):
    def __init__(self, cfg: VAE2DConfig):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3)
        self.mid = _mid(block_in)
        levels = [None] * cfg.num_levels
        for lvl in reversed(range(cfg.num_levels)):
            block_out = cfg.ch * cfg.ch_mult[lvl]
            lvl_m = nn.Module()
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock2D(block_in, block_out))
                block_in = block_out
            lvl_m.block = nn.ModuleList(blocks)
            if lvl != 0:
                lvl_m.upsample = Resample2D(block_in)
            levels[lvl] = lvl_m
        self.up = nn.ModuleList(levels)
        self.norm_out = _gn(block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3)

    def forward(self, z):
        h = _mid_apply(self.mid, _conv(self.conv_in, z))
        for lp in reversed(self.up):
            for blk in lp.block:
                h = blk(h)
            if hasattr(lp, "upsample"):
                h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                h = _conv(lp.upsample.conv, h)
        return _conv(self.conv_out, _swish(self.norm_out(h)))


class VAE2D(nn.Module):
    """AutoencoderKL (n_embed 0) or VQModel (n_embed > 0) of the 2-D family."""

    def __init__(self, cfg: VAE2DConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder2D(cfg)
        self.decoder = Decoder2D(cfg)
        if cfg.n_embed > 0:
            self.quant_conv = nn.Conv2d(cfg.z_channels, cfg.embed_dim, 1)
            self.quantize = nn.Module()
            self.quantize.embedding = nn.Embedding(cfg.n_embed, cfg.embed_dim)
        else:
            self.quant_conv = nn.Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)


@torch.no_grad()
def vae2d_init_(vae: VAE2D, generator: torch.Generator) -> VAE2D:
    """As vae2d_init: conv weights U(+-1/sqrt(fan_in)) with zero bias, unit
    norms, the codebook U(+-1/n_embed)."""
    for m in vae.modules():
        if isinstance(m, nn.Conv2d):
            bound = (m.in_channels * m.kernel_size[0] * m.kernel_size[1]) ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.zero_()
        elif isinstance(m, GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.uniform_(-1.0 / m.num_embeddings, 1.0 / m.num_embeddings,
                              generator=generator)
    return vae


def vae2d_encode_moments(vae: VAE2D, x: torch.Tensor) -> torch.Tensor:
    """(B, 1, M, T) -> the KL posterior's moments (B, 2 embed_dim, M/f, T/f),
    or the VQ model's pre-quantization latent (B, embed_dim, ...)."""
    return _conv(vae.quant_conv, vae.encoder(x.float()), padding=0)


def vae2d_decode(vae: VAE2D, z: torch.Tensor) -> torch.Tensor:
    return vae.decoder(_conv(vae.post_quant_conv, z.float(), padding=0))


def vq_quantize(codebook: torch.Tensor, z: torch.Tensor):
    """Nearest-codebook quantization with the straight-through estimator:
    z (B, C, H, W) -> (z_q, indices (B, H, W), commit + 0.25 embed loss)."""
    b, c, h, w = z.shape
    flat = z.permute(0, 2, 3, 1).reshape(-1, c)
    d = (flat.square().sum(-1, keepdim=True) - 2 * flat @ codebook.T
         + codebook.square().sum(-1)[None])
    idx = d.argmin(dim=-1)
    zq = codebook[idx].reshape(b, h, w, c).permute(0, 3, 1, 2)
    commit = (zq.detach() - z).square().mean()
    embed = (zq - z.detach()).square().mean()
    return z + (zq - z).detach(), idx.reshape(b, h, w), commit + 0.25 * embed

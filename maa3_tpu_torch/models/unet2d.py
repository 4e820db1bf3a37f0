"""Legacy 2-D UNet backbone: OpenAI's UNet with spatial-transformer cross
attention (counterpart of maa3_tpu/models/unet2d.py; the reference's
ldm/modules/diffusionmodules/openaimodel.py UNetModel and
ldm/modules/attention.py:152 SpatialTransformer):

  x (B, C, H, W), t (B,), context (B, L, D)
  -> conv_in -> down levels [ResBlock (timestep FiLM) + optional
  SpatialTransformer; stride-2 downsample] -> middle (Res + ST + Res) ->
  up levels with skip concats and 2x nearest upsamples ->
  GroupNorm / silu / conv_out.

GroupNorm here takes min(32, C) groups and eps 1e-5 (the 2-D VAE's always
takes 32 and 1e-6). Attention is plain: fp32 scores, softmax, a matmul.
Keys follow the JAX tree (temb1, temb2, film_emb, conv_in,
down.{l}.{res, attn}.{i}, down.{l}.down, mid.{res1, attn, res2},
up.{j}.{res, attn}.{i}, up.{j}.up, norm_out, conv_out); a level without
transformers has an empty attn list. fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maa3_tpu_torch.models.vae2d import GroupNorm
from maa3_tpu_torch.ops.basic import layer_norm, linear, silu, timestep_embedding


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 64
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attention_levels: Tuple[int, ...] = (1, 2)   # levels with transformers
    num_heads: int = 4
    context_dim: Optional[int] = None            # None: self-attention only
    transformer_depth: int = 1
    film_dim: Optional[int] = None               # a FiLM / class embedding added
                                                 # to the timestep embedding
                                                 # (AudioLDM's 'film'
                                                 # conditioning, ddpm.py:1429-1431)


def _gn(c: int) -> GroupNorm:
    return GroupNorm(min(32, c), c, 1e-5)



def _conv(m: nn.Conv2d, x, stride: int = 1, padding: int = 1):
    return F.conv2d(x, m.weight, m.bias, stride=stride, padding=padding)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int):
        super().__init__()
        self.norm1 = _gn(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3)
        self.temb = nn.Linear(temb_dim, cout)
        self.norm2 = _gn(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3)     # zero at init
        if cin != cout:
            self.skip = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb):
        h = _conv(self.conv1, silu(self.norm1(x)))
        h = h + linear(self.temb, silu(temb))[:, :, None, None]
        h = _conv(self.conv2, silu(self.norm2(h)))
        if hasattr(self, "skip"):
            x = _conv(self.skip, x, padding=0)
        return x + h


class TransformerBlock(nn.Module):
    def __init__(self, c: int, ctx_dim: Optional[int]):
        super().__init__()
        kv = ctx_dim or c
        self.ln1, self.ln2, self.ln3 = nn.LayerNorm(c), nn.LayerNorm(c), nn.LayerNorm(c)
        self.q1, self.k1, self.v1 = (nn.Linear(c, c, bias=False) for _ in range(3))
        self.o1 = nn.Linear(c, c)
        self.q2 = nn.Linear(c, c, bias=False)
        self.k2, self.v2 = nn.Linear(kv, c, bias=False), nn.Linear(kv, c, bias=False)
        self.o2 = nn.Linear(c, c)
        self.ff1, self.ff2 = nn.Linear(c, 4 * c), nn.Linear(4 * c, c)


class SpatialTransformer(nn.Module):
    def __init__(self, c: int, ctx_dim: Optional[int], depth: int):
        super().__init__()
        self.norm = _gn(c)
        self.proj_in = nn.Conv2d(c, c, 1)
        self.blocks = nn.ModuleList(TransformerBlock(c, ctx_dim) for _ in range(depth))
        self.proj_out = nn.Conv2d(c, c, 1)        # zero at init


def _ln(m: nn.LayerNorm, x):
    return layer_norm(x, m.weight, m.bias)       # eps 1e-6, as the JAX package's


def _mha(q, k, v, n_heads: int):
    """Plain multi-head attention with fp32 scores."""
    b, lq, c = q.shape
    hd = c // n_heads
    q, k, v = (a.reshape(b, -1, n_heads, hd).transpose(1, 2) for a in (q, k, v))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    o = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
    return o.transpose(1, 2).reshape(b, lq, c)


def spatial_transformer(st: SpatialTransformer, x, context, n_heads: int):
    b, c, h, w = x.shape
    y = _conv(st.proj_in, st.norm(x), padding=0)
    y = y.reshape(b, c, h * w).transpose(1, 2)   # (B, HW, C)
    for bp in st.blocks:
        z = _ln(bp.ln1, y)
        y = y + linear(bp.o1, _mha(linear(bp.q1, z), linear(bp.k1, z), linear(bp.v1, z),
                                   n_heads))
        z = _ln(bp.ln2, y)
        ctx = context if context is not None else z
        y = y + linear(bp.o2, _mha(linear(bp.q2, z), linear(bp.k2, ctx),
                                   linear(bp.v2, ctx), n_heads))
        z = _ln(bp.ln3, y)
        y = y + linear(bp.ff2, F.gelu(linear(bp.ff1, z), approximate="tanh"))
    y = y.transpose(1, 2).reshape(b, c, h, w)
    return x + _conv(st.proj_out, y, padding=0)


class UNet2D(nn.Module):
    def __init__(self, cfg: UNet2DConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        temb_dim = 4 * mc

        def st(ch):
            return SpatialTransformer(ch, cfg.context_dim, cfg.transformer_depth)

        self.temb1 = nn.Linear(mc, temb_dim)
        self.temb2 = nn.Linear(temb_dim, temb_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, mc, 3)
        if cfg.film_dim:
            self.film_emb = nn.Linear(cfg.film_dim, temb_dim)
        downs, ch, chans = [], mc, [mc]
        for lvl, mult in enumerate(cfg.channel_mult):
            level, res, attn = nn.Module(), [], []
            for _ in range(cfg.num_res_blocks):
                res.append(ResBlock(ch, mc * mult, temb_dim))
                ch = mc * mult
                if lvl in cfg.attention_levels:
                    attn.append(st(ch))
                chans.append(ch)
            level.res, level.attn = nn.ModuleList(res), nn.ModuleList(attn)
            if lvl != len(cfg.channel_mult) - 1:
                level.down = nn.Conv2d(ch, ch, 3)
                chans.append(ch)
            downs.append(level)
        self.down = nn.ModuleList(downs)
        self.mid = nn.Module()
        self.mid.res1 = ResBlock(ch, ch, temb_dim)
        self.mid.attn = st(ch)
        self.mid.res2 = ResBlock(ch, ch, temb_dim)
        ups = []
        for lvl, mult in reversed(list(enumerate(cfg.channel_mult))):
            level, res, attn = nn.Module(), [], []
            for _ in range(cfg.num_res_blocks + 1):
                res.append(ResBlock(ch + chans.pop(), mc * mult, temb_dim))
                ch = mc * mult
                if lvl in cfg.attention_levels:
                    attn.append(st(ch))
            level.res, level.attn = nn.ModuleList(res), nn.ModuleList(attn)
            if lvl != 0:
                level.up = nn.Conv2d(ch, ch, 3)
            ups.append(level)
        self.up = nn.ModuleList(ups)
        self.norm_out = _gn(ch)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3)   # zero at init


@torch.no_grad()
def unet2d_init_(unet: UNet2D, generator: torch.Generator) -> UNet2D:
    """As unet2d_init: dense weights Xavier-uniform with zero bias, conv
    weights U(+-1/sqrt(fan_in)) with zero bias, unit norms; each ResBlock's
    conv2, each transformer's proj_out and conv_out zero (openaimodel's
    zero_module)."""
    zero = {id(m.conv2) for m in unet.modules() if isinstance(m, ResBlock)}
    zero |= {id(m.proj_out) for m in unet.modules() if isinstance(m, SpatialTransformer)}
    zero.add(id(unet.conv_out))
    for m in unet.modules():
        if isinstance(m, nn.Linear):
            limit = (6.0 / (m.in_features + m.out_features)) ** 0.5
            m.weight.uniform_(-limit, limit, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            bound = (m.in_channels * m.kernel_size[0] * m.kernel_size[1]) ** -0.5
            if id(m) in zero:
                m.weight.zero_()
            else:
                m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.zero_()
        elif isinstance(m, (GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return unet


def unet2d_apply(unet: UNet2D, x: torch.Tensor, t: torch.Tensor,
                 context: Optional[torch.Tensor] = None,
                 film: Optional[torch.Tensor] = None) -> torch.Tensor:
    """eps (B, out_channels, H, W) of x at integer timesteps t; `context`
    feeds the cross-attention, `film` (B, film_dim) joins the timestep
    embedding (the reference UNet's y / label_emb route)."""
    cfg = unet.cfg
    temb = timestep_embedding(t, cfg.model_channels)
    temb = linear(unet.temb2, silu(linear(unet.temb1, temb)))
    if film is not None:
        temb = temb + linear(unet.film_emb, film)

    def res_attn(level, i, h):
        h = level.res[i](h, temb)
        if len(level.attn):
            h = spatial_transformer(level.attn[i], h, context, cfg.num_heads)
        return h

    h = _conv(unet.conv_in, x)
    skips = [h]
    for level in unet.down:
        for i in range(len(level.res)):
            h = res_attn(level, i, h)
            skips.append(h)
        if hasattr(level, "down"):
            h = _conv(level.down, F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
            skips.append(h)
    h = unet.mid.res1(h, temb)
    h = spatial_transformer(unet.mid.attn, h, context, cfg.num_heads)
    h = unet.mid.res2(h, temb)
    for level in unet.up:
        for i in range(len(level.res)):
            h = res_attn(level, i, torch.cat([h, skips.pop()], dim=1))
        if hasattr(level, "up"):
            h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            h = _conv(level.up, h)
    return _conv(unet.conv_out, silu(unet.norm_out(h)))

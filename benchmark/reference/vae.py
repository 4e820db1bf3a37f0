"""The 1-D mel KL autoencoder of Make-An-Audio 3 (autoencoder1d.py): the
encoder to the posterior moments, the decoder from a latent, in fp32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .core import silu


def _conv(sd, name, x, pad=None, stride=1):
    w = sd[name + ".weight"]
    if pad is None:
        pad = w.shape[-1] // 2
    if isinstance(pad, tuple):
        x, pad = F.pad(x, pad), 0
    return F.conv1d(x, w, sd[name + ".bias"], stride=stride, padding=pad)


def _gn(sd, name, x):
    return F.group_norm(x, 32, sd[name + ".weight"], sd[name + ".bias"], 1e-6)


def _resnet(sd, p, x):
    h = _conv(sd, p + "conv1", silu(_gn(sd, p + "norm1", x)))
    h = _conv(sd, p + "conv2", silu(_gn(sd, p + "norm2", h)))
    if p + "nin_shortcut.weight" in sd:
        x = _conv(sd, p + "nin_shortcut", x)
    return x + h


def _attn(sd, p, x):
    h = _gn(sd, p + "norm", x)
    q, k, v = (_conv(sd, p + n, h) for n in ("q", "k", "v"))
    w = torch.softmax(torch.bmm(q.transpose(1, 2), k) * q.shape[1] ** -0.5, dim=-1)
    return x + _conv(sd, p + "proj_out", torch.bmm(v, w.transpose(1, 2)))


def _levels(sd, p):
    n = 0
    while f"{p}.{n}.block.0.conv1.weight" in sd:
        n += 1
    return n


def _stage(sd, p, h):
    i = 0
    while f"{p}block.{i}.conv1.weight" in sd:
        h = _resnet(sd, f"{p}block.{i}.", h)
        if f"{p}attn.{i}.q.weight" in sd:
            h = _attn(sd, f"{p}attn.{i}.", h)
        i += 1
    return h


def _mid(sd, p, h):
    h = _resnet(sd, p + "mid.block_1.", h)
    h = _attn(sd, p + "mid.attn_1.", h)
    return _resnet(sd, p + "mid.block_2.", h)


def encode_moments(sd, mel):
    """mel (B, 80, T) -> the posterior (mean, logvar) stacked, (B, 40, T/2)."""
    h = _conv(sd, "encoder.conv_in", mel)
    for lvl in range(_levels(sd, "encoder.down")):
        p = f"encoder.down.{lvl}."
        h = _stage(sd, p, h)
        if p + "downsample.conv.weight" in sd:
            h = _conv(sd, p + "downsample.conv", h, pad=(0, 1), stride=2)
    h = _mid(sd, "encoder.", h)
    h = _conv(sd, "encoder.conv_out", silu(_gn(sd, "encoder.norm_out", h)))
    return _conv(sd, "quant_conv", h)


def decode(sd, z):
    """latent (B, 20, T/2) -> mel (B, 80, T)."""
    h = _conv(sd, "decoder.conv_in", _conv(sd, "post_quant_conv", z))
    h = _mid(sd, "decoder.", h)
    for lvl in reversed(range(_levels(sd, "decoder.up"))):
        p = f"decoder.up.{lvl}."
        h = _stage(sd, p, h)
        if p + "upsample.conv.weight" in sd:
            h = _conv(sd, p + "upsample.conv", torch.repeat_interleave(h, 2, dim=-1))
    return _conv(sd, "decoder.conv_out", silu(_gn(sd, "decoder.norm_out", h)))

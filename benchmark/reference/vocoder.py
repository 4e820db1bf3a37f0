"""BigVGAN (AMPBlock1 / AMPBlock2, snake or snake-beta through the
alias-free Activation1d of alias_free_torch: 2x kaiser-sinc upsampling with
a replicate pad, the activation, a 2x kaiser-sinc low-pass decimation),
weight norm folded, in fp32 with the exact sine."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def kaiser_sinc(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    even = kernel_size % 2 == 0
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = (np.arange(-half, half) + 0.5) if even else (np.arange(kernel_size) - half)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return filt / filt.sum()


FILT = kaiser_sinc(0.25, 0.3, 12)   # ratio 2, kernel 12, up and down


def alias_free(x: torch.Tensor, act) -> torch.Tensor:
    """UpSample1d(2) -> act -> DownSample1d(2) over (B, C, T)."""
    c = x.shape[1]
    f = torch.as_tensor(FILT, dtype=x.dtype, device=x.device)[None, None].expand(c, 1, 12)
    u = F.pad(x, (5, 5), mode="replicate")
    u = 2.0 * F.conv_transpose1d(u, f, stride=2, groups=c)[..., 15:-15]
    u = act(u)
    return F.conv1d(F.pad(u, (5, 6), mode="replicate"), f, stride=2, groups=c)


def _snake(sd, p, cfg):
    alpha = sd[p + "alpha"][None, :, None]
    beta = sd.get(p + "beta", sd[p + "alpha"])[None, :, None]
    if cfg["activation"] == "snake":
        beta = alpha
    if cfg.get("snake_logscale", True):
        alpha, beta = torch.exp(alpha), torch.exp(beta)
    return lambda v: v + 1.0 / (beta + 1e-9) * torch.sin(v * alpha) ** 2


def _act(sd, p, cfg, x):
    if cfg["activation"] == "lrelu":
        return F.leaky_relu(x, 0.1)
    return alias_free(x, _snake(sd, p + "act.", cfg))


def _conv(sd, name, x, dilation=1):
    w = sd[name + ".weight"]
    k = w.shape[-1]
    return F.conv1d(x, w, sd[name + ".bias"], padding=(k * dilation - dilation) // 2,
                    dilation=dilation)


def _resblock(sd, p, cfg, x, k, dils):
    if cfg["resblock"] == "1":
        for i, d in enumerate(dils):
            xt = _conv(sd, f"{p}convs1.{i}", _act(sd, f"{p}activations.{2 * i}.", cfg, x), d)
            xt = _conv(sd, f"{p}convs2.{i}", _act(sd, f"{p}activations.{2 * i + 1}.", cfg, xt))
            x = xt + x
    else:
        for i, d in enumerate(dils):
            x = _conv(sd, f"{p}convs.{i}", _act(sd, f"{p}activations.{i}.", cfg, x), d) + x
    return x


def vocode(sd, cfg, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, 80, T) -> wav (B, T * prod(upsample_rates))."""
    x = _conv(sd, "conv_pre", mel)
    kernels, dils = cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(x, sd[f"ups.{i}.0.weight"], sd[f"ups.{i}.0.bias"],
                               stride=u, padding=(k - u) // 2)
        xs = None
        for j, (rk, rd) in enumerate(zip(kernels, dils)):
            y = _resblock(sd, f"resblocks.{i * len(kernels) + j}.", cfg, x, rk, rd)
            xs = y if xs is None else xs + y
        x = xs / len(kernels)
    x = _conv(sd, "conv_post", _act(sd, "activation_post.", cfg, x))
    return torch.tanh(x)[:, 0, :]

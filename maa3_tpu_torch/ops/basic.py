"""Core tensor ops shared by every model (counterpart of maa3_tpu/ops/basic.py).

Weights keep torch's nn.Linear layout (out, in). `dense` follows the JAX
dtype rules: with a compute dtype both operands are cast to it; without one
the product runs in the promoted type of input and weight (a bf16-rounded
weight times an fp32 input computes in fp32). `dense(names=...)` runs its
matmul under checkpoint names (JAX's `checkpoint_name`), which the DiT's
remat policies read (models/dit.py `remat_policy_fn`).
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


_NAMES = threading.local()


def checkpoint_names() -> Tuple[str, ...]:
    """The names of the matmul running now on this thread (() outside a
    named dense)."""
    return getattr(_NAMES, "names", ())


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          compute_dtype: Optional[torch.dtype] = None,
          names: Tuple[str, ...] = ()) -> torch.Tensor:
    """y = x @ w.T + b, w in (out, in) layout; the matmul runs under `names`
    (a fused projection carries the names of each of its parts)."""
    dt = compute_dtype or torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    if names:
        _NAMES.names = names
        try:
            y = F.linear(x, w)
        finally:
            _NAMES.names = ()
    else:
        y = F.linear(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def linear(mod: nn.Linear, x: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return dense(x, mod.weight, mod.bias, compute_dtype)


class RMSNorm(nn.Module):
    """Holds the reference's `<name>.weight`; apply with rms_norm."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


def rms_norm(weight: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics; the result is cast back to x's dtype, then scaled by
    the weight in that dtype (flag_large_dit_moe.py:52-77)."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm for (B, C, T) with fp32 statistics over (C//G, T)."""
    b, c, t = x.shape
    xf = x.float().reshape(b, num_groups, (c // num_groups) * t)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, t)
    y = y * weight.float()[None, :, None] + bias.float()[None, :, None]
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """adaLN: x * (1 + scale) + shift, (B, D) broadcast over the sequence."""
    return (x * (1.0 + scale[:, None, :].to(x.dtype))
            + shift[:, None, :].to(x.dtype))


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding cat([cos, sin]) in fp32."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(max_period) * ar / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """MLP(freq_dim -> hidden -> hidden); keys t_embedder.mlp.{0,2}."""

    def __init__(self, hidden_size: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(nn.Linear(freq_dim, hidden_size), nn.SiLU(),
                                 nn.Linear(hidden_size, hidden_size))

    def forward(self, t: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        emb = timestep_embedding(t, self.freq_dim)
        h = silu(linear(self.mlp[0], emb, compute_dtype))
        return linear(self.mlp[2], h, compute_dtype)

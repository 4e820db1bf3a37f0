"""Next-DiT (Lumina-Next, TxtFlagLargeImprovedDiTV2 of Make-An-Audio 3) and
its classifier-free-guided flow-matching Euler ODE, in plain PyTorch.

x (B, C, T) -> proj_in -> depth x [adaLN(6): RoPE self-attention plus
tanh-gated cross-attention to the RMS-normed context, SwiGLU FFN, each added
through its adaLN gate] -> LayerNorm, adaLN(2), linear -> velocity (B, C, T).
The timestep embedding (sinusoid 256 -> MLP) plus the caption embedding
(LayerNorm of the context's mean over positions -> linear) drives every
modulation."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .core import attention, layer_norm, rms_norm, silu


def ffn_hidden(d: int, multiple_of: int = 256) -> int:
    h = int(2 * (4 * d) / 3)
    return multiple_of * ((h + multiple_of - 1) // multiple_of)


def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    a = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def rope(x: torch.Tensor) -> torch.Tensor:
    """Rotate each adjacent pair (x[2i], x[2i+1]) of (B, L, H, D) by
    position * 10000^(-2i/D)."""
    b, n, h, d = x.shape
    freqs = 1.0 / (10000.0 ** (torch.arange(0, d // 2, dtype=torch.float32,
                                             device=x.device) * 2.0 / d))
    ang = torch.outer(torch.arange(n, dtype=torch.float32, device=x.device), freqs)
    c, s = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    xr, xi = x.reshape(b, n, h, d // 2, 2).unbind(-1)
    return torch.stack([xr * c - xi * s, xr * s + xi * c], dim=-1).reshape(b, n, h, d)


def _lin(sd, name, x):
    return F.linear(x, sd[name + ".weight"], sd.get(name + ".bias"))


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def dit(sd, cfg, x, t_int, context, p=""):
    """x (B, C, T), t_int (B,) integer timesteps, context (B, Ly, ctx) ->
    the (B, C, T) velocity, unmasked as the served and trained paths run."""
    d, nh, eps = cfg["hidden_size"], cfg["num_heads"], cfg.get("norm_eps", 1e-5)
    hd = d // nh
    b, _, n = x.shape
    h = _lin(sd, p + "proj_in", x.transpose(1, 2))
    te = _lin(sd, p + "t_embedder.mlp.2",
              silu(_lin(sd, p + "t_embedder.mlp.0", timestep_embedding(t_int))))
    pooled = layer_norm(context.mean(dim=1), sd[p + "cap_embedder.0.weight"],
                        sd[p + "cap_embedder.0.bias"], 1e-5)
    adaln = silu(te + _lin(sd, p + "cap_embedder.1", pooled))
    scale = 1.0 / math.sqrt(hd)
    for i in range(cfg["depth"]):
        q = p + f"blocks.{i}."
        mod = _lin(sd, q + "adaLN_modulation.1", adaln)
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = mod.chunk(6, dim=-1)
        xa = modulate(rms_norm(h, sd[q + "attention_norm.weight"], eps), sh_a, sc_a)
        y = rms_norm(context, sd[q + "attention_y_norm.weight"], eps)

        def heads(t, name, n_tok):
            return _lin(sd, q + "attention." + name, t).reshape(b, n_tok, nh, hd)

        xq, xk = rope(heads(xa, "wq", n)), rope(heads(xa, "wk", n))
        xv = heads(xa, "wv", n)
        ly = context.shape[1]
        out = attention(xq.transpose(1, 2), xk.transpose(1, 2), xv.transpose(1, 2), scale)
        out_y = attention(xq.transpose(1, 2), heads(y, "wk_y", ly).transpose(1, 2),
                          heads(y, "wv_y", ly).transpose(1, 2), scale)
        gate = torch.tanh(sd[q + "attention.gate"])[None, :, None, None]
        a = (out + out_y * gate).transpose(1, 2).reshape(b, n, d)
        h = h + g_a[:, None, :] * _lin(sd, q + "attention.wo", a)
        xf = modulate(rms_norm(h, sd[q + "ffn_norm.weight"], eps), sh_f, sc_f)
        f = _lin(sd, q + "feed_forward.w2",
                 silu(_lin(sd, q + "feed_forward.w1", xf))
                 * _lin(sd, q + "feed_forward.w3", xf))
        h = h + g_f[:, None, :] * f
    shift, sc = _lin(sd, p + "final_layer.adaLN_modulation.1", adaln).chunk(2, dim=-1)
    h = modulate(layer_norm(h, eps=1e-6), shift, sc)
    return _lin(sd, p + "final_layer.linear", h).transpose(1, 2)


def euler_grid(steps: int):
    """(t_int, dt) of each Euler step: the fp32 grid linspace(0, 1, steps),
    the model's integer timestep floor(t * 1000), the fp32 step size."""
    g = np.arange(steps, dtype=np.float32) * (np.float32(1.0) / np.float32(steps - 1))
    g[-1] = 1.0
    return [(int(np.floor(a * np.float32(1000.0))), float(np.float32(b - a)))
            for a, b in zip(g[:-1], g[1:])]


@torch.no_grad()
def sample_cfg(sd, cfg, x0, context, uncond, guidance: float, steps: int):
    """The CFG Euler ODE over the dual batch [uncond; cond]."""
    x = x0
    ctx = torch.cat([uncond, context])
    for t, dt in euler_grid(steps):
        tt = torch.full((2 * x.shape[0],), t, dtype=torch.int64, device=x.device)
        e_uc, e_c = dit(sd, cfg, torch.cat([x, x]), tt, ctx).chunk(2)
        x = x + dt * (e_uc + guidance * (e_c - e_uc))
    return x

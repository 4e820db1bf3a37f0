"""Lumina-Next attention: RoPE self-attention plus zero-init gated
cross-attention (counterpart of maa3_tpu/ops/attention.py:89-169).

Self-attention is dense (`_sdpa`: plain matmuls, the (L, L) logits stored
in bf16 in bf16 mode with fp32 softmax statistics, as in JAX; kept in fp32
with `fp32_scores`) unless the
caller asks for flash attention (ops/flash_attention.py: K3a/K3b forward,
K4a backward), as the DiT does in training from 1248 tokens
(models/dit.py `flash_for_len`). Cross-attention is always dense. The
projections run under JAX's checkpoint names attn_q, attn_k, attn_v (one
fused wqkv matmul carries all three) and attn_out.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from maa3_tpu_torch.ops.basic import dense, layer_norm
from maa3_tpu_torch.ops.flash_attention import flash_attention
from maa3_tpu_torch.ops.rope import apply_rope

NEG_INF = -1e9  # finite mask value: no NaN rows for all-masked queries


class Attention(nn.Module):
    """Keys attention.{wq,wk,wv,wo,wk_y,wv_y,gate}[, q_norm, k_norm, ky_norm]."""

    def __init__(self, dim: int, n_heads: int, n_kv_heads: Optional[int] = None,
                 qk_norm: bool = False, y_dim: int = 0):
        super().__init__()
        n_kv = n_heads if n_kv_heads is None else n_kv_heads
        hd = dim // n_heads
        self.wq = nn.Linear(dim, n_heads * hd, bias=False)
        self.wk = nn.Linear(dim, n_kv * hd, bias=False)
        self.wv = nn.Linear(dim, n_kv * hd, bias=False)
        self.wo = nn.Linear(n_heads * hd, dim, bias=False)
        if y_dim > 0:
            self.wk_y = nn.Linear(y_dim, n_kv * hd, bias=False)
            self.wv_y = nn.Linear(y_dim, n_kv * hd, bias=False)
            self.gate = nn.Parameter(torch.zeros(n_heads))
        if qk_norm:
            self.q_norm = nn.LayerNorm(n_heads * hd, eps=1e-5)
            self.k_norm = nn.LayerNorm(n_kv * hd, eps=1e-5)
            if y_dim > 0:
                self.ky_norm = nn.LayerNorm(n_kv * hd, eps=1e-5)
        self.wqkv = None  # fused weight (models.dit serving_copy, fuse_dit_gemms)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
          mask: Optional[torch.Tensor], fp32_scores: bool = False) -> torch.Tensor:
    """Softmax attention on (B, L, H, D); mask: (B, Lk) bool, True = valid.
    In bf16 the logits are stored in bf16 unless fp32_scores
    (maa3_tpu/ops/attention.py:63-80)."""
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if fp32_scores:  # fp32 products of the bf16 inputs, never rounded to bf16
        qh, kh = qh.float(), kh.float()
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float() * scale
    if q.dtype == torch.bfloat16 and not fp32_scores:
        logits = logits.to(torch.bfloat16)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    out = torch.matmul(probs.to(v.dtype), vh)
    return out.transpose(1, 2).to(v.dtype)


def context_kv(att: Attention, y: torch.Tensor,
               compute_dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of an already rms-normed context y."""
    yk = dense(y, att.wk_y.weight, None, compute_dtype)
    if hasattr(att, "ky_norm"):
        yk = layer_norm(yk, att.ky_norm.weight, att.ky_norm.bias, eps=1e-5)
    yv = dense(y, att.wv_y.weight, None, compute_dtype)
    return yk, yv


def attention_apply(att: Attention, x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor, y: Optional[torch.Tensor] = None,
                    x_mask: Optional[torch.Tensor] = None,
                    y_mask: Optional[torch.Tensor] = None,
                    n_heads: int = 8, n_kv_heads: Optional[int] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    y_kv: Optional[tuple] = None,
                    use_flash: bool = False,
                    fp32_scores: bool = False) -> torch.Tensor:
    """x: (B, L, D); y: (B, Ly, y_dim) normed context, or y_kv: its
    precomputed (yk, yv), each (B, Ly, n_kv * head_dim). use_flash routes
    self-attention through the flash kernels; fp32_scores keeps the dense
    logits in fp32 in bf16 mode."""
    b, l, d = x.shape
    n_kv = n_heads if n_kv_heads is None else n_kv_heads
    hd = d // n_heads
    scale = 1.0 / math.sqrt(hd)
    if att.wqkv is not None:
        xq, xk, xv = dense(x, att.wqkv, None, compute_dtype,
                           names=("attn_q", "attn_k", "attn_v")).split(
            [n_heads * hd, n_kv * hd, n_kv * hd], dim=-1)
    else:
        xq = dense(x, att.wq.weight, None, compute_dtype, names=("attn_q",))
        xk = dense(x, att.wk.weight, None, compute_dtype, names=("attn_k",))
        xv = dense(x, att.wv.weight, None, compute_dtype, names=("attn_v",))
    if hasattr(att, "q_norm"):
        xq = layer_norm(xq, att.q_norm.weight, att.q_norm.bias, eps=1e-5)
        xk = layer_norm(xk, att.k_norm.weight, att.k_norm.bias, eps=1e-5)
    xq = xq.reshape(b, l, n_heads, hd)
    xk = xk.reshape(b, l, n_kv, hd)
    xv = xv.reshape(b, l, n_kv, hd)
    xq, xk = apply_rope(xq, xk, cos, sin)
    rep = n_heads // n_kv
    if rep > 1:  # GQA
        xk = xk.repeat_interleave(rep, dim=2)
        xv = xv.repeat_interleave(rep, dim=2)
    if use_flash:
        out = flash_attention(xq.transpose(1, 2), xk.transpose(1, 2),
                              xv.transpose(1, 2), mask=x_mask,
                              scale=scale).transpose(1, 2)
    else:
        out = _sdpa(xq, xk, xv, scale, x_mask, fp32_scores)

    if hasattr(att, "wk_y") and (y is not None or y_kv is not None):
        yk, yv = y_kv if y_kv is not None else context_kv(att, y, compute_dtype)
        ly = yk.shape[1]
        yk = yk.reshape(b, ly, n_kv, hd)
        yv = yv.reshape(b, ly, n_kv, hd)
        if rep > 1:
            yk = yk.repeat_interleave(rep, dim=2)
            yv = yv.repeat_interleave(rep, dim=2)
        out_y = _sdpa(xq, yk, yv, scale, y_mask, fp32_scores)
        gate = torch.tanh(att.gate.float()).to(out_y.dtype)
        out = out + out_y * gate[None, None, :, None]
    return dense(out.reshape(b, l, n_heads * hd), att.wo.weight, None,
                 compute_dtype, names=("attn_out",))

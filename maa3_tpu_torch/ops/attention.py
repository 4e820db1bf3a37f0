"""Lumina-Next attention: RoPE self-attention plus zero-init gated
cross-attention (counterpart of maa3_tpu/ops/attention.py:89-169).

Each of the two attentions is dense (`_sdpa`: plain matmuls, the logits
stored in bf16 in bf16 mode with fp32 softmax statistics, as in JAX; kept in
fp32 with `fp32_scores`) unless the caller asks for flash attention
(ops/flash_attention.py: K3a/K3b forward, K4a backward): `use_flash` for
self-attention, as the DiT does in training from 1248 tokens
(models/dit.py `flash_for_len`), and `cross_flash` for the cross-attention,
as the planned serving step does on the card for both
(models/dit.py `card_attention_route`). `calls` counts the calls of each
route. The projections run under JAX's checkpoint names attn_q, attn_k,
attn_v (one fused wqkv matmul carries all three) and attn_out.
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

# attention calls by kind and route (the serving span reads them: serving.py)
calls = {"self_flash": 0, "self_dense": 0, "cross_flash": 0, "cross_dense": 0}


def route_counts(since: dict) -> dict:
    """{"attn_flash", "attn_dense"}: the calls of each route, self and cross
    together, since `since` (a copy of `calls`)."""
    return {f"attn_{r}": sum(calls[k] - since[k] for k in calls if k.endswith(r))
            for r in ("flash", "dense")}


class Attention(nn.Module):
    """Keys attention.{wq,wk,wv,wo,wk_y,wv_y,gate}[, q_norm, k_norm, ky_norm]."""

    def __init__(self, dim: int, n_heads: int, n_kv_heads: Optional[int] = None,
                 qk_norm: bool = False, y_dim: int = 0):
        super().__init__()
        n_kv = n_heads if n_kv_heads is None else n_kv_heads
        hd = dim // n_heads
        self.head_dim = hd
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
    """Softmax attention on head-major (B, H, L, D); mask: (B, Lk) bool,
    True = valid. In bf16 the logits are stored in bf16 unless fp32_scores
    (maa3_tpu/ops/attention.py:63-80)."""
    qs, ks = (q.float(), k.float()) if fp32_scores else (q, k)
    # fp32_scores: fp32 products of the bf16 inputs, never rounded to bf16
    logits = torch.matmul(qs, ks.transpose(-1, -2)).float() * scale
    if q.dtype == torch.bfloat16 and not fp32_scores:
        logits = logits.to(torch.bfloat16)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(v.dtype)


def _head_norm(x: torch.Tensor, norm: nn.LayerNorm, tp=None) -> torch.Tensor:
    """qk_norm's LayerNorm over every head's features (all-reduced
    statistics when the heads are sharded over tp)."""
    if tp is not None:
        return tp.layer_norm(x, norm.weight, norm.bias, eps=1e-5)
    return layer_norm(x, norm.weight, norm.bias, eps=1e-5)


def context_kv(att: Attention, y: torch.Tensor,
               compute_dtype: Optional[torch.dtype] = None, tp=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of an already rms-normed context y (this rank's
    heads under tensor parallelism, parallel/tp.py), each a head-major
    (B, n_kv, Ly, head_dim) view, the layout the flash kernels read once
    made contiguous."""
    yk = dense(y, att.wk_y.weight, None, compute_dtype)
    if hasattr(att, "ky_norm"):
        yk = _head_norm(yk, att.ky_norm, tp)
    yv = dense(y, att.wv_y.weight, None, compute_dtype)
    b, ly, _ = y.shape
    return tuple(t.reshape(b, ly, -1, att.head_dim).transpose(1, 2) for t in (yk, yv))


def attention_apply(att: Attention, x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor, y: Optional[torch.Tensor] = None,
                    x_mask: Optional[torch.Tensor] = None,
                    y_mask: Optional[torch.Tensor] = None,
                    n_heads: int = 8, n_kv_heads: Optional[int] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    y_kv: Optional[tuple] = None,
                    use_flash: bool = False, cross_flash: bool = False,
                    fp32_scores: bool = False, tp=None) -> torch.Tensor:
    """x: (B, L, D); y: (B, Ly, y_dim) normed context, or y_kv: its
    precomputed (yk, yv) (context_kv: head-major (B, n_kv, Ly, head_dim)).
    use_flash / cross_flash route self- / cross-
    attention through the flash kernels (a query row whose keys are all
    masked gives 0 there, the mean of v dense); fp32_scores keeps the dense
    logits in fp32 in bf16 mode. With tp (parallel/tp.py) the weights are
    this rank's heads, and the result is this rank's partial sum of the
    output projection."""
    b, l, d = x.shape
    n_kv = n_heads if n_kv_heads is None else n_kv_heads
    hd = d // n_heads
    scale = 1.0 / math.sqrt(hd)
    if tp is not None:
        n_heads, n_kv = tp.local(n_heads), tp.local(n_kv)
    if att.wqkv is not None:
        xq, xk, xv = dense(x, att.wqkv, None, compute_dtype,
                           names=("attn_q", "attn_k", "attn_v")).split(
            [n_heads * hd, n_kv * hd, n_kv * hd], dim=-1)
    else:
        xq = dense(x, att.wq.weight, None, compute_dtype, names=("attn_q",))
        xk = dense(x, att.wk.weight, None, compute_dtype, names=("attn_k",))
        xv = dense(x, att.wv.weight, None, compute_dtype, names=("attn_v",))
    if hasattr(att, "q_norm"):
        xq = _head_norm(xq, att.q_norm, tp)
        xk = _head_norm(xk, att.k_norm, tp)
    xq = xq.reshape(b, l, n_heads, hd)
    xk = xk.reshape(b, l, n_kv, hd)
    xv = xv.reshape(b, l, n_kv, hd)
    xq, xk = apply_rope(xq, xk, cos, sin)
    rep = n_heads // n_kv
    if rep > 1:  # GQA
        xk = xk.repeat_interleave(rep, dim=2)
        xv = xv.repeat_interleave(rep, dim=2)
    cross = hasattr(att, "wk_y") and (y is not None or y_kv is not None)
    cross_flash = cross and cross_flash
    # (B, H, L, D): one copy of q for the flash calls, a view otherwise
    qh, kh, vh = xq.transpose(1, 2), xk.transpose(1, 2), xv.transpose(1, 2)
    if use_flash or cross_flash:
        qh = qh.contiguous()
    if use_flash:
        out = flash_attention(qh, kh, vh, mask=x_mask, scale=scale)
    else:
        out = _sdpa(qh, kh, vh, scale, x_mask, fp32_scores)
    calls["self_flash" if use_flash else "self_dense"] += 1

    if cross:
        if y_kv is None:  # copy-to-TP: y feeds this rank's column products
            y_kv = context_kv(att, y if tp is None else tp.copy(y), compute_dtype, tp)
        yk, yv = y_kv
        if rep > 1:
            yk = yk.repeat_interleave(rep, dim=1)
            yv = yv.repeat_interleave(rep, dim=1)
        if cross_flash:
            out_y = flash_attention(qh, yk, yv, mask=y_mask, scale=scale)
        else:
            out_y = _sdpa(qh, yk, yv, scale, y_mask, fp32_scores)
        calls["cross_flash" if cross_flash else "cross_dense"] += 1
        gate = torch.tanh(att.gate.float()).to(out_y.dtype)
        out = out + out_y * gate[None, :, None, None]
    return dense(out.transpose(1, 2).reshape(b, l, n_heads * hd), att.wo.weight, None,
                 compute_dtype, names=("attn_out",))

"""SwiGLU feed-forward network (counterpart of maa3_tpu/ops/ffn.py).
Keys feed_forward.{w1,w2,w3}; a serving copy may carry the fused `w13`
(gate and up projections stacked along the output axis), as does a DiT in
the fused training layout (models/dit.py `fuse_dit_gemms`). The projections
run under JAX's checkpoint names ffn_h1, ffn_h3 and ffn_out."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from maa3_tpu_torch.ops.basic import dense, silu


def swiglu_hidden_dim(dim: int, hidden_dim: Optional[int] = None,
                      multiple_of: int = 256,
                      ffn_dim_multiplier: Optional[float] = None) -> int:
    if hidden_dim is None:
        hidden_dim = 4 * dim
    hidden_dim = int(2 * hidden_dim / 3)
    if ffn_dim_multiplier is not None:
        hidden_dim = int(ffn_dim_multiplier * hidden_dim)
    return multiple_of * ((hidden_dim + multiple_of - 1) // multiple_of)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: Optional[int] = None,
                 multiple_of: int = 256,
                 ffn_dim_multiplier: Optional[float] = None):
        super().__init__()
        h = swiglu_hidden_dim(dim, hidden_dim, multiple_of, ffn_dim_multiplier)
        self.w1 = nn.Linear(dim, h, bias=False)
        self.w2 = nn.Linear(h, dim, bias=False)
        self.w3 = nn.Linear(dim, h, bias=False)
        self.w13 = None  # fused weight (models.dit serving_copy, fuse_dit_gemms)


def feed_forward_apply(ff: FeedForward, x: torch.Tensor,
                       compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    if ff.w13 is not None:
        x1, x3 = dense(x, ff.w13, None, compute_dtype,
                       names=("ffn_h1", "ffn_h3")).chunk(2, dim=-1)
    else:
        x1 = dense(x, ff.w1.weight, None, compute_dtype, names=("ffn_h1",))
        x3 = dense(x, ff.w3.weight, None, compute_dtype, names=("ffn_h3",))
    return dense(silu(x1) * x3, ff.w2.weight, None, compute_dtype, names=("ffn_out",))

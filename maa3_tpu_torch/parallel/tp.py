"""Tensor parallelism over the mesh's "model" group, Megatron style
(what GSPMD inserts for the JAX package from dit_param_specs' shardings).

Each rank holds its column shard of wq / wk / wv / wk_y / wv_y / w1 / w3
(n_heads / n_model local heads, hidden / n_model local FFN width), its row
shard of wo / w2 and its heads' gates; the flash kernels run unchanged on
the local heads. The collectives are autograd functions:

- copy-to-TP (identity forward, all-reduce backward) before every
  column-parallel product, and reduce-from-TP (all-reduce forward,
  identity backward) after every row-parallel one;
- with sequence parallelism (DiTConfig.seq_parallel) the residual stream
  between the products is sharded over the sequence: the all-reduce
  becomes a reduce-scatter over the sequence and the copy an all-gather,
  each with the other as its backward. A replicated tensor that acts on the
  sharded stream (the block norms' weights, adaLN's modulation) passes
  through copy-to-TP, so its gradient, a sum over this rank's tokens, is
  summed over the group (GSPMD gets this for free);
- qk_norm's LayerNorms span all n_heads * head_dim features, which are
  sharded: their per-token sums are all-reduced (forward and backward).

`shard_serving_dit_` turns a serving copy of the DiT (bf16, fused or not,
or int8) into this rank's shards. The fused wqkv / w13 are sharded part by
part: the rank's [q_r; k_r; v_r] and [w1_r; w3_r] rows, fused locally (the
same math: JAX keeps the unfused layout under TP because GSPMD's concat axis
would cross the shard boundaries, maa3_tpu/system.py:277-288). int8
weights are quantized before sharding, so the codes are one device's; a
row-parallel weight's per-token activation amax is all-reduced with MAX
and its int32 products with SUM (ops/quant.py dense_w8a8: exact, so the
block skips reduce-from-TP after it), and its groups (int8:g<N>) must not
cross a shard boundary.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from maa3_tpu_torch.parallel.mesh import Mesh, local_slice


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The sum over the group of x, this rank's shard of it along dim."""
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    rs = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    rs(out, xs, group=group)
    return out.movedim(0, dim)


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBoth(torch.autograd.Function):
    """A sum over the group of per-rank partial sums that each rank goes on
    to use on its own shard: all-reduce forward and backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_reduce(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp.group), None


class _GatherSeq(torch.autograd.Function):
    """Sequence-sharded stream -> full sequence for the column products."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_gather(x, 1, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, 1, ctx.tp.group, ctx.tp.size), None


class _ScatterSeq(torch.autograd.Function):
    """Row products' partial sums -> this rank's sequence shard of their sum."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _reduce_scatter(x, 1, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.tp.group, ctx.tp.size), None


class _SplitSeq(torch.autograd.Function):
    """A replicated full sequence -> this rank's shard (backward: gather)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return local_slice(x, 1, tp.rank, tp.size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.tp.group, ctx.tp.size), None


class _JoinSeq(torch.autograd.Function):
    """The sharded stream -> the full sequence a replicated layer reads
    (backward: this rank's shard of the replicated gradient)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_gather(x, 1, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, 1, ctx.tp.rank, ctx.tp.size).contiguous(), None


class TP:
    """This rank's place in the model group, and the collectives of a block."""

    def __init__(self, group, size: int, rank: int, seq_parallel: bool = False):
        self.group, self.size, self.rank = group, size, rank
        self.seq_parallel = seq_parallel

    def __deepcopy__(self, memo):  # a copy of a sharded module shares its group
        return self

    def with_seq_parallel(self, on: bool) -> "TP":
        return self if on == self.seq_parallel else TP(self.group, self.size,
                                                       self.rank, on)

    @classmethod
    def of(cls, mesh: Mesh) -> Optional["TP"]:
        """The mesh's model group as a TP, or None at n_model 1."""
        if mesh is None or mesh.n_model == 1:
            return None
        return cls(mesh.model_group, mesh.n_model, mesh.model_rank)

    def local(self, n: int) -> int:
        if n % self.size:
            raise ValueError(f"{n} heads / features do not divide over {self.size} ranks")
        return n // self.size

    def copy(self, x):
        return _Copy.apply(x, self)

    def reduce(self, x):
        return _Reduce.apply(x, self)

    def all_reduce(self, x):
        return _ReduceBoth.apply(x, self)

    def enter(self, x):
        """Before column-parallel products: copy (or gather the sequence)."""
        return _GatherSeq.apply(x, self) if self.seq_parallel else self.copy(x)

    def exit(self, x):
        """After row-parallel products: all-reduce (or reduce-scatter)."""
        return _ScatterSeq.apply(x, self) if self.seq_parallel else self.reduce(x)

    def on_stream(self, x):
        """A replicated tensor acting on the residual stream: under sequence
        parallelism its gradient is summed over the group."""
        return self.copy(x) if self.seq_parallel else x

    def split_seq(self, x):
        return _SplitSeq.apply(x, self) if self.seq_parallel else x

    def join_seq(self, x):
        return _JoinSeq.apply(x, self) if self.seq_parallel else x

    def feature_slice(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's features of a replicated full-width vector (its
        gradient summed over the group)."""
        return local_slice(self.copy(w), 0, self.rank, self.size)

    def layer_norm(self, x: torch.Tensor, weight, bias, eps: float = 1e-5) -> torch.Tensor:
        """ops/basic.layer_norm over the features of every rank, x holding
        this rank's: fp32 statistics from all-reduced sums."""
        width = x.shape[-1] * self.size
        xf = x.float()
        mean = self.all_reduce(xf.sum(-1, keepdim=True)) / width
        xc = xf - mean
        var = self.all_reduce(xc.pow(2).sum(-1, keepdim=True)) / width
        y = xc * torch.rsqrt(var + eps)
        y = y * self.feature_slice(weight).float() + self.feature_slice(bias).float()
        return y.to(x.dtype)


# -- the serving copy's shards ----------------------------------------------------------

def _shard_quant(qw, parts: int, row: bool, tp: TP):
    """A QuantWeight's shard: column weights slice every one of `parts`
    output blocks; a row weight slices its input (grouped: its groups)."""
    from maa3_tpu_torch.ops.quant import QuantWeight
    grouped = qw.group_size > 0
    w_q, w_s = qw.w_q, qw.w_scale
    if row:
        if grouped:
            if w_q.shape[0] % tp.size:
                raise ValueError(f"int8:g{qw.group_size}: {w_q.shape[0]} groups of the "
                                 f"row-parallel input do not divide over {tp.size} "
                                 "ranks (a group would cross a shard boundary)")
            w_q = local_slice(w_q, 0, tp.rank, tp.size)
            w_s = local_slice(w_s, 0, tp.rank, tp.size)
            out = QuantWeight(w_q.contiguous(), w_s.contiguous(), qw.group_size)
        else:
            out = QuantWeight(local_slice(w_q, 1, tp.rank, tp.size).contiguous(),
                              w_s.clone(), 0)
            out.amax_group = tp.group       # per-token amax over the full input
        return out
    dim = 1 if grouped else 0
    return QuantWeight(_col_parts(w_q, parts, tp, dim), _col_parts(w_s, parts, tp, dim),
                       qw.group_size)


def _col_parts(t: torch.Tensor, parts, tp: TP, dim: int = 0) -> torch.Tensor:
    """The rank's shard of each of the output blocks of t (sizes `parts`, or
    that many equal blocks), concatenated."""
    blocks = t.split(parts, dim) if isinstance(parts, list) else t.chunk(parts, dim)
    return torch.cat([local_slice(b, dim, tp.rank, tp.size) for b in blocks], dim).contiguous()


def _shard_weight(w, parts, row: bool, tp: TP):
    from maa3_tpu_torch.ops.quant import QuantWeight
    if isinstance(w, QuantWeight):
        return _shard_quant(w, parts, row, tp)
    if row:
        return local_slice(w, 1, tp.rank, tp.size).contiguous()
    return _col_parts(w, parts, tp)


@torch.no_grad()
def shard_serving_dit_(dit: nn.Module, tp: TP) -> nn.Module:
    """This rank's shards of a serving DiT (in place): column weights, fused
    or not, float or int8, row weights, gates; norms, adaLN and embedders
    stay whole. Sets dit.tp."""
    from maa3_tpu_torch.ops.ffn import FeedForward
    from maa3_tpu_torch.ops.quant import QuantLinear
    cfg = dit.cfg
    n_kv = cfg.num_heads if cfg.n_kv_heads is None else cfg.n_kv_heads
    for n in (cfg.num_heads, n_kv):
        tp.local(n)  # raises when the heads do not divide over the group
    hd = cfg.head_dim
    qkv = [cfg.num_heads * hd, n_kv * hd, n_kv * hd]

    def lin(m, row):
        if isinstance(m, QuantLinear):
            m.weight = _shard_weight(m.weight, 1, row, tp)
        else:
            m.weight.data = _shard_weight(m.weight.data, 1, row, tp)

    for blk in dit.blocks:
        att, ff = blk.attention, blk.feed_forward
        if att.wqkv is not None:
            att.wqkv = _shard_weight(att.wqkv, qkv, False, tp)
        else:
            for name in ("wq", "wk", "wv"):
                lin(getattr(att, name), False)
        lin(att.wo, True)
        if hasattr(att, "wk_y"):
            lin(att.wk_y, False)
            lin(att.wv_y, False)
            att.gate.data = local_slice(att.gate.data, 0, tp.rank, tp.size).contiguous()
        if not isinstance(ff, FeedForward):
            raise NotImplementedError("tensor-parallel serving of the video MoE is "
                                      "ROADMAP item 9b")
        if ff.w13 is not None:
            ff.w13 = _shard_weight(ff.w13, 2, False, tp)
        else:
            lin(ff.w1, False)
            lin(ff.w3, False)
        lin(ff.w2, True)
    dit.tp = tp
    return dit

"""ZeRO-3 over the mesh's data group (what add_fsdp_specs' shardings make
GSPMD do for the JAX package, maa3_tpu/train/loop.py:194-214).

Each parameter that add_fsdp_specs gives a "data" dim is stored as this
rank's shard along it, so the parameters, the AdamW moments and the EMA
shadows (made from the parameters) take 1/n_data of their bytes per rank.
`FSDP.gathered(module)` all-gathers a module's shards into whole tensors
for the span of its forward; the gather's backward reduce-scatters the
whole gradient into the shard's, averaged over the data ranks as the
replicated leaves' all-reduce is. The DiT gathers one block at a time
(inside the block's checkpoint under remat, so the backward gathers it
again) and its embedders and final layer for the whole forward.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.distributed as dist
from torch import nn

from maa3_tpu_torch.parallel.mesh import Mesh, Spec, shard_tensor, spec_dim
from maa3_tpu_torch.parallel.tp import _all_gather, _reduce_scatter


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, fsdp):
        ctx.dim, ctx.fsdp = dim, fsdp
        return _all_gather(shard, dim, fsdp.group, fsdp.n)

    @staticmethod
    def backward(ctx, g):
        f = ctx.fsdp
        return _reduce_scatter(g, ctx.dim, f.group, f.n) / f.n, None, None


class FSDP:
    """The data-sharded parameters of one module and their dims."""

    def __init__(self, module: nn.Module, specs: Dict[str, Spec], mesh: Mesh):
        self.group, self.n = mesh.data_group, mesh.n_data
        self.dims: Dict[int, int] = {}
        with torch.no_grad():
            for name, p in module.named_parameters():
                d = spec_dim(specs[name], "data")
                if d is not None and self.n > 1 and p.numel():  # (not another's expert)
                    p.data = shard_tensor(p.data, specs[name], mesh, ("data",))
                    self.dims[id(p)] = d

    def __deepcopy__(self, memo):
        return self

    def is_sharded(self, p: torch.Tensor) -> bool:
        return id(p) in self.dims

    @contextlib.contextmanager
    def gathered(self, *modules: nn.Module):
        """Inside: every sharded parameter of `modules` reads as its whole
        tensor (a differentiable all-gather of the shard)."""
        swapped = []
        try:
            for mod in modules:
                for sub in mod.modules():
                    for pname, p in list(sub._parameters.items()):
                        if p is not None and id(p) in self.dims:
                            sub._parameters[pname] = _Gather.apply(p, self.dims[id(p)], self)
                            swapped.append((sub, pname, p))
            yield
        finally:
            for sub, pname, p in swapped:
                sub._parameters[pname] = p


def gathered(fsdp, *modules):
    """fsdp.gathered(*modules), or nothing without FSDP."""
    return fsdp.gathered(*modules) if fsdp is not None else contextlib.nullcontext()


def average_grads(params, group, n: int) -> None:
    """Average the .grad of replicated parameters over the data group, in
    one flat all-reduce per dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= n
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])

"""GPipe pipeline parallelism of the text DiT over the "pipe" dim of a
("data", "pipe", "model") mesh (counterpart of maa3_tpu/parallel/pipeline.py).

Stage s owns blocks [s * depth / S, (s + 1) * depth / S) (mesh.add_pipe_specs;
the other stages hold no storage for them). Every stage runs the prologue
(proj_in, the t and caption embedders, adaLN's input) and the epilogue
(the final layer) on its data rank's whole local batch; the blocks run as
JAX's tick loop: the local batch is cut into n_micro contiguous microbatches
and M + S - 1 ticks run, in each of which

- stage 0 loads microbatch clip(tk, 0, M - 1);
- every stage applies its blocks to microbatch clip(tk - s, 0, M - 1) (the
  fill and drain ticks compute on a bubble lane that is never collected);
- the last stage collects its valid outputs;
- a ring shift hands each stage's output to stage (s + 1) % S.

Every stage runs the same ops in the same order, with the stage masks as
tensors (torch.where), so its autograd graph has the tick chain of every
other stage: the backward runs each ring shift's reverse shift on every rank
in the same order, which keeps NCCL's point-to-point calls matched.

The gradients at the boundary are explicit (JAX gets them from shard_map's
transpose): the inputs every stage reads (the residual stream, the context,
adaLN's input) enter through copy over "pipe" (identity forward, all-reduce
backward: their gradients, and with them those of proj_in, the embedders and
the conditioner, are the sum over the stages' uses), and the collected
outputs leave through a masked all-reduce over "pipe" (only the last stage
contributes; identity backward), so the final layer's gradient is the same on
every stage and is not summed. fp32 crosses the boundary (pipeline.py:132);
the ring shift carries the residual dtype. cfg.remat checkpoints each stage's
block loop per tick. The blocks keep dit.tp (Megatron over "model") inside a
stage.

The ring shift's transport: NCCL sends and receives the device tensors
(batch_isend_irecv); a gloo group (the CPU tests, and several processes on
one card) sends host copies, made explicitly here, since gloo's
point-to-point calls take host tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from maa3_tpu_torch.models.dit import (DiT, _cap_emb, _dit_block, _embed, _final, dit_apply,
                                       dit_route)
from maa3_tpu_torch.ops.basic import linear, silu
from maa3_tpu_torch.parallel.mesh import Mesh
from maa3_tpu_torch.parallel.tp import TP


def _shift(x: torch.Tensor, pipe: TP, step: int) -> torch.Tensor:
    """Send x to stage (s + step) % S; return what stage (s - step) % S sent."""
    group, n, s = pipe.group, pipe.size, pipe.rank
    dst = dist.get_global_rank(group, (s + step) % n)
    src = dist.get_global_rank(group, (s - step) % n)
    send = x.contiguous()
    if dist.get_backend(group) == "gloo":
        send = send.cpu()
    recv = torch.empty_like(send)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                        dist.P2POp(dist.irecv, recv, src, group)]):
        work.wait()
    return recv.to(x.device)


class _RingShift(torch.autograd.Function):
    """Forward: to stage s + 1, from s - 1; backward: the reverse."""

    @staticmethod
    def forward(ctx, x, pipe):
        ctx.pipe = pipe
        return _shift(x, pipe, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.pipe, -1), None


def _micro(a: Optional[torch.Tensor], m: int):
    """(B, ...) -> m contiguous microbatches of B / m rows."""
    return None if a is None else a.chunk(m)


def dit_apply_pipelined(dit: DiT, x: torch.Tensor, t: torch.Tensor,
                        context: torch.Tensor, mesh: Mesh, n_micro: int,
                        x_mask: Optional[torch.Tensor] = None,
                        context_mask: Optional[torch.Tensor] = None,
                        compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                        training: bool = False) -> torch.Tensor:
    """dit_apply with the blocks run as a GPipe pipeline over mesh's "pipe"
    group (maa3_tpu/parallel/pipeline.py:82). x, t, context and the masks
    are this data rank's rows; dit holds this stage's blocks (the others
    empty). Returns the (B, C, T) fp32 velocity on every stage. A pipe dim
    of 1 is dit_apply."""
    n_pipe, n_data = mesh.n_pipe, mesh.n_data
    if n_pipe == 1:
        return dit_apply(dit, x, t, context, x_mask=x_mask, context_mask=context_mask,
                         compute_dtype=compute_dtype, training=training)
    if getattr(dit, "fsdp", None) is not None:
        raise ValueError("n_pipe>1 + fsdp unsupported")
    cfg = dit.cfg
    route = dit_route(cfg, x.shape[-1], training)
    depth = len(dit.blocks)
    if depth % n_pipe:
        raise ValueError(f"depth {depth} is not divisible into n_pipe={n_pipe} stages")
    b, S, M = x.shape[0], n_pipe, n_micro
    if b % M:
        raise ValueError(f"batch {b * n_data} must divide data{n_data} x micro{M}")
    stage = mesh.pipe_rank
    per = depth // S
    blocks = list(dit.blocks)[stage * per:(stage + 1) * per]
    pipe = TP(mesh.pipe_group, S, stage)
    tp = getattr(dit, "tp", None)
    tp = tp and tp.with_seq_parallel(False)

    h, cos, sin = _embed(dit, x, compute_dtype)
    adaln = dit.t_embedder(t) + _cap_emb(dit, context, context_mask)
    res_dtype = h.dtype
    h_mb = _micro(pipe.copy(h.float()).to(res_dtype), M)
    y_mb = _micro(pipe.copy(context.float()).to(context.dtype), M)
    ada_mb = _micro(pipe.copy(adaln.float()), M)
    xm_mb, ym_mb = _micro(x_mask, M), _micro(context_mask, M)

    def stage_apply(state, y_m, ada_m, xm_m, ym_m):
        for blk in blocks:
            state = _dit_block(blk, cfg, state, cos, sin, ada_m, y_m, xm_m, ym_m,
                               compute_dtype, route, tp)
        return state

    remat = cfg.remat and torch.is_grad_enabled()
    dev = x.device
    first = torch.tensor(stage == 0, device=dev)
    state = h_mb[0].new_zeros(h_mb[0].shape)
    outs = [state] * M
    ticks = M + S - 1
    for tk in range(ticks):
        state = torch.where(first, h_mb[min(tk, M - 1)], state)
        m = min(max(tk - stage, 0), M - 1)
        args = (state, y_mb[m], ada_mb[m], xm_mb and xm_mb[m], ym_mb and ym_mb[m])
        out = (checkpoint(stage_apply, *args, use_reentrant=False) if remat
               else stage_apply(*args))
        valid = torch.tensor(tk >= stage and tk - stage < M and stage == S - 1,
                             device=dev)
        outs[m] = torch.where(valid, out, outs[m])
        if tk < ticks - 1:  # the last tick's shift would feed nothing
            state = _RingShift.apply(out, pipe)
    last = torch.tensor(stage == S - 1, device=dev)
    o = torch.cat(outs).float()
    h = pipe.reduce(torch.where(last, o, torch.zeros((), device=dev)))
    fl = dit.final_layer
    shift, scale = linear(fl.adaLN_modulation[1], silu(adaln.float())).chunk(2, -1)
    return _final(dit, h, shift, scale)

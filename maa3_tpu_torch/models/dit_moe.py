"""The video Next-DiT with the deterministic dual MoE (counterpart of
maa3_tpu/models/dit_moe.py; the reference's VideoFlagLargeDiT,
flag_large_dit_moe.py:613-740).

- `c_embedder` (ConditionEmbedder: Linear -> exact-erf GELU -> Linear ->
  LayerNorm, keys c_embedder.mlp.{0,2,3}) lifts the video features
  (B, Lv, ctx) to (B, Lv, H); cross-attention runs over them.
- Each block's feed-forward is a MoE (keys feed_forward.time_experts.{e}.w*
  and feed_forward.freq_experts.{e}.w*): the time-MoE sends every token of
  sample b to expert t_b // 250; the frequency-MoE splits the hidden width
  into num_experts contiguous slices, and slice e of its output is expert
  e's SwiGLU of slice e of its input (its w1 / w3 input columns and w2
  output rows of that slice).

Routing depends on t and the channel only, so it is dense: the time-MoE
gathers each sample's expert weights and runs one batched product; the
frequency-MoE runs on the pre-sliced stacks. Self- and cross-attention go
through ops/attention.py, so self-attention takes the flash kernels
(K3a/K3b forward, K4a or K4b + K4c backward) wherever models/dit.py
`dit_route` says.
Random init is models/dit.py `dit_init_` (xavier linears, zero adaLN, final
layer and gates). `moe_dit_sample_plan` / `moe_dit_apply_planned` hoist what every ODE step
shares: the conditioning tower, the adaLN modulations, the cross-attention
K/V, the frequency-expert slices and, since every sample of a step shares
its timestep, one time expert per step.

With a bf16 compute dtype the expert products give bf16 results (JAX's
keep fp32 results of bf16 operands); fp32 is the same.

Over a ("data", "model", "expert") mesh (parallel/mesh.py make_moe_mesh)
the model runs Megatron's tensor parallelism (dit.tp: the attention as the
text DiT's, each expert's w1 / w3 by output and w2 by input), expert
parallelism (dit.ep: this rank's experts, see moe_apply) and ZeRO-3
(dit.fsdp), as JAX's shardings of the stacks give (maa3_tpu/parallel/mesh.py:
89-114, 137-167).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from maa3_tpu_torch.models.dit import FinalLayer, _final, dit_route
from maa3_tpu_torch.ops.attention import Attention, Route, attention_apply, context_kv
from maa3_tpu_torch.ops.basic import (RMSNorm, TimestepEmbedder, layer_norm, linear,
                                      modulate, rms_norm, silu)
from maa3_tpu_torch.ops.ffn import FeedForward
from maa3_tpu_torch.ops.rope import precompute_rope
from maa3_tpu_torch.parallel.fsdp import gathered


@dataclasses.dataclass(frozen=True)
class MoEDiTConfig:
    in_channels: int = 20
    context_dim: int = 768
    hidden_size: int = 768
    depth: int = 16
    num_heads: int = 32
    max_len: int = 1000
    n_kv_heads: Optional[int] = None
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    norm_eps: float = 1e-5
    qk_norm: bool = False
    rope_scaling_factor: float = 1.0
    ntk_factor: float = 1.0
    num_experts: int = 4
    num_timesteps: int = 1000
    # None: by sequence length and mode (models/dit.py dit_route); True/False:
    # always / never
    use_flash: Optional[bool] = None
    # recompute each block in the backward (torch.utils.checkpoint)
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def time_bucket(self) -> int:
        return 250  # flag_large_dit_moe.py:520 (time // 250)


def _expert(cfg: MoEDiTConfig) -> FeedForward:
    return FeedForward(cfg.hidden_size, 4 * cfg.hidden_size, cfg.multiple_of,
                       cfg.ffn_dim_multiplier)


class MoE(nn.Module):
    def __init__(self, cfg: MoEDiTConfig):
        super().__init__()
        self.time_experts = nn.ModuleList(_expert(cfg) for _ in range(cfg.num_experts))
        self.freq_experts = nn.ModuleList(_expert(cfg) for _ in range(cfg.num_experts))


class MoEBlock(nn.Module):
    def __init__(self, cfg: MoEDiTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.attention = Attention(d, cfg.num_heads, cfg.n_kv_heads, cfg.qk_norm, d)
        self.feed_forward = MoE(cfg)
        self.attention_norm = RMSNorm(d)
        self.ffn_norm = RMSNorm(d)
        self.attention_y_norm = RMSNorm(d)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 6 * d))


class ConditionEmbedder(nn.Module):
    def __init__(self, ctx: int, d: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(ctx, d), nn.GELU(), nn.Linear(d, d),
                                 nn.LayerNorm(d, eps=1e-5))


class MoEDiT(nn.Module):
    def __init__(self, cfg: MoEDiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.proj_in = nn.Linear(cfg.in_channels, d)
        self.t_embedder = TimestepEmbedder(d)
        self.c_embedder = ConditionEmbedder(cfg.context_dim, d)
        self.cap_embedder = nn.Sequential(nn.LayerNorm(d, eps=1e-5), nn.Linear(d, d))
        self.blocks = nn.ModuleList(MoEBlock(cfg) for _ in range(cfg.depth))
        self.final_layer = FinalLayer(d, cfg.in_channels)
        # set when the parameters are this rank's shards: the model group
        # (parallel/tp.py TP), the expert group (EP) and ZeRO-3 over the data
        # group (parallel/fsdp.py)
        self.tp = None
        self.ep = None
        self.fsdp = None


# -- the MoE feed-forward -----------------------------------------------------------

def _silu_prod(h1: torch.Tensor, h3: torch.Tensor) -> torch.Tensor:
    return silu(h1.float()) * h3.float()


def _time_experts(experts, x: torch.Tensor, idx: torch.Tensor, dt) -> torch.Tensor:
    """Each sample's expert experts[idx_b], one batched product per projection."""
    def gathered(name):  # (B, out, in) weights of each sample's expert
        return torch.stack([getattr(e, name).weight for e in experts])[idx].to(dt)

    xb = x.to(dt)
    h1 = torch.einsum("bld,bhd->blh", xb, gathered("w1"))
    h3 = torch.einsum("bld,bhd->blh", xb, gathered("w3"))
    return torch.einsum("blh,bdh->bld", _silu_prod(h1, h3).to(dt), gathered("w2"))


def moe_apply(moe: MoE, x: torch.Tensor, t: torch.Tensor, cfg: MoEDiTConfig,
              compute_dtype: Optional[torch.dtype] = None, tp=None, ep=None) -> torch.Tensor:
    """x (B, L, D), t (B,) integer timesteps -> (B, L, D): each sample's time
    expert, then the frequency experts on its output
    (maa3_tpu/models/dit_moe.py:88-147).

    tp (parallel/tp.py TP): the experts are this rank's column (w1, w3) and
    row (w2) shards over "model"; each MoE runs between copy and reduce.
    ep (EP): this rank owns experts ep.lo .. ep.lo + ep.k - 1. The time MoE
    computes only the samples of its experts, zeros for the rest, and sums
    over "expert" (copy before, reduce after); the frequency MoE computes
    its experts' slices and all-gathers them over "expert"."""
    dt = compute_dtype or x.dtype
    idx = torch.clamp(t // cfg.time_bucket, 0, cfg.num_experts - 1).long()
    xin = x if tp is None else tp.copy(x)
    te = moe.time_experts
    if ep is None:
        y = _time_experts(te, xin, idx, dt)
    else:
        xin = ep.copy(xin)
        rows = ((idx >= ep.lo) & (idx < ep.lo + ep.k)).nonzero().squeeze(1)
        # with no row of its experts a rank still runs them on none, so that
        # their gradients exist (zeros) as on the ranks that have rows
        mine = _time_experts(list(te)[ep.lo:ep.lo + ep.k], xin[rows], idx[rows] - ep.lo, dt)
        y = ep.reduce(xin.new_zeros(xin.shape, dtype=dt).index_put((rows,), mine.to(dt)))
    if tp is not None:
        y = tp.reduce(y)
    y = y.to(x.dtype)
    d = x.shape[-1]
    return _freq_moe(y, *_freq_sliced_stacks(moe, cfg, d, dt, ep), dt, tp, ep).to(x.dtype)


def _freq_sliced_stacks(moe: MoE, cfg: MoEDiTConfig, d: int, dt, ep=None):
    """The frequency experts' slices, weight only: w1s / w3s (E, h, sl) (the
    input columns of slice e), w2s (E, sl, h) (its output rows); with ep
    only this rank's experts'."""
    sl = d // cfg.num_experts
    fe = moe.freq_experts
    own = range(cfg.num_experts) if ep is None else range(ep.lo, ep.lo + ep.k)
    w1s = torch.stack([fe[i].w1.weight[:, i * sl:(i + 1) * sl] for i in own])
    w3s = torch.stack([fe[i].w3.weight[:, i * sl:(i + 1) * sl] for i in own])
    w2s = torch.stack([fe[i].w2.weight[i * sl:(i + 1) * sl] for i in own])
    return w1s.to(dt), w3s.to(dt), w2s.to(dt)


def _freq_moe(y: torch.Tensor, w1s, w3s, w2s, dt, tp=None, ep=None) -> torch.Tensor:
    """The frequency-MoE on pre-sliced stacks (this rank's experts and
    shards with ep / tp, see moe_apply); fp32 or dt result."""
    b, l, d = y.shape
    sl = w1s.shape[-1]
    if tp is not None:
        y = tp.copy(y)
    ys = y.reshape(b, l, d // sl, sl).to(dt)
    if ep is not None:
        ys = ep.copy(ys)[:, :, ep.lo:ep.lo + ep.k]
    g1 = torch.einsum("bleS,ehS->bleh", ys, w1s)
    g3 = torch.einsum("bleS,ehS->bleh", ys, w3s)
    z = torch.einsum("bleh,eSh->bleS", _silu_prod(g1, g3).to(dt), w2s)
    if tp is not None:
        z = tp.reduce(z)
    if ep is not None:
        z = ep.gather(z, 2)
    return z.reshape(b, l, d)


def moe_apply_shared_t(moe: MoE, x: torch.Tensor, t_idx: int, cfg: MoEDiTConfig,
                       freq_sliced=None,
                       compute_dtype: Optional[torch.dtype] = None,
                       tp=None, ep=None) -> torch.Tensor:
    """moe_apply when every sample has the same time expert t_idx (the
    sampling case): one plain GEMM per projection
    (maa3_tpu/models/dit_moe.py:223); tp and ep as moe_apply (with ep only
    the rank owning t_idx computes the time expert)."""
    dt = compute_dtype or x.dtype
    xb = (x if tp is None else tp.copy(x)).to(dt)
    if ep is None or ep.owns(t_idx):
        ex = moe.time_experts[t_idx]
        h1 = xb @ ex.w1.weight.to(dt).t()
        h3 = xb @ ex.w3.weight.to(dt).t()
        y = _silu_prod(h1, h3).to(dt) @ ex.w2.weight.to(dt).t()
    else:
        y = xb.new_zeros(xb.shape)
    if ep is not None:
        y = ep.reduce(y)
    if tp is not None:
        y = tp.reduce(y)
    y = y.to(x.dtype)
    if freq_sliced is None:
        freq_sliced = _freq_sliced_stacks(moe, cfg, x.shape[-1], dt, ep)
    return _freq_moe(y, *freq_sliced, dt, tp, ep).to(x.dtype)


# -- the model ------------------------------------------------------------------------

def _cond_embed(ce: ConditionEmbedder, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Linear -> exact GELU in fp32 -> Linear -> LayerNorm (eps 1e-5)
    (maa3_tpu/models/dit_moe.py:188)."""
    lin0, _, lin2, ln = ce.mlp
    h = linear(lin0, x, compute_dtype)
    h = F.gelu(h.float())
    h = linear(lin2, h, compute_dtype)
    return layer_norm(h, ln.weight, ln.bias, eps=1e-5)


def _adaln_input(dit: MoEDiT, t_emb: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """t_emb + cap_embedder(mean of the conditioning over its frames), fp32."""
    ln, lin = dit.cap_embedder
    pooled = cond.float().mean(dim=1)
    return t_emb + linear(lin, layer_norm(pooled, ln.weight, ln.bias, eps=1e-5))


def _moe_block(blk: MoEBlock, cfg: MoEDiTConfig, h, cos, sin, adaln, cond, t,
               compute_dtype, route: Route, tp=None, ep=None, fsdp=None):
    """One block of moe_dit_apply, its FSDP shards gathered inside; with tp
    the attention runs between tp.enter and tp.exit (no sequence
    parallelism), the MoE as moe_apply."""
    with gathered(fsdp, blk):
        mod = linear(blk.adaLN_modulation[1], silu(adaln.float()))
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = mod.chunk(6, dim=-1)
        xa = modulate(rms_norm(blk.attention_norm.weight, h, cfg.norm_eps), s_msa, sc_msa)
        ha = attention_apply(
            blk.attention, xa if tp is None else tp.enter(xa),
            cos, sin, y=rms_norm(blk.attention_y_norm.weight, cond, cfg.norm_eps),
            n_heads=cfg.num_heads, n_kv_heads=cfg.n_kv_heads,
            compute_dtype=compute_dtype, route=route, tp=tp)
        if tp is not None:
            ha = tp.exit(ha)
        h = h + g_msa[:, None, :].to(h.dtype) * ha
        hf = moe_apply(blk.feed_forward,
                       modulate(rms_norm(blk.ffn_norm.weight, h, cfg.norm_eps), s_mlp, sc_mlp),
                       t, cfg, compute_dtype, tp, ep)
        return h + g_mlp[:, None, :].to(h.dtype) * hf


def _parallel(dit: MoEDiT):
    """dit's TP (without sequence parallelism), EP and FSDP, each or None."""
    tp = getattr(dit, "tp", None)
    return (tp and tp.with_seq_parallel(False), getattr(dit, "ep", None),
            getattr(dit, "fsdp", None))


def _embed(dit: MoEDiT, x: torch.Tensor, compute_dtype):
    cfg = dit.cfg
    h = linear(dit.proj_in, x.transpose(1, 2), compute_dtype)
    cos, sin = precompute_rope(cfg.head_dim, x.shape[-1],
                               rope_scaling_factor=cfg.rope_scaling_factor,
                               ntk_factor=cfg.ntk_factor, device=x.device)
    return h, cos, sin


def moe_dit_apply(dit: MoEDiT, x: torch.Tensor, t: torch.Tensor,
                  context: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                  training: bool = False) -> torch.Tensor:
    """x (B, C, T), t (B,) integer timesteps, context (B, Lv, ctx) video
    features -> the (B, C, T) fp32 velocity (maa3_tpu/models/dit_moe.py:245).
    training=True selects the training flash threshold; cfg.remat
    recomputes each block in the backward. A MoEDiT sharded over the model
    (dit.tp), expert (dit.ep) or data (dit.fsdp) group runs tensor, expert
    or ZeRO-3 parallelism (parallel/)."""
    cfg = dit.cfg
    route = dit_route(cfg, x.shape[-1], training)
    tp, ep, fsdp = _parallel(dit)
    with gathered(fsdp, dit.proj_in, dit.t_embedder, dit.c_embedder, dit.cap_embedder,
                  dit.final_layer):
        h, cos, sin = _embed(dit, x, compute_dtype)
        cond = _cond_embed(dit.c_embedder, context, compute_dtype)
        adaln = _adaln_input(dit, dit.t_embedder(t), cond)
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in dit.blocks:
            args = (blk, cfg, h, cos, sin, adaln, cond, t, compute_dtype, route, tp, ep, fsdp)
            h = (checkpoint(_moe_block, *args, use_reentrant=False) if remat
                 else _moe_block(*args))
        shift, scale = linear(dit.final_layer.adaLN_modulation[1],
                              silu(adaln.float())).chunk(2, -1)
        return _final(dit, h, shift, scale)


@torch.no_grad()
def moe_dit_sample_plan(dit: MoEDiT, t_ints: torch.Tensor, context: torch.Tensor,
                        compute_dtype: Optional[torch.dtype] = torch.bfloat16) -> dict:
    """t_ints (S,) model timesteps; context (B, Lv, ctx) video features (the
    dual batch [uc; c] for CFG). Returns {"mods": (S, depth, B, 6H),
    "final": (S, B, 2H), "yk"/"yv": per-block (B, n_kv, Lv, head_dim),
    "freq_sliced": per-block stacks, "tidx": the time expert of each step
    (ints)}
    (maa3_tpu/models/dit_moe.py:302). Under tp / ep the K/V are this rank's
    heads and the stacks its experts' shards."""
    cfg = dit.cfg
    tp, ep, _ = _parallel(dit)
    cond = _cond_embed(dit.c_embedder, context, compute_dtype)
    adaln = silu(_adaln_input(dit, dit.t_embedder(t_ints)[:, None, :], cond))  # (S, B, H)
    ada = [blk.adaLN_modulation[1] for blk in dit.blocks]
    w_ada = torch.stack([m.weight.float() for m in ada])          # (depth, 6H, H)
    b_ada = torch.stack([m.bias.float() for m in ada])
    mods = torch.einsum("sbh,dmh->sdbm", adaln, w_ada) + b_ada[None, :, None, :]
    fl = dit.final_layer.adaLN_modulation[1]
    final = torch.einsum("sbh,mh->sbm", adaln, fl.weight.float()) + fl.bias.float()
    cf = cond.float()
    yf = (cf * torch.rsqrt(cf.pow(2).mean(-1, keepdim=True) + cfg.norm_eps)).to(cond.dtype)
    yk, yv, fs = [], [], []
    for blk in dit.blocks:
        yn = yf * blk.attention_y_norm.weight.to(cond.dtype)
        k, v = context_kv(blk.attention, yn.to(compute_dtype or yn.dtype), compute_dtype, tp)
        yk.append(k)
        yv.append(v)
        fs.append(_freq_sliced_stacks(blk.feed_forward, cfg, cfg.hidden_size,
                                      compute_dtype or torch.float32, ep))
    tidx = [min(max(int(t) // cfg.time_bucket, 0), cfg.num_experts - 1)
            for t in t_ints.tolist()]
    return {"mods": mods, "final": final, "yk": yk, "yv": yv, "freq_sliced": fs,
            "tidx": tidx}


def moe_dit_apply_planned(dit: MoEDiT, x: torch.Tensor, mods: torch.Tensor,
                          final_mod: torch.Tensor, t_idx: int, yk: List, yv: List,
                          freq_sliced: List,
                          compute_dtype: Optional[torch.dtype] = torch.bfloat16):
    """moe_dit_apply for one step of a plan, every sample on time expert
    t_idx (maa3_tpu/models/dit_moe.py:348); tensor and expert parallel as
    the DiT's shards say."""
    cfg = dit.cfg
    route = dit_route(cfg, x.shape[-1])
    tp, ep, _ = _parallel(dit)
    h, cos, sin = _embed(dit, x, compute_dtype)
    for i, blk in enumerate(dit.blocks):
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = mods[i].chunk(6, dim=-1)
        xa = modulate(rms_norm(blk.attention_norm.weight, h, cfg.norm_eps), s_msa, sc_msa)
        ha = attention_apply(
            blk.attention, xa if tp is None else tp.enter(xa),
            cos, sin, y_kv=(yk[i], yv[i]), n_heads=cfg.num_heads,
            n_kv_heads=cfg.n_kv_heads, compute_dtype=compute_dtype, route=route, tp=tp)
        if tp is not None:
            ha = tp.exit(ha)
        h = h + g_msa[:, None, :].to(h.dtype) * ha
        hf = moe_apply_shared_t(
            blk.feed_forward,
            modulate(rms_norm(blk.ffn_norm.weight, h, cfg.norm_eps), s_mlp, sc_mlp),
            t_idx, cfg, freq_sliced[i], compute_dtype, tp, ep)
        h = h + g_mlp[:, None, :].to(h.dtype) * hf
    shift, scale = final_mod.chunk(2, dim=-1)
    return _final(dit, h, shift, scale)

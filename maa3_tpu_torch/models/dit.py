"""Next-DiT (Lumina-Next) text-conditioned flow backbone
(counterpart of maa3_tpu/models/dit.py).

x (B, C, T) latents -> proj_in -> depth x [RoPE self-attn + gated cross-attn
+ SwiGLU FFN, 6-way adaLN-modulated] -> FinalLayer -> (B, C, T) velocity.

Blocks are an nn.ModuleList with the reference's state-dict keys
(blocks.{i}.attention.wq.weight, ...). `dit_route` decides once per apply
which kernels its blocks run (the `Route`). `dit_apply(training=True)` is the
training forward: self-attention goes through the flash kernels from 1248
tokens (JAX's rule; cross-attention stays dense),
and `remat` recomputes each block in the backward (torch.utils.checkpoint)
under one of JAX's five `remat_policy`s (selective activation
checkpointing, `remat_policy_fn`). `fuse_dit_gemms` / `unfuse_dit_gemms`
move a DiT to and from the fused training layout (wqkv and w13 as
parameters). `dit_sample_plan` / `dit_apply_planned` hoist the per-step
adaLN modulations and the static cross-attention K/V (head-major, the
layout the flash kernels read) out of the ODE loop, with the same ops as
`dit_apply`. On the card in bf16 without autograd, the planned step sends
self- and cross-attention to the flash forward (K3a) at every length;
elsewhere it follows JAX's rule. There, with the fp32 residual stream and a
fused wqkv, it also runs each block as `_fused_block`: the gated residuals,
RMSNorms and adaLN modulates in K5, RoPE with the head-major split in K6,
the gated cross-attention merge with the move to token-major in K8 and the
SwiGLU gate in K7 (ops/dit_fused.py), each block's MLP residual added by the
next block's entry K5; trace.py `counts` counts the block-steps of each route.
`serving_copy` makes the bf16 serving weights: every matmul weight rounded
to bf16, wq/wk/wv and w1/w3 fused (JAX's cast_matmul_weights +
fuse_dit_gemms).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from maa3_tpu_torch import trace
from maa3_tpu_torch.ops.attention import (Attention, Route, attention_apply,
                                          attention_apply_heads, context_kv)
from maa3_tpu_torch.ops.basic import (RMSNorm, TimestepEmbedder, checkpoint_names, dense,
                                      layer_norm, linear, modulate, rms_norm, silu)
from maa3_tpu_torch.ops.dit_fused import residual_norm_modulate, swiglu
from maa3_tpu_torch.ops.ffn import FeedForward, feed_forward_apply
from maa3_tpu_torch.ops.flash_attention import MAX_HEAD_DIM
from maa3_tpu_torch.ops.quant import QuantWeight
from maa3_tpu_torch.ops.rope import precompute_rope
from maa3_tpu_torch.parallel.fsdp import gathered

# JAX's remat policies (maa3_tpu/models/dit.py:254-293): what the backward
# keeps of a block's forward. The names are the projections' checkpoint
# names (ops/attention.py, ops/ffn.py); None: every 2-D matmul
# (dots_with_no_batch_dims_saveable), no batched one.
_ATTN = ("attn_q", "attn_k", "attn_v", "attn_out")
REMAT_SAVES: Dict[str, Optional[frozenset]] = {
    "nothing": frozenset(),
    "dots_no_batch": None,
    "save_gemms": frozenset(_ATTN + ("ffn_h1", "ffn_h3", "ffn_out")),
    "save_gemms_lite": frozenset(_ATTN + ("ffn_out",)),
    "save_gemms_h1": frozenset(_ATTN + ("ffn_h1", "ffn_out")),
}
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 20
    context_dim: int = 1024
    hidden_size: int = 768
    depth: int = 16
    num_heads: int = 32
    n_kv_heads: Optional[int] = None
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    norm_eps: float = 1e-5
    qk_norm: bool = False
    rope_scaling_factor: float = 1.0
    ntk_factor: float = 1.0
    # bf16 serving carries the residual stream between blocks in fp32
    # (system.py:421-433); no effect in fp32
    fp32_residual: bool = False
    # flash attention for self-attention: None = by sequence length and mode
    # (dit_route), True/False = always / never
    use_flash: Optional[bool] = None
    # recompute each block in the backward instead of keeping its activations,
    # keeping what remat_policy names (REMAT_SAVES)
    remat: bool = False
    remat_policy: str = "nothing"
    # Megatron sequence parallelism for tensor-parallel training: the
    # residual stream between the blocks' products is sharded over the
    # sequence on the model group (parallel/tp.py); no effect without a TP
    # group (maa3_tpu/models/dit.py:92-97)
    seq_parallel: bool = False

    def __post_init__(self):
        if self.remat_policy not in REMAT_SAVES:
            raise ValueError(f"unknown remat_policy: {self.remat_policy!r} "
                             "(expected 'nothing', 'dots_no_batch', "
                             "'save_gemms', 'save_gemms_lite' or "
                             "'save_gemms_h1')")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def flash_for_len(self, seq_len: int, training: bool = False) -> bool:
        """JAX's method: whether self-attention takes flash (`dit_route`)."""
        return dit_route(self, seq_len, training).self_flash


def dit_route(cfg, seq_len: int, training: bool = False, *,
              device_type: Optional[str] = None, dtype: Optional[torch.dtype] = None,
              grad_enabled: bool = False, y_masked: bool = False, tp=None,
              return_stats: bool = False, fused_wqkv: bool = False) -> Route:
    """The kernels of one apply of the text DiT or the video MoE (cfg: a
    DiTConfig or a MoEDiTConfig), decided once for all its blocks.

    Self-attention follows JAX's rule (maa3_tpu/models/dit.py:103-106):
    cfg.use_flash if set, else flash in training from 1248 tokens and in
    inference above 4096 (a TPU measurement); seq_len is the whole sequence,
    before any tp split. Cross-attention is dense and the blocks plain.

    The planned serving step also passes what it runs on and with. On a CUDA
    device, in bf16, without autograd and at head dims the kernels take, it
    sends self-attention (unless cfg.use_flash says otherwise) and, without
    a context mask, cross-attention to the flash forward (K3a) at every
    length: on an H100 K3a beat the dense path at every latent length from
    39 to 624 at 2-32 dual rows, self and cross (chip_smoke.py
    --attn-crossover, bf16, 16 heads of 72; PERF.md). A masked context stays
    dense: K3a gives a fully masked row 0, the dense path the mean of v, and
    finding such rows would cost a host sync. There the blocks run as
    `_fused_block` (K5 - K8, ops/dit_fused.py) at an even head dim and a
    width that is a multiple of 8, with the fp32 residual stream and a fused
    wqkv (serving_copy and quant_serving_copy make it), and without tensor
    parallelism, SmoothQuant statistics or qk_norm."""
    flash = (cfg.use_flash if cfg.use_flash is not None
             else seq_len >= 1248 if training else seq_len > 4096)
    if not (device_type == "cuda" and dtype == torch.bfloat16 and not grad_enabled
            and cfg.head_dim <= MAX_HEAD_DIM):
        return Route(flash)
    fused = (cfg.head_dim % 2 == 0 and cfg.hidden_size % 8 == 0 and cfg.fp32_residual
             and tp is None and not return_stats and not cfg.qk_norm and fused_wqkv)
    return Route(cfg.use_flash if cfg.use_flash is not None else True, not y_masked, fused)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.attention = Attention(d, cfg.num_heads, cfg.n_kv_heads,
                                   cfg.qk_norm, cfg.context_dim)
        self.feed_forward = FeedForward(d, 4 * d, cfg.multiple_of,
                                        cfg.ffn_dim_multiplier)
        self.attention_norm = RMSNorm(d)
        self.ffn_norm = RMSNorm(d)
        self.attention_y_norm = RMSNorm(cfg.context_dim)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 6 * d))


class FinalLayer(nn.Module):
    def __init__(self, d: int, out_ch: int):
        super().__init__()
        self.linear = nn.Linear(d, out_ch)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 2 * d))


class DiT(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.proj_in = nn.Linear(cfg.in_channels, d)
        self.t_embedder = TimestepEmbedder(d)
        self.cap_embedder = nn.Sequential(nn.LayerNorm(cfg.context_dim, eps=1e-5),
                                          nn.Linear(cfg.context_dim, d))
        self.blocks = nn.ModuleList(TransformerBlock(cfg)
                                    for _ in range(cfg.depth))
        self.final_layer = FinalLayer(d, cfg.in_channels)
        # set when the parameters are this rank's shards: the model group
        # (parallel/tp.py TP) and ZeRO-3 over the data group (parallel/fsdp.py)
        self.tp = None
        self.fsdp = None


@torch.no_grad()
def dit_init_(dit: DiT, generator: torch.Generator) -> DiT:
    """Random init in place, as dit_init: xavier-uniform linears with zero
    bias, N(0, 0.02) timestep MLP, zero adaLN / final layer / gates."""
    for name, m in dit.named_modules():
        if isinstance(m, nn.Linear):
            if "adaLN_modulation" in name or name.startswith("final_layer"):
                m.weight.zero_()
            elif name.startswith("t_embedder"):
                m.weight.normal_(0.0, 0.02, generator=generator)
            else:
                fan_out, fan_in = m.weight.shape
                lim = (6.0 / (fan_in + fan_out)) ** 0.5
                m.weight.uniform_(-lim, lim, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, RMSNorm)):
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
    for blk in dit.blocks:
        blk.attention.gate.zero_()
    return dit


@torch.no_grad()
def unfreeze_zero_init(dit: DiT, generator: torch.Generator,
                       scale: float = 0.02) -> DiT:
    """Make the zero-init leaves nonzero (gates 0.5, adaLN and final layer
    N(0, scale^2)), so random-init blocks are not identities
    (maa3_tpu/utils/nprand.py:101)."""
    for blk in dit.blocks:
        blk.attention.gate.fill_(0.5)
        lin = blk.adaLN_modulation[1]
        lin.weight.normal_(0.0, scale, generator=generator)
        lin.bias.zero_()
    for lin in (dit.final_layer.linear, dit.final_layer.adaLN_modulation[1]):
        lin.weight.normal_(0.0, scale, generator=generator)
        lin.bias.zero_()
    return dit


def _fuse_serving(dit: nn.Module) -> None:
    """wq/wk/wv -> attention.wqkv and w1/w3 -> feed_forward.w13 (plain
    tensors, in the weights' dtype) in every block; a MoE block's experts
    stay as they are (nprand.fuse_dit_gemms)."""
    for blk in dit.blocks:
        att, ff = blk.attention, blk.feed_forward
        att.wqkv = torch.cat([att.wq.weight, att.wk.weight, att.wv.weight])
        del att.wq, att.wk, att.wv
        if isinstance(ff, FeedForward):
            ff.w13 = torch.cat([ff.w1.weight, ff.w3.weight])
            del ff.w1, ff.w3


def _cast_matmul_weights(dit: nn.Module, dtype: torch.dtype) -> None:
    """Every float matmul weight to `dtype` (nn.Linear weights and fused
    wqkv / w13 tensors; int8 weights, norms, biases and gates as they are:
    JAX's cast_matmul_weights)."""
    for m in dit.modules():
        if isinstance(m, nn.Linear):
            m.weight.data = m.weight.data.to(dtype)
        for name in ("wqkv", "w13"):
            w = getattr(m, name, None)
            if isinstance(w, torch.Tensor):
                setattr(m, name, w.to(dtype))


@torch.no_grad()
def serving_copy(dit: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Inference copy: matmul weights rounded to `dtype`, q/k/v and w1/w3
    fused into single GEMMs (norms, biases and gates stay fp32). Also the
    video MoE DiT (models/dit_moe.py), whose experts are not fused."""
    s = copy.deepcopy(dit)
    _cast_matmul_weights(s, dtype)
    _fuse_serving(s)
    return s


@torch.no_grad()
def quant_serving_copy(dit: nn.Module, group_size: int = 0, skip_w2: bool = False,
                       smooth_stats: Optional[dict] = None) -> nn.Module:
    """The int8 serving copy in JAX's order (maa3_tpu/system.py:279-300): fuse
    in fp32, SmoothQuant migration when `smooth_stats` are given, quantize
    the per-step GEMMs from the fp32 weights (ops/quant.py
    quantize_dit_serving), then cast every other matmul weight to bf16
    whatever the compute dtype."""
    from maa3_tpu_torch.ops.quant import quantize_dit_serving, smooth_migrate_dit
    s = copy.deepcopy(dit)
    _fuse_serving(s)
    if smooth_stats is not None:
        smooth_migrate_dit(s, smooth_stats)
    quantize_dit_serving(s, group_size=group_size, skip_w2=skip_w2)
    _cast_matmul_weights(s, torch.bfloat16)
    return s


@torch.no_grad()
def fuse_dit_gemms(dit: DiT) -> DiT:
    """A copy of `dit` in the fused training layout (maa3_tpu/utils/nprand.py:46):
    each block's wq/wk/wv become one `attention.wqkv` parameter and w1/w3 one
    `feed_forward.w13`, in the weights' dtype. The same math, wider GEMMs."""
    f = copy.deepcopy(dit)
    for blk in f.blocks:
        att, ff = blk.attention, blk.feed_forward
        att.wqkv = nn.Parameter(torch.cat([att.wq.weight, att.wk.weight, att.wv.weight]))
        del att.wq, att.wk, att.wv
        if isinstance(ff, FeedForward):  # a MoE block's experts stay as they are
            ff.w13 = nn.Parameter(torch.cat([ff.w1.weight, ff.w3.weight]))
            del ff.w1, ff.w3
    return f


def fuse_dit_state(state: Dict[str, torch.Tensor], depth: int) -> Dict[str, torch.Tensor]:
    """The inverse of unfuse_dit_gemms: a canonical {name: tensor} of a DiT's
    parameters in the fused training layout's names."""
    out = dict(state)
    for i in range(depth):
        a, f = f"blocks.{i}.attention.", f"blocks.{i}.feed_forward."
        out[a + "wqkv"] = torch.cat([out.pop(a + n + ".weight") for n in ("wq", "wk", "wv")])
        if f + "w1.weight" in out:  # not a MoE block
            out[f + "w13"] = torch.cat([out.pop(f + n + ".weight") for n in ("w1", "w3")])
    return out


def unfuse_dit_gemms(state: Dict[str, torch.Tensor], n_heads: int,
                     n_kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A fused DiT's state dict (or any {name: tensor} of its parameters) in
    the canonical names (maa3_tpu/utils/nprand.py:73): wqkv split into
    wq/wk/wv.weight, w13 into w1/w3.weight; other entries as they are."""
    out = {}
    for name, t in state.items():
        if name.endswith("attention.wqkv"):
            stem = name[:-len("wqkv")]
            hd = t.shape[1] // n_heads
            n_kv = n_heads if n_kv_heads is None else n_kv_heads
            for part, w in zip(("wq", "wk", "wv"),
                               t.split([n_heads * hd, n_kv * hd, n_kv * hd])):
                out[f"{stem}{part}.weight"] = w
        elif name.endswith("feed_forward.w13"):
            stem = name[:-len("w13")]
            w1, w3 = t.chunk(2)
            out[f"{stem}w1.weight"], out[f"{stem}w3.weight"] = w1, w3
        else:
            out[name] = t
    return out


def _policy(saves: Optional[frozenset], ctx, op, *args, **kwargs):
    if op in _MATMULS:
        names = checkpoint_names()
        # a fused projection is kept only when every one of its parts is
        if saves is None or (names and saves.issuperset(names)):
            return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy_fn(policy: str):
    """The selective-checkpoint policy of a remat policy: aten.mm / addmm
    outputs it keeps are saved, every other op is recomputed ("nothing"
    runs as a plain checkpoint, without the policy's dispatch mode). The flash
    kernels launch through ctypes, out of the policy's sight, so their
    forward reruns in the backward under every policy, as JAX recomputes the
    unnamed pallas_call."""
    return functools.partial(_policy, REMAT_SAVES[policy])


def _amax(a: torch.Tensor) -> torch.Tensor:
    return a.float().abs().amax(dim=(0, 1))


def _reduces(lin: nn.Module) -> bool:
    """An int8 row-parallel weight whose product sums over the model group
    itself (ops/quant.py dense_w8a8)."""
    return getattr(lin.weight, "amax_group", None) is not None


def _block_apply(blk: TransformerBlock, cfg: DiTConfig, x, cos, sin, mod, route: Route,
                 y=None, y_kv=None, x_mask=None, y_mask=None,
                 compute_dtype=None, return_stats: bool = False, tp=None):
    """TransformerBlock.forward with the (B, 6H) modulation given, its
    attention on `route`.
    return_stats: also {attn_in, ffn_in, ffn_prod}, the per-channel amax of
    the three quantized-GEMM inputs (maa3_tpu/models/dit.py:376-419).
    tp: the block's weights are this rank's shards (parallel/tp.py); the
    attention and the FFN run between tp.enter and tp.exit, and x is this
    rank's sequence shard under sequence parallelism."""
    if tp is not None and return_stats:
        raise NotImplementedError("calibrate SmoothQuant before sharding")
    if tp is not None:
        mod = tp.on_stream(mod)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
        mod.chunk(6, dim=-1))
    w_attn, w_ffn = blk.attention_norm.weight, blk.ffn_norm.weight
    if tp is not None:
        w_attn, w_ffn = tp.on_stream(w_attn), tp.on_stream(w_ffn)
    x_attn_in = modulate(rms_norm(w_attn, x, cfg.norm_eps), shift_msa, scale_msa)
    h_attn = attention_apply(
        blk.attention, x_attn_in if tp is None else tp.enter(x_attn_in),
        cos, sin, y=y, y_kv=y_kv, x_mask=x_mask, y_mask=y_mask,
        n_heads=cfg.num_heads, n_kv_heads=cfg.n_kv_heads,
        compute_dtype=compute_dtype, route=route, tp=tp)
    if tp is not None and not _reduces(blk.attention.wo):
        h_attn = tp.exit(h_attn)
    h = x + gate_msa[:, None, :].to(x.dtype) * h_attn
    x_ffn_in = modulate(rms_norm(w_ffn, h, cfg.norm_eps), shift_mlp, scale_mlp)
    h_ffn = feed_forward_apply(blk.feed_forward,
                               x_ffn_in if tp is None else tp.enter(x_ffn_in),
                               compute_dtype, return_stats=return_stats)
    if tp is not None and not _reduces(blk.feed_forward.w2):
        h_ffn = tp.exit(h_ffn)
    if return_stats:
        h_ffn, prod_amax = h_ffn
        stats = {"attn_in": _amax(x_attn_in), "ffn_in": _amax(x_ffn_in),
                 "ffn_prod": prod_amax}
        return h + gate_mlp[:, None, :].to(h.dtype) * h_ffn, stats
    return h + gate_mlp[:, None, :].to(h.dtype) * h_ffn


def _fused_block(blk: TransformerBlock, cfg: DiTConfig, h, carry: tuple, cos, sin, mod,
                 y_kv, x_mask, y_mask, compute_dtype, route: Route):
    """One block of the planned serving step on a fused `route`: the
    math of `_block_apply` (forward only, fp32 h), with its token-wise passes
    in K5 - K8 (ops/dit_fused.py): K5 -> wqkv -> K6 -> K3a self and cross ->
    K8 -> wo -> K5 -> w13 -> K7 -> w2. carry: the previous block's MLP branch
    and gate, (None, None) before the first block; its residual is added by
    this block's entry K5. h may be updated in place. Returns (h, carry):
    h after the attention residual, and this block's (MLP branch, gate)."""
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
    att, ff = blk.attention, blk.feed_forward
    h, x_attn_in = residual_norm_modulate(h, *carry, blk.attention_norm.weight, shift_msa,
                                          scale_msa, cfg.norm_eps,
                                          _gemm_in_dtype(att.wqkv, compute_dtype))
    h_attn = attention_apply_heads(
        att, x_attn_in, cos, sin, y_kv, x_mask=x_mask, y_mask=y_mask,
        n_heads=cfg.num_heads, n_kv_heads=cfg.n_kv_heads, compute_dtype=compute_dtype,
        route=route)
    h, x_ffn_in = residual_norm_modulate(h, h_attn, gate_msa, blk.ffn_norm.weight, shift_mlp,
                                         scale_mlp, cfg.norm_eps,
                                         _gemm_in_dtype(ff.w13, compute_dtype))
    x13 = dense(x_ffn_in, ff.w13, None, compute_dtype, names=("ffn_h1", "ffn_h3"))
    h_ffn = dense(swiglu(x13), ff.w2.weight, None, compute_dtype, names=("ffn_out",))
    return h, (h_ffn, gate_mlp)


def _gemm_in_dtype(w, compute_dtype) -> torch.dtype:
    """The dtype `dense` takes its input in: fp32 for an int8 weight (w8a8
    quantizes the activations from fp32), else the compute dtype."""
    return torch.float32 if isinstance(w, QuantWeight) else compute_dtype


def _pooled(context: torch.Tensor, context_mask: Optional[torch.Tensor]):
    ctx_f = context.float()
    if context_mask is None:
        return ctx_f.mean(dim=1)
    mf = context_mask.float()[:, :, None]
    return (ctx_f * mf).sum(dim=1) / mf.sum(dim=1).clamp_min(1.0)


def _cap_emb(dit: DiT, context, context_mask):
    ln, lin = dit.cap_embedder
    return linear(lin, layer_norm(_pooled(context, context_mask), ln.weight,
                                  ln.bias, eps=1e-5))


def _final(dit: DiT, x: torch.Tensor, shift, scale) -> torch.Tensor:
    x = modulate(layer_norm(x.float(), eps=1e-6), shift, scale)
    x = linear(dit.final_layer.linear, x)
    return x.transpose(1, 2).float()


def _embed(dit: DiT, x: torch.Tensor, compute_dtype):
    cfg = dit.cfg
    h = linear(dit.proj_in, x.transpose(1, 2), compute_dtype)
    if cfg.fp32_residual:
        h = h.float()
    cos, sin = precompute_rope(cfg.head_dim, x.shape[-1],
                               rope_scaling_factor=cfg.rope_scaling_factor,
                               ntk_factor=cfg.ntk_factor, device=x.device)
    return h, cos, sin


def _dit_block(blk: TransformerBlock, cfg: DiTConfig, h, cos, sin, adaln,
               context, x_mask, context_mask, compute_dtype, route: Route, tp=None, fsdp=None):
    """One block of dit_apply, its modulation and normed context included
    (the body JAX's remat recomputes), its FSDP shards gathered inside."""
    with gathered(fsdp, blk):
        mod = linear(blk.adaLN_modulation[1], silu(adaln.float()))
        y = rms_norm(blk.attention_y_norm.weight, context, cfg.norm_eps)
        return _block_apply(blk, cfg, h, cos, sin, mod, route, y=y, x_mask=x_mask,
                            y_mask=context_mask, compute_dtype=compute_dtype, tp=tp)


def dit_apply(dit: DiT, x: torch.Tensor, t: torch.Tensor,
              context: torch.Tensor, x_mask: Optional[torch.Tensor] = None,
              context_mask: Optional[torch.Tensor] = None,
              compute_dtype: Optional[torch.dtype] = torch.bfloat16,
              training: bool = False) -> torch.Tensor:
    """x: (B, C, T); t: (B,) integer timesteps; context: (B, Ly, ctx).
    Returns the (B, C, T) fp32 velocity. training=True selects the training
    flash threshold. A DiT sharded over a model group (dit.tp) runs
    Megatron's tensor parallelism, with cfg.seq_parallel its sequence
    parallelism; one sharded over the data group (dit.fsdp) gathers its
    parameters as it goes."""
    cfg = dit.cfg
    route = dit_route(cfg, x.shape[-1], training)
    tp = getattr(dit, "tp", None)
    if tp is not None:
        tp = tp.with_seq_parallel(cfg.seq_parallel)
    fsdp = getattr(dit, "fsdp", None)
    with gathered(fsdp, dit.proj_in, dit.t_embedder, dit.cap_embedder, dit.final_layer):
        h, cos, sin = _embed(dit, x, compute_dtype)
        adaln = dit.t_embedder(t) + _cap_emb(dit, context, context_mask)
        if tp is not None:
            h = tp.split_seq(h)
        remat = cfg.remat and torch.is_grad_enabled()
        ckpt = {"use_reentrant": False}
        if remat and cfg.remat_policy != "nothing":  # "nothing": a plain checkpoint
            ckpt["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                   remat_policy_fn(cfg.remat_policy))
        for blk in dit.blocks:
            args = (blk, cfg, h, cos, sin, adaln, context, x_mask, context_mask,
                    compute_dtype, route, tp, fsdp)
            h = checkpoint(_dit_block, *args, **ckpt) if remat else _dit_block(*args)
        if tp is not None:
            h = tp.join_seq(h)
        fl = dit.final_layer
        shift, scale = linear(fl.adaLN_modulation[1], silu(adaln.float())).chunk(2, -1)
        return _final(dit, h, shift, scale)


@torch.no_grad()
def dit_sample_plan(dit: DiT, t_ints: torch.Tensor, context: torch.Tensor,
                    context_mask: Optional[torch.Tensor] = None,
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16) -> dict:
    """Token-independent tensors for a known timestep grid.

    t_ints: (S,) integer timesteps; context: (B, Ly, ctx) (for CFG the dual
    batch [uc; c]). Returns {"mods": (S, depth, B, 6H) fp32,
    "final": (S, B, 2H) fp32, "yk"/"yv": per-block lists of contiguous
    head-major (B, n_kv, Ly, head_dim), the flash kernels' layout, so no
    step transposes them}.
    """
    cfg = dit.cfg
    t_emb = dit.t_embedder(t_ints)                               # (S, H)
    adaln = silu(t_emb[:, None, :] + _cap_emb(dit, context, context_mask)[None])
    # all blocks' modulations in one batched GEMM
    ada = [blk.adaLN_modulation[1] for blk in dit.blocks]
    w_ada = torch.stack([m.weight.float() for m in ada])         # (depth, 6H, H)
    b_ada = torch.stack([m.bias.float() for m in ada])
    mods = torch.einsum("sbh,dmh->sdbm", adaln, w_ada) + b_ada[None, :, None, :]
    fl = dit.final_layer.adaLN_modulation[1]
    final = torch.einsum("sbh,mh->sbm", adaln, fl.weight.float()) + fl.bias.float()

    ctx_f = context.float()
    yf = ctx_f * torch.rsqrt(ctx_f.pow(2).mean(-1, keepdim=True) + cfg.norm_eps)
    yf = yf.to(context.dtype)
    yk, yv = [], []
    for blk in dit.blocks:
        yn = yf * blk.attention_y_norm.weight.to(context.dtype)
        k, v = context_kv(blk.attention, yn.to(compute_dtype or yn.dtype),
                          compute_dtype, getattr(dit, "tp", None))
        yk.append(k.contiguous())
        yv.append(v.contiguous())
    return {"mods": mods, "final": final, "yk": yk, "yv": yv}


def dit_apply_planned(dit: DiT, x: torch.Tensor, mods: torch.Tensor,
                      final_mod: torch.Tensor, yk, yv,
                      x_mask: Optional[torch.Tensor] = None,
                      y_mask: Optional[torch.Tensor] = None,
                      compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                      return_stats: bool = False):
    """dit_apply for one step of a plan (mods: (depth, B, 6H),
    final_mod: (B, 2H), yk/yv: per-block (B, n_kv, Ly, head_dim)), its
    blocks as `_fused_block` or `_block_apply` on `dit_route`'s route for
    this device, dtype and weight layout. return_stats: also {"attn_in",
    "ffn_in": (depth, H), "ffn_prod": (depth, H')}, the per-block,
    per-channel amax of the quantized-GEMM inputs."""
    cfg = dit.cfg
    tp = getattr(dit, "tp", None)
    route = dit_route(cfg, x.shape[-1], device_type=x.device.type,
                      dtype=compute_dtype or x.dtype, grad_enabled=torch.is_grad_enabled(),
                      y_masked=y_mask is not None, tp=tp, return_stats=return_stats,
                      fused_wqkv=dit.blocks[0].attention.wqkv is not None)
    h, cos, sin = _embed(dit, x, compute_dtype)
    if route.fused:
        carry = (None, None)
        for i, blk in enumerate(dit.blocks):
            h, carry = _fused_block(blk, cfg, h, carry, cos, sin, mods[i], (yk[i], yv[i]),
                                    x_mask, y_mask, compute_dtype, route)
        trace.counts["dit_fused"] += len(dit.blocks)
        h_ffn, gate_mlp = carry
        shift, scale = final_mod.chunk(2, dim=-1)
        return _final(dit, h + gate_mlp[:, None, :] * h_ffn, shift, scale)
    trace.counts["dit_plain"] += len(dit.blocks)
    stats = []
    for i, blk in enumerate(dit.blocks):
        h = _block_apply(blk, cfg, h, cos, sin, mods[i], route, y_kv=(yk[i], yv[i]),
                         x_mask=x_mask, y_mask=y_mask,
                         compute_dtype=compute_dtype, return_stats=return_stats,
                         tp=tp and tp.with_seq_parallel(False))
        if return_stats:
            h, st = h
            stats.append(st)
    shift, scale = final_mod.chunk(2, dim=-1)
    out = _final(dit, h, shift, scale)
    if return_stats:
        return out, {k: torch.stack([st[k] for st in stats]) for k in stats[0]}
    return out

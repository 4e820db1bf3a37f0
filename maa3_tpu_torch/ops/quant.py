"""int8 (w8a8) serving of the DiT's per-step GEMMs (counterpart of
maa3_tpu/ops/quant.py).

- `quantize_weight_int8`: symmetric int8 weights with one scale per output
  channel, or per (group of `group_size` input channels, output channel);
- `dense_w8a8`: activations quantized per token (per (token, group) in the
  grouped layout) at run time, the int8 x int8 -> int32 product
  (`torch._int_mm`, the counterpart of JAX's int8 `lax.dot_general`), the
  scales applied to the int32 result in fp32;
- SmoothQuant: `calibrate_dit_smooth` (per-(block, channel) amax of the
  three quantized-GEMM inputs over one real CFG ODE) and
  `smooth_migrate_dit` (the migration scales folded into the weights);
- `quantize_dit_serving`: the serving copy's wqkv / w13 / w2 (fused or
  unfused) replaced by int8 weights. MoE expert stacks stay float, so on the
  video MoE only the attention projections are quantized, as in JAX.

Layouts: the port's matmul weights are (out, in), so `w_q` is (..., out, in)
with `w_scale` (..., out), and the grouped `w_q` is (..., G, out, gs) with
`w_scale` (..., G, out): JAX's codes and scales transposed, equal for the
same fp32 weights. `dense` (ops/basic.py) sends a `QuantWeight` here.

`torch._int_mm` on the card wants more than 16 rows and K, N multiples of 8:
`int8_matmul` pads with zeros (exact), on every device, so the CPU runs the
same code. The quantization is plain PyTorch ops (about ten launches per
GEMM on the card); `int_mm_calls` counts the int8 products.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

# int8 products launched (int8_matmul), for the launch logs of chip_smoke.py
int_mm_calls = 0


class QuantWeight(nn.Module):
    """An int8 matmul weight: w_q (..., out, in) int8 and w_scale (..., out)
    fp32; with group_size, w_q (..., G, out, group_size) and w_scale
    (..., G, out). amax_group: the process group over which a row-parallel
    weight's input columns are sharded (parallel/tp.py), else None."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, group_size: int = 0):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.group_size = group_size
        self.amax_group = None


class QuantLinear(nn.Module):
    """Stands in for an unfused nn.Linear of the serving copy: `.weight` is
    its QuantWeight, so the call sites' `dense(x, mod.weight)` run w8a8."""

    def __init__(self, weight: QuantWeight):
        super().__init__()
        self.weight = weight


def _per_127(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 as a true division on every device: CUDA
    divides by a Python scalar as a multiply by its reciprocal, which can
    round one ulp away from the CPU's (and JAX's) quotient and move a code."""
    return amax.clamp_min(1e-12) / amax.new_full((), 127.0)


def _quantize_rows(wf: torch.Tensor):
    """Symmetric int8 over the last axis: (codes, scale without that axis)."""
    amax = wf.abs().amax(dim=-1, keepdim=True)
    scale = _per_127(amax)
    w_q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w_q, scale.squeeze(-1)


def quantize_weight_int8(w: torch.Tensor, group_size: int = 0) -> QuantWeight:
    """Per-output-channel int8 of a (..., out, in) weight (leading axes, such
    as a stacked depth axis, kept); group_size > 0: per (group, output
    channel) over contiguous groups of input channels
    (maa3_tpu/ops/quant.py:36)."""
    wf = w.detach().float()
    if group_size:
        d_in = wf.shape[-1]
        if d_in % group_size:
            raise ValueError(f"input width {d_in} is not a multiple of group "
                             f"size {group_size}")
        wf = wf.reshape(wf.shape[:-1] + (d_in // group_size, group_size))
        wf = wf.movedim(-2, -3)                            # (..., G, out, gs)
    w_q, scale = _quantize_rows(wf)
    return QuantWeight(w_q, scale, group_size)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    n = t.shape[dim]
    if n >= size:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, size - n]
    return F.pad(t, pad)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 through torch._int_mm; rows
    padded to at least 17 and K, N to multiples of 8 with zeros, which adds
    nothing to the sums."""
    global int_mm_calls
    m, k = a.shape
    n = b.shape[1]
    k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
    a = _pad_to(_pad_to(a, 0, 17 if m <= 16 else m), 1, k8)
    b = _pad_to(_pad_to(b, 0, k8), 1, n8)
    int_mm_calls += 1
    out = torch._int_mm(a, b)
    return out[:m, :n] if out.shape != (m, n) else out


def quantize_activations(xf: torch.Tensor, amax_group=None):
    """Per-row symmetric int8 of fp32 activations over the last axis:
    (codes, scale (..., 1)). amax_group: the rows' features are sharded over
    this process group (a row-parallel weight, parallel/tp.py), whose MAX
    all-reduce gives the whole row's amax, so the codes are one device's."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if amax_group is not None:
        import torch.distributed as dist
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=amax_group)
    sx = _per_127(amax)
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def dense_w8a8(x: torch.Tensor, qw: QuantWeight, b: Optional[torch.Tensor] = None,
               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = dequant(quant(x) @ w_q^T) (+ b), in compute_dtype when given, else
    fp32 (maa3_tpu/ops/quant.py:58). x: (..., in). A row-parallel weight
    (`amax_group` set, parallel/tp.py) holds this rank's input columns:
    the activations' amax is all-reduced with MAX and the int32 products
    with SUM over that group, so y is one device's, already reduced."""
    lead = x.shape[:-1]
    xf = x.float().reshape(-1, x.shape[-1])
    w_q = qw.w_q
    ws = qw.w_scale.float()
    if qw.group_size:                                    # w_q (G, out, gs)
        g, out, gs = w_q.shape
        x_q, sx = quantize_activations(xf.reshape(-1, g, gs))  # (M, G, gs), (M, G, 1)
        x_q = x_q.transpose(0, 1).contiguous()           # (G, M, gs)
        y = None
        for j in range(g):  # JAX's sum over G of acc * sx * ws, in order
            part = int8_matmul(x_q[j], w_q[j].t()).float() * sx[:, j] * ws[j]
            y = part if y is None else y + part
    else:
        group = qw.amax_group
        x_q, sx = quantize_activations(xf, group)
        acc = int8_matmul(x_q, w_q.t())
        if group is not None:  # a row-parallel weight: the exact int32 sum over K
            import torch.distributed as dist
            dist.all_reduce(acc, group=group)
        y = acc.float() * sx * ws
    if b is not None:
        y = y + b.float()
    y = y.reshape(lead + (y.shape[-1],))
    return y.to(compute_dtype) if compute_dtype is not None else y


# -- SmoothQuant ----------------------------------------------------------------

def _smooth_scales(a_x: torch.Tensor, a_w: torch.Tensor, alpha: float) -> torch.Tensor:
    """s_j = amax(X_j)^a / amax(W_j)^(1-a), 1 for dead channels, clipped to
    [1e-2, 1e2] (maa3_tpu/ops/quant.py:102)."""
    s = (torch.pow(a_x.clamp_min(1e-12), alpha)
         / torch.pow(a_w.clamp_min(1e-12), 1.0 - alpha))
    s = torch.where(a_x > 1e-12, s, torch.ones_like(s))
    return s.clamp(1e-2, 1e2)


def _in_amax(w: torch.Tensor) -> torch.Tensor:
    """Per-input-channel amax of an (out, in) weight."""
    return w.float().abs().amax(dim=0)


@torch.no_grad()
def calibrate_dit_smooth(dit, x0: torch.Tensor, context: torch.Tensor,
                         uncond: torch.Tensor, guidance_scale: float = 5.0,
                         steps: int = 25,
                         compute_dtype: Optional[torch.dtype] = torch.bfloat16
                         ) -> Dict[str, torch.Tensor]:
    """One real CFG Euler ODE from x0, with the per-(block, channel) amax of
    the three quantized-GEMM inputs (wqkv in, w13 in, and w2 in: the SwiGLU
    product) over every step: {"attn_in", "ffn_in": (depth, H), "ffn_prod":
    (depth, H')} fp32 (maa3_tpu/ops/quant.py:116). `dit` runs as given: its
    config's fp32_residual and its weights."""
    from maa3_tpu_torch.diffusion import cfm
    from maa3_tpu_torch.models.dit import dit_apply_planned, dit_sample_plan
    ctx_in = torch.cat([uncond, context], dim=0)
    t_ints = torch.as_tensor(cfm.planned_t_ints(steps), device=x0.device)
    plan = dit_sample_plan(dit, t_ints, ctx_in, compute_dtype=compute_dtype)
    x, agg = x0.float(), None
    for s, (_, dt) in enumerate(cfm._pairs(steps, None)):
        e, st = dit_apply_planned(dit, torch.cat([x, x]), plan["mods"][s],
                                  plan["final"][s], plan["yk"], plan["yv"],
                                  compute_dtype=compute_dtype, return_stats=True)
        e_uc, e_c = e.chunk(2)
        x = x + dt * (e_uc + guidance_scale * (e_c - e_uc))
        agg = st if agg is None else {k: torch.maximum(agg[k], v) for k, v in st.items()}
    return agg


@torch.no_grad()
def smooth_migrate_dit(dit, stats: Dict[str, torch.Tensor], alpha: float = 0.5):
    """SmoothQuant scale migration folded into the weights of `dit` (in place;
    fused wqkv / w13 tensors or the unfused nn.Linears), exact in real
    arithmetic (maa3_tpu/ops/quant.py:159):

      wqkv input / s1: attention_norm.weight /= s1, adaLN shift_msa /= s1,
                       wqkv input columns *= s1
      w13 input / s2:  ffn_norm.weight /= s2, adaLN shift_mlp /= s2,
                       w1 / w3 input columns *= s2
      w2 input / s3:   w3's output rows /= s3, w2 input columns *= s3

    A MoE block's experts are left as they are (s2, s3 not applied).
    Returns `dit`."""
    from maa3_tpu_torch.ops.ffn import FeedForward
    for i, blk in enumerate(dit.blocks):
        att, ff = blk.attention, blk.feed_forward
        h = blk.attention_norm.weight.shape[-1]
        dev = blk.attention_norm.weight.device
        if att.wqkv is not None:
            a_w1 = _in_amax(att.wqkv)
        else:
            a_w1 = torch.maximum(torch.maximum(_in_amax(att.wq.weight),
                                               _in_amax(att.wk.weight)),
                                 _in_amax(att.wv.weight))
        s1 = _smooth_scales(stats["attn_in"][i].to(dev).float(), a_w1, alpha)
        if att.wqkv is not None:
            att.wqkv = att.wqkv * s1[None, :].to(att.wqkv.dtype)
        else:
            for lin in (att.wq, att.wk, att.wv):
                lin.weight.data = lin.weight.data * s1[None, :].to(lin.weight.dtype)
        blk.attention_norm.weight.data = blk.attention_norm.weight.data / s1
        s2 = None
        if isinstance(ff, FeedForward):  # dense SwiGLU; MoE experts stay as they are
            if ff.w13 is not None:
                a_w2 = _in_amax(ff.w13)
            else:
                a_w2 = torch.maximum(_in_amax(ff.w1.weight), _in_amax(ff.w3.weight))
            s2 = _smooth_scales(stats["ffn_in"][i].to(dev).float(), a_w2, alpha)
            s3 = _smooth_scales(stats["ffn_prod"][i].to(dev).float(),
                                _in_amax(ff.w2.weight), alpha)
            if ff.w13 is not None:
                w = ff.w13 * s2[None, :].to(ff.w13.dtype)
                hp = w.shape[0] // 2
                w = torch.cat([w[:hp], w[hp:] / s3[:, None].to(w.dtype)])
                ff.w13 = w
            else:
                ff.w1.weight.data = ff.w1.weight.data * s2[None, :].to(ff.w1.weight.dtype)
                w3 = ff.w3.weight.data * s2[None, :].to(ff.w3.weight.dtype)
                ff.w3.weight.data = w3 / s3[:, None].to(w3.dtype)
            ff.w2.weight.data = ff.w2.weight.data * s3[None, :].to(ff.w2.weight.dtype)
            blk.ffn_norm.weight.data = blk.ffn_norm.weight.data / s2
        # adaLN chunks along the 6H output rows: [shift_msa, scale_msa,
        # gate_msa, shift_mlp, scale_mlp, gate_mlp]
        lin = blk.adaLN_modulation[1]
        w, b = lin.weight.data.clone(), lin.bias
        w[0:h] = w[0:h] / s1[:, None].to(w.dtype)
        if s2 is not None:
            w[3 * h:4 * h] = w[3 * h:4 * h] / s2[:, None].to(w.dtype)
        lin.weight.data = w
        if b is not None:
            bb = b.data.clone()
            bb[0:h] = bb[0:h] / s1.to(bb.dtype)
            if s2 is not None:
                bb[3 * h:4 * h] = bb[3 * h:4 * h] / s2.to(bb.dtype)
            b.data = bb
    return dit


@torch.no_grad()
def quantize_dit_serving(dit, group_size: int = 0, skip_w2: bool = False,
                         classes: Optional[Iterable[str]] = None,
                         group_for: Optional[Dict[str, int]] = None):
    """Replace the per-step GEMM weights of `dit` (in place) by int8: the qkv
    projection (wqkv or wq / wk / wv), the SwiGLU's w13 (or w1 / w3) and w2,
    in either layout (maa3_tpu/ops/quant.py:247). Quantize from fp32 weights.
    group_size: per-group scales; skip_w2 leaves w2 float; classes restricts
    to a subset of {wqkv, w13, w2}; group_for gives a class its own group size.
    MoE experts stay float. Returns `dit`."""
    from maa3_tpu_torch.ops.ffn import FeedForward
    active = (set(classes) if classes is not None
              else {"wqkv", "w13"} | (set() if skip_w2 else {"w2"}))
    gf = group_for or {}

    def q(w, cls):
        return quantize_weight_int8(w, gf.get(cls, group_size))

    for blk in dit.blocks:
        att, ff = blk.attention, blk.feed_forward
        if "wqkv" in active:
            if att.wqkv is not None:
                att.wqkv = q(att.wqkv, "wqkv")
            else:
                for name in ("wq", "wk", "wv"):
                    setattr(att, name, QuantLinear(q(getattr(att, name).weight, "wqkv")))
        if isinstance(ff, FeedForward):  # dense SwiGLU; MoE experts stay float
            if "w13" in active:
                if ff.w13 is not None:
                    ff.w13 = q(ff.w13, "w13")
                else:
                    ff.w1 = QuantLinear(q(ff.w1.weight, "w13"))
                    ff.w3 = QuantLinear(q(ff.w3.weight, "w13"))
            if "w2" in active:
                ff.w2 = QuantLinear(q(ff.w2.weight, "w2"))
    return dit


def quant_weights(dit) -> Dict[str, QuantWeight]:
    """Every QuantWeight of a module by its name (tests compare the codes)."""
    return {n: m for n, m in dit.named_modules() if isinstance(m, QuantWeight)}

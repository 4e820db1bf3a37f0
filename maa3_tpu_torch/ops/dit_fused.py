"""K5 - K8: the bf16 serving DiT block's token-wise passes between its GEMMs,
fused (CUDA C++, csrc/dit_norm.cu, dit_rope.cu, dit_merge.cu and
dit_swiglu.cu; no TPU counterpart: XLA fuses these passes itself).

- `residual_norm_modulate` (K5): the gated residual, RMSNorm and adaLN
  modulate of one site in one pass over the fp32 residual stream, giving the
  input of the next GEMM (wqkv or w13): bf16, or fp32 for an int8 GEMM,
  which quantizes its input from fp32 (ops/quant.py dense_w8a8).
- `rope_qkv_heads` (K6): RoPE on the fused wqkv product, q, k and v written
  as contiguous head-major (B, heads, L, hd) bf16 tensors, the layout the
  flash forward (K3a) reads.
- `gated_merge_heads` (K8): K3a's head-major self- and cross-attention
  outputs merged through the tanh of the cross-attention gate, written
  token-major (B, L, H * hd) for wo.
- `swiglu` (K7): the SwiGLU gate silu(x1) * x3 on the fused w13 product,
  written as w2's bf16 input (an int8 w2 quantizes from it, as it does from
  the unfused chain's).

The planned serving step runs them in its fused block (models/dit.py
`_fused_block` and ops/attention.py `attention_apply_heads`, where
`dit_route` says so). On a CPU tensor each entry point runs its plain
PyTorch version; on a CUDA tensor it launches the kernel or raises. The
plain versions round where the unfused chain rounds (ops/basic.py rms_norm,
modulate; ops/rope.py apply_rope; the gated residual of models/dit.py
`_block_apply`; ops/attention.py `_attend`'s merge; ops/ffn.py's gate), so
on the CPU they give its bits and on the card they are the kernels'
yardstick: K6 and K8 give the same bits, K7 too wherever the card's expf is
PyTorch's sigmoid's, K5 the same h' and an x whose sum of squares is added
in another order (its mean multiplies by the fp32 1/D, as torch.mean's
reduction does on the card).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from maa3_tpu_torch import cuda
from maa3_tpu_torch.ops.basic import silu

# kernel launches by name (chip_smoke and the card tests read them)
launches = {"K5": 0, "K6": 0, "K7": 0, "K8": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def residual_norm_modulate_plain(h: torch.Tensor, branch: Optional[torch.Tensor],
                                 gate: Optional[torch.Tensor], weight: torch.Tensor,
                                 shift: torch.Tensor, scale: torch.Tensor, eps: float,
                                 out_dtype: torch.dtype = torch.bfloat16
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, L, D) fp32, branch (B, L, D) bf16 or None, gate / shift / scale
    (B, D) fp32, weight (D,) fp32 -> (h', x): h' = h + gate * branch (h
    itself without a branch), x = ((h' * rsqrt(mean(h'^2) + eps)) * w) *
    (1 + scale) + shift in out_dtype (bf16 or fp32)."""
    if branch is not None:
        h = h + gate[:, None, :] * branch.float()
    normed = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + eps)
    x = (normed * weight) * (1.0 + scale[:, None, :]) + shift[:, None, :]
    return h, x.to(out_dtype)


def rope_qkv_heads_plain(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                         n_heads: int, n_kv: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """qkv (B, L, (n_heads + 2 n_kv) * hd), cos / sin (>= L, hd / 2) fp32 ->
    contiguous (B, n_heads, L, hd) q and (B, n_kv, L, hd) k, v in qkv's dtype:
    each pair (x[2i], x[2i+1]) of q and k rotated in fp32, rounded once."""
    b, l, w = qkv.shape
    hd = w // (n_heads + 2 * n_kv)
    q, k, v = qkv.reshape(b, l, -1, hd).transpose(1, 2).split([n_heads, n_kv, n_kv], dim=1)
    c, s = cos[:l], sin[:l]

    def rot(t):
        tf = t.float()
        xr, xi = tf[..., 0::2], tf[..., 1::2]
        out = torch.stack([xr * c - xi * s, xr * s + xi * c], dim=-1)
        return out.flatten(-2).to(qkv.dtype)

    return rot(q), rot(k), v.contiguous()


def gated_merge_heads_plain(out: torch.Tensor, out_y: torch.Tensor,
                            gate: torch.Tensor) -> torch.Tensor:
    """out, out_y (B, H, L, hd) self- and cross-attention outputs, gate (H,)
    -> (B, L, H * hd) out + out_y * tanh(gate) in out_y's dtype, each step
    rounded to it (ops/attention.py `_attend`)."""
    b, h, l, hd = out.shape
    g = torch.tanh(gate.float()).to(out_y.dtype)
    return (out + out_y * g[None, :, None, None]).transpose(1, 2).reshape(b, l, h * hd)


def swiglu_plain(x13: torch.Tensor) -> torch.Tensor:
    """x13 (..., 2F), the fused w13 product -> (..., F) silu(x1) * x3 in its
    dtype, each step rounded to it (ops/ffn.py feed_forward_apply)."""
    x1, x3 = x13.chunk(2, dim=-1)
    return silu(x1) * x3


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def residual_norm_modulate(h: torch.Tensor, branch: Optional[torch.Tensor],
                           gate: Optional[torch.Tensor], weight: torch.Tensor,
                           shift: torch.Tensor, scale: torch.Tensor, eps: float,
                           out_dtype: torch.dtype = torch.bfloat16
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5; the contract of residual_norm_modulate_plain. On the card h' is
    written over h, which is returned."""
    if h.device.type == "cpu":
        return residual_norm_modulate_plain(h, branch, gate, weight, shift, scale, eps,
                                            out_dtype)
    if h.device.type != "cuda":
        raise ValueError(f"residual_norm_modulate: unsupported device {h.device}")
    b, l, d = h.shape
    mods = (shift, scale) if branch is None else (gate, shift, scale)
    if (h.dtype != torch.float32 or not h.is_contiguous() or d % 8
            or weight.shape != (d,) or weight.dtype != torch.float32
            or not weight.is_contiguous() or out_dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"residual_norm_modulate: need a contiguous fp32 h (B, L, D) with "
                         f"D % 8 == 0, an fp32 (D,) weight and a bf16 or fp32 x, got h "
                         f"{tuple(h.shape)} {h.dtype}, weight {tuple(weight.shape)} "
                         f"{weight.dtype}, x {out_dtype}")
    if branch is not None and (branch.shape != h.shape or branch.dtype != torch.bfloat16
                               or not branch.is_contiguous()):
        raise ValueError(f"residual_norm_modulate: branch {tuple(branch.shape)} "
                         f"{branch.dtype} must be a contiguous bf16 {tuple(h.shape)}")
    stride = shift.stride(0)
    if any(m.shape != (b, d) or m.dtype != torch.float32 or m.stride() != (stride, 1)
           for m in mods) or stride % 4:
        raise ValueError("residual_norm_modulate: gate, shift and scale must be fp32 (B, D) "
                         "rows of one stride, a multiple of 4, with unit column stride")
    if not _aligned(h, weight, *mods, *(() if branch is None else (branch,))):
        raise ValueError("residual_norm_modulate: every operand must start on 16 bytes")
    x = torch.empty(h.shape, dtype=out_dtype, device=h.device)
    lib = cuda.load()
    with torch.cuda.device(h.device):
        err = lib.maa3_residual_norm_modulate(
            h.data_ptr(), None if branch is None else branch.data_ptr(),
            None if branch is None else gate.data_ptr(), shift.data_ptr(),
            scale.data_ptr(), weight.data_ptr(), x.data_ptr(), b * l, l, d, stride,
            ctypes.c_float(eps), int(out_dtype == torch.float32), cuda.stream_ptr(h))
    cuda.check(err, "residual_norm_modulate")
    launches["K5"] += 1
    return h, x


def rope_qkv_heads(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   n_heads: int, n_kv: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6; the contract of rope_qkv_heads_plain (the same bits)."""
    if qkv.device.type == "cpu":
        return rope_qkv_heads_plain(qkv, cos, sin, n_heads, n_kv)
    if qkv.device.type != "cuda":
        raise ValueError(f"rope_qkv_heads: unsupported device {qkv.device}")
    b, l, w = qkv.shape
    hd = w // (n_heads + 2 * n_kv)
    if (qkv.dtype != torch.bfloat16 or not qkv.is_contiguous()
            or w != (n_heads + 2 * n_kv) * hd or hd % 2):
        raise ValueError(f"rope_qkv_heads: need a contiguous bf16 (B, L, (H + 2 Hkv) * hd) "
                         f"with an even hd, got {tuple(qkv.shape)} {qkv.dtype} for "
                         f"{n_heads} + 2 x {n_kv} heads")
    cos, sin = cos[:l].contiguous(), sin[:l].contiguous()
    if any(t.shape != (l, hd // 2) or t.dtype != torch.float32 for t in (cos, sin)):
        raise ValueError(f"rope_qkv_heads: cos / sin must be fp32 (>= {l}, {hd // 2})")
    q = torch.empty((b, n_heads, l, hd), dtype=qkv.dtype, device=qkv.device)
    k = torch.empty((b, n_kv, l, hd), dtype=qkv.dtype, device=qkv.device)
    v = torch.empty_like(k)
    lib = cuda.load()
    with torch.cuda.device(qkv.device):
        err = lib.maa3_rope_qkv_heads(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), b, l, n_heads, n_kv, hd, cuda.stream_ptr(qkv))
    cuda.check(err, "rope_qkv_heads")
    launches["K6"] += 1
    return q, k, v


def gated_merge_heads(out: torch.Tensor, out_y: torch.Tensor,
                      gate: torch.Tensor) -> torch.Tensor:
    """K8; the contract of gated_merge_heads_plain (the same bits)."""
    if out.device.type == "cpu":
        return gated_merge_heads_plain(out, out_y, gate)
    if out.device.type != "cuda":
        raise ValueError(f"gated_merge_heads: unsupported device {out.device}")
    b, h, l, hd = out.shape
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous() or t.shape != out.shape
           for t in (out, out_y)):
        raise ValueError(f"gated_merge_heads: need contiguous bf16 (B, H, L, hd) outputs of "
                         f"one shape, got {tuple(out.shape)} {out.dtype} and "
                         f"{tuple(out_y.shape)} {out_y.dtype}")
    if (gate.shape != (h,) or gate.dtype not in (torch.float32, torch.bfloat16)
            or not gate.is_contiguous()):
        raise ValueError(f"gated_merge_heads: gate {tuple(gate.shape)} {gate.dtype} must be "
                         f"a contiguous fp32 or bf16 ({h},)")
    merged = torch.empty((b, l, h * hd), dtype=out.dtype, device=out.device)
    lib = cuda.load()
    with torch.cuda.device(out.device):
        err = lib.maa3_gated_merge_heads(
            out.data_ptr(), out_y.data_ptr(), gate.data_ptr(), merged.data_ptr(), b, l, h, hd,
            int(gate.dtype == torch.bfloat16), cuda.stream_ptr(out))
    cuda.check(err, "gated_merge_heads")
    launches["K8"] += 1
    return merged


def swiglu(x13: torch.Tensor) -> torch.Tensor:
    """K7; the contract of swiglu_plain."""
    if x13.device.type == "cpu":
        return swiglu_plain(x13)
    if x13.device.type != "cuda":
        raise ValueError(f"swiglu: unsupported device {x13.device}")
    f = x13.shape[-1] // 2
    if x13.dtype != torch.bfloat16 or not x13.is_contiguous() or x13.shape[-1] != 2 * f:
        raise ValueError(f"swiglu: need a contiguous bf16 (..., 2F) w13 product, got "
                         f"{tuple(x13.shape)} {x13.dtype}")
    out = torch.empty((*x13.shape[:-1], f), dtype=x13.dtype, device=x13.device)
    lib = cuda.load()
    with torch.cuda.device(x13.device):
        err = lib.maa3_swiglu(x13.data_ptr(), out.data_ptr(), x13.numel() // (2 * f), f,
                              cuda.stream_ptr(x13))
    cuda.check(err, "swiglu")
    launches["K7"] += 1
    return out

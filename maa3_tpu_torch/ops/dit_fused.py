"""K5 / K6: the bf16 serving DiT block's token-wise passes between its GEMMs,
fused (CUDA C++, csrc/dit_norm.cu and csrc/dit_rope.cu; no TPU counterpart:
XLA fuses these passes itself).

- `residual_norm_modulate` (K5): the gated residual, RMSNorm and adaLN
  modulate of one site in one pass over the fp32 residual stream, giving the
  input of the next GEMM (wqkv or w13): bf16, or fp32 for an int8 GEMM,
  which quantizes its input from fp32 (ops/quant.py dense_w8a8).
- `rope_qkv_heads` (K6): RoPE on the fused wqkv product, q, k and v written
  as contiguous head-major (B, heads, L, hd) bf16 tensors, the layout the
  flash forward (K3a) reads.

The planned serving step runs them in its fused block (models/dit.py
`_fused_block`, where `dit_route` says so). On a CPU tensor each entry point runs its plain
PyTorch version; on a CUDA tensor it launches the kernel or raises. The
plain versions round where the unfused chain rounds (ops/basic.py rms_norm,
modulate; ops/rope.py apply_rope; the gated residual of models/dit.py
`_block_apply`), so on the CPU they give its bits and on the card they are
the kernels' yardstick: K6 gives the same bits, K5 the same h' and an x whose
sum of squares is added in another order (its mean multiplies by the fp32
1/D, as torch.mean's reduction does on the card).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from maa3_tpu_torch import cuda

# kernel launches by name (chip_smoke and the card tests read them)
launches = {"K5": 0, "K6": 0}


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

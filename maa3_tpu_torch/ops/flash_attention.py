"""K3a / K3b / K4a / K4b / K4c: flash attention at O(L) memory, forward and
backward (counterpart of maa3_tpu/ops/flash_attention.py; the kernels are
CUDA C++, csrc/flash_fwd.cu, csrc/flash_bwd.cu and csrc/flash_bwd_split.cu).
The bf16 forward runs on the tensor cores (wgmma); the fp32 forward and the
backward kernels run fp32 FMA loops.

`flash_attention(q, k, v, mask)` on (B, H, L, D) tensors is differentiable
through `_FlashCore`, the counterpart of the JAX custom VJP `_flash_core`: the
forward saves q, k, v, o and the per-row natural-log log-sum-exp; the backward
takes delta = rowsum(do * o) in fp32 with a torch op, as JAX does outside
Pallas, and recomputes the probabilities from the saved lse.

The backward reads MAA3_FLASH_BWD at every call, as the JAX package does:
`fused` and `auto` (the default) run one fused pass (K4a) that gives dq, dk
and dv, with dq summed over key tiles by fp32 atomics; `split` runs K4b
(dk, dv; a block per key tile) then K4c (dq; a block per query tile, no
atomics, so dq is the same bits on every run). JAX's `auto` takes the split
only past the fused body's VMEM budget; K4a keeps dq in device memory, so
that budget does not exist here. On an H100 80GB HBM3 at 700 W the split
measured slower than K4a at every shape chip_smoke.py times, up to
(1, 16, 14336, 72) bf16, the first 256-multiple past JAX's split point
(K4b + K4c 177.7 ms against K4a 121.0 ms; its long-Lq timing, PERF.md), so
`auto` runs K4a at every length.

Routing of the forward is the JAX rule: the direct-softmax forward (K3a: the
row max over the whole key range first, then one exp pass) iff `block_k` is
None and round_up(Lk, 16) <= 1536, else the online-softmax forward (K3b, key
blocks of BLOCK_K with running max and rescaling). The two give the same
function up to where the probabilities are rounded to v's dtype.

Numerics follow the Pallas bodies: q is multiplied by scale * log2(e) in fp32
and rounded to q's dtype; exponentials are exp2; p is rounded to v's dtype
before P.V (and before dv), ds = p * (dp - delta) to q's dtype; the row sum
is clamped at 1e-30; lse = (m + log2 l) * ln 2. There is no padding: keys
past Lk, and keys whose mask is 0, contribute p = 0. A query row whose keys
are all masked therefore gives o = 0 and zero gradients (the JAX bodies give
sum(v) / Lk_pad there, which depends on their padding).

On a CPU tensor every entry point runs its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. The plain versions compute in fp32
on values rounded at the kernels' points, so on the card they are also the
kernels' yardstick of correctness.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Tuple

import torch

from maa3_tpu_torch import cuda

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
FAST_LK_CAP = 1536  # direct-softmax route up to this many (16-rounded) keys
BLOCK_K = 64        # key tile of the CUDA kernels; the plain online route uses it too
MAX_HEAD_DIM = 72   # the widest head dim the CUDA kernels are instantiated for

# kernel launches by name (chip_smoke resets and reads them)
launches = {"K3a": 0, "K3b": 0, "K4a": 0, "K4b": 0, "K4c": 0}

BWD_MODES = ("auto", "fused", "split")


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def route_for(lk: int, block_k: Optional[int] = None) -> str:
    """'direct' (K3a) or 'online' (K3b), as maa3_tpu/ops/flash_attention.py:485."""
    return "direct" if block_k is None and round_up(lk, 16) <= FAST_LK_CAP else "online"


def _scale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    return (q.float() * (scale * LOG2E)).to(q.dtype)


def _valid(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if mask is None else (mask != 0)[:, None, None, :]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def flash_fwd_plain(q, k, v, mask: Optional[torch.Tensor], scale: float,
                    route: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, H, Lq, D), k/v (B, H, Lk, D), mask (B, Lk) nonzero = valid, or
    None -> o (B, H, Lq, D) in q's dtype, lse (B*H, Lq) fp32."""
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    qs, kf, vf = _scale_q(q, scale).float(), k.float(), v.float()
    valid = _valid(mask)
    if route == "direct":
        s = qs @ kf.transpose(-1, -2)
        if valid is not None:
            s = s.masked_fill(~valid, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        if valid is not None:
            p = p.masked_fill(~valid, 0.0)
        l = p.sum(-1, keepdim=True)
        acc = p.to(v.dtype).float() @ vf
    elif route == "online":
        m = torch.full((b, h, lq, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, h, lq, 1), device=q.device)
        acc = torch.zeros(qs.shape, device=q.device)
        for k0 in range(0, lk, BLOCK_K):
            s = qs @ kf[:, :, k0:k0 + BLOCK_K].transpose(-1, -2)
            vb = None if valid is None else valid[..., k0:k0 + BLOCK_K]
            if vb is not None:
                s = s.masked_fill(~vb, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp2(s - m_new)
            if vb is not None:
                p = p.masked_fill(~vb, 0.0)
            alpha = torch.exp2(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).float() @ vf[:, :, k0:k0 + BLOCK_K]
            m = m_new
    else:
        raise ValueError(f"unknown flash route {route!r}")
    l = l.clamp_min(1e-30)
    o = (acc / l).to(q.dtype)
    lse = ((m + torch.log2(l)) * LN2).reshape(b * h, lq)
    return o, lse


def _bwd_p_ds(q, k, v, mask, lse, do, delta, scale):
    """The backward's recomputed p and ds (fp32, ds rounded to q's dtype),
    with the scaled q, k and do in fp32."""
    b, h, lq, _ = q.shape
    qs, kf, vf, dof = _scale_q(q, scale).float(), k.float(), v.float(), do.float()
    p = torch.exp2(qs @ kf.transpose(-1, -2) - lse.reshape(b, h, lq, 1) * LOG2E)
    valid = _valid(mask)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    dp = dof @ vf.transpose(-1, -2)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    return p, ds, qs, kf, dof


def flash_bwd_plain(q, k, v, mask: Optional[torch.Tensor], lse: torch.Tensor,
                    do: torch.Tensor, delta: torch.Tensor, scale: float):
    """Gradients from the saved lse (B*H, Lq) and delta (B, H, Lq) fp32 ->
    (dq, dk, dv) in the inputs' dtypes (K4a's function)."""
    p, ds, qs, kf, dof = _bwd_p_ds(q, k, v, mask, lse, do, delta, scale)
    dv = p.to(v.dtype).float().transpose(-1, -2) @ dof
    dk = (ds.transpose(-1, -2) @ qs) * LN2
    dq = (ds @ kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dkv_plain(q, k, v, mask: Optional[torch.Tensor], lse: torch.Tensor,
                        do: torch.Tensor, delta: torch.Tensor, scale: float):
    """(dk, dv) in k's and v's dtypes (K4b's function)."""
    p, ds, qs, _, dof = _bwd_p_ds(q, k, v, mask, lse, do, delta, scale)
    dv = p.to(v.dtype).float().transpose(-1, -2) @ dof
    dk = (ds.transpose(-1, -2) @ qs) * LN2
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, mask: Optional[torch.Tensor], lse: torch.Tensor,
                       do: torch.Tensor, delta: torch.Tensor, scale: float):
    """dq in q's dtype (K4c's function)."""
    _, ds, _, kf, _ = _bwd_p_ds(q, k, v, mask, lse, do, delta, scale)
    return ((ds @ kf) * scale).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name: str, q, k, v, mask) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in cuda.DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: need q, k, v all fp32 or all bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if (k.shape != (b, h, lk, d) or v.shape != k.shape or not 1 <= d <= MAX_HEAD_DIM
            or lq == 0 or lk == 0):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: need (B, H, L, D) with D <= {MAX_HEAD_DIM}")
    if b * h > 65535:
        raise ValueError(f"{name}: B*H = {b * h} exceeds the grid limit")
    if mask is not None and (mask.shape != (b, lk) or mask.dtype != torch.int32):
        raise ValueError(f"{name}: mask must be (B, Lk) int32, got "
                         f"{tuple(mask.shape)} {mask.dtype}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_fwd(q, k, v, mask: Optional[torch.Tensor], scale: float,
              route: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3a (route 'direct') or K3b ('online'); same contract as flash_fwd_plain."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, mask, scale, route)
    _check("flash_fwd", q, k, v, mask)
    if route not in ("direct", "online"):
        raise ValueError(f"unknown flash route {route!r}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    lib = cuda.load()
    with torch.cuda.device(q.device):
        err = lib.maa3_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), o.data_ptr(),
            lse.data_ptr(), b * h, h, lq, lk, d, ctypes.c_float(scale * LOG2E),
            cuda.DTYPE_CODES[q.dtype], int(route == "direct"), cuda.stream_ptr(q))
    cuda.check(err, "flash_fwd")
    launches["K3a" if route == "direct" else "K3b"] += 1
    return o, lse


def _bwd_operands(name: str, q, k, v, mask, lse, do, delta):
    _check(name, q, k, v, mask)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: do {tuple(do.shape)} {do.dtype} must match q")
    return (q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous(),
            lse.float().contiguous(), delta.float().contiguous())


def flash_bwd(q, k, v, mask: Optional[torch.Tensor], lse: torch.Tensor,
              do: torch.Tensor, delta: torch.Tensor, scale: float):
    """K4a; same contract as flash_bwd_plain. dq is summed over key tiles
    with fp32 atomics, so its last bits vary from run to run."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, mask, lse, do, delta, scale)
    q, k, v, do, lse, delta = _bwd_operands("flash_bwd", q, k, v, mask, lse, do, delta)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    lib = cuda.load()
    with torch.cuda.device(q.device):
        err = lib.maa3_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(mask), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b * h, h, lq, lk, d, ctypes.c_float(scale * LOG2E),
            ctypes.c_float(scale), cuda.DTYPE_CODES[q.dtype], cuda.stream_ptr(q))
    cuda.check(err, "flash_bwd")
    launches["K4a"] += 1
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dkv(q, k, v, mask: Optional[torch.Tensor], lse: torch.Tensor,
                  do: torch.Tensor, delta: torch.Tensor, scale: float):
    """K4b; same contract as flash_bwd_dkv_plain."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, mask, lse, do, delta, scale)
    q, k, v, do, lse, delta = _bwd_operands("flash_bwd_dkv", q, k, v, mask, lse, do,
                                            delta)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = cuda.load()
    with torch.cuda.device(q.device):
        err = lib.maa3_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(mask), dk.data_ptr(), dv.data_ptr(), b * h, h,
            lq, lk, d, ctypes.c_float(scale * LOG2E), cuda.DTYPE_CODES[q.dtype],
            cuda.stream_ptr(q))
    cuda.check(err, "flash_bwd_dkv")
    launches["K4b"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, mask: Optional[torch.Tensor], lse: torch.Tensor,
                 do: torch.Tensor, delta: torch.Tensor, scale: float):
    """K4c; same contract as flash_bwd_dq_plain. Each block owns its dq rows
    (no atomics), so dq is the same bits on every run."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, mask, lse, do, delta, scale)
    q, k, v, do, lse, delta = _bwd_operands("flash_bwd_dq", q, k, v, mask, lse, do,
                                            delta)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dq = torch.empty_like(q)
    lib = cuda.load()
    with torch.cuda.device(q.device):
        err = lib.maa3_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(mask), dq.data_ptr(), b * h, h, lq, lk, d,
            ctypes.c_float(scale * LOG2E), ctypes.c_float(scale),
            cuda.DTYPE_CODES[q.dtype], cuda.stream_ptr(q))
    cuda.check(err, "flash_bwd_dq")
    launches["K4c"] += 1
    return dq


def bwd_mode() -> str:
    """MAA3_FLASH_BWD (auto | fused | split), read at every backward call."""
    mode = os.environ.get("MAA3_FLASH_BWD", "auto")
    if mode not in BWD_MODES:
        raise ValueError(f"MAA3_FLASH_BWD={mode!r}: expected one of {BWD_MODES}")
    return mode


# ---------------------------------------------------------------------------
# Public entry + autograd
# ---------------------------------------------------------------------------

class _FlashCore(torch.autograd.Function):
    """The custom VJP of maa3_tpu/ops/flash_attention.py:368-395."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, route):
        o, lse = flash_fwd(q, k, v, mask, scale, route)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * o.float()).sum(-1)
        if bwd_mode() == "split":
            dk, dv = flash_bwd_dkv(q, k, v, mask, lse, do, delta, ctx.scale)
            dq = flash_bwd_dq(q, k, v, mask, lse, do, delta, ctx.scale)
        else:  # auto and fused: K4a at every length (module docstring)
            dq, dk, dv = flash_bwd(q, k, v, mask, lse, do, delta, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """q (B, H, Lq, D), k/v (B, H, Lk, D), mask (B, Lk) True = valid.
    Returns (B, H, Lq, D). block_q and block_k keep the JAX signature: a
    block_k selects the online route; tile sizes are the kernels' own."""
    del block_q
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[3])
    m = None if mask is None else mask.to(device=q.device, dtype=torch.int32).contiguous()
    return _FlashCore.apply(q.contiguous(), k.contiguous(), v.contiguous(), m,
                            scale, route_for(k.shape[2], block_k))

"""K1: fused anti-aliased snake activation for BigVGAN (the counterpart of
maa3_tpu/ops/pallas_aa_snake.py, whose name it keeps; the kernel is CUDA
C++, csrc/aa_snake.cu).

`aa_snake_fused` computes Activation1d(snake / snake-beta) over (B, C, T):
2x kaiser-sinc upsample -> snake in fp32 -> 2x kaiser-sinc decimation, with
the replicate-pad edge rules of FusedActivation1d, returning x's dtype. On a
CUDA tensor it launches the kernel (or raises); on a CPU tensor it runs
`aa_snake_plain`, the same function in plain PyTorch. The kernel has no
backward (nor has JAX's): on a CUDA tensor under grad mode, with x or a
parameter that requires grad, the wrapper raises instead of returning a
result cut off from the graph; training takes the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from maa3_tpu_torch import cuda
from maa3_tpu_torch.ops.resample import FusedActivation1d, sin2_poly, use_fast_sin2

launches = 0  # kernel launches by aa_snake_fused (chip_smoke resets and reads)


def snake_coeffs(alpha: torch.Tensor, beta: Optional[torch.Tensor],
                 logscale: bool, has_beta: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Effective fp32 (alpha, 1 / (beta + 1e-9)); snake divides by alpha."""
    af = torch.exp(alpha.float()) if logscale else alpha.float()
    bf = af
    if has_beta:
        bf = torch.exp(beta.float()) if logscale else beta.float()
    return af, 1.0 / (bf + 1e-9)


def aa_snake_plain(x: torch.Tensor, alpha: torch.Tensor,
                   beta: Optional[torch.Tensor] = None, *, logscale: bool = True,
                   has_beta: bool = True,
                   fast_sin2: Optional[bool] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (FusedActivation1d + snake)."""
    if fast_sin2 is None:
        fast_sin2 = use_fast_sin2(x.dtype)
    a, ib = snake_coeffs(alpha, beta, logscale, has_beta)
    a, ib = a[None, :, None], ib[None, :, None]

    def act(v):
        u = a * v
        s2 = sin2_poly(u) if fast_sin2 else torch.sin(u).square()
        return v + ib * s2

    return FusedActivation1d(act)(x).to(x.dtype)


def refuse_autograd(what: str, *tensors) -> None:
    """Raise where a kernel without a backward would drop gradients: grad
    mode on and any of `tensors` (None allowed) requiring grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward; take the differentiable "
            f"route (bigvgan_apply(..., kernels=False), aa_snake_plain / "
            f"conv_snake_plain) or call it under torch.no_grad()")


def _params(alpha, beta, has_beta, device):
    a = alpha.to(device, torch.float32).contiguous()
    b = beta.to(device, torch.float32).contiguous() if has_beta else a
    return a, b


def aa_snake_fused(x: torch.Tensor, alpha: torch.Tensor,
                   beta: Optional[torch.Tensor] = None, *, logscale: bool = True,
                   has_beta: bool = True,
                   fast_sin2: Optional[bool] = None) -> torch.Tensor:
    """Activation1d(snake[_beta])(x) for x (B, C, T) in fp32 or bf16."""
    global launches
    if fast_sin2 is None:
        fast_sin2 = use_fast_sin2(x.dtype)
    if x.device.type == "cpu":
        return aa_snake_plain(x, alpha, beta, logscale=logscale,
                              has_beta=has_beta, fast_sin2=fast_sin2)
    if x.device.type != "cuda":
        raise ValueError(f"aa_snake_fused: unsupported device {x.device}")
    refuse_autograd("aa_snake_fused", x, alpha, beta if has_beta else None)
    if x.dim() != 3 or x.dtype not in cuda.DTYPE_CODES:
        raise ValueError(f"aa_snake_fused: need (B, C, T) fp32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if has_beta and beta is None:
        raise ValueError("aa_snake_fused: has_beta needs beta")
    B, C, T = x.shape
    if alpha.numel() != C or (has_beta and beta.numel() != C):
        raise ValueError("aa_snake_fused: alpha/beta must have C entries")
    if B * C >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError(f"aa_snake_fused: B * C and T must be below 2^31, got "
                         f"{tuple(x.shape)}")
    if x.numel() == 0:
        return torch.empty_like(x)
    x = x.contiguous()
    a, b = _params(alpha, beta, has_beta, x.device)
    y = torch.empty_like(x)
    lib = cuda.load()
    # launched on x's device and current stream; the caching allocator keeps
    # the temporaries above alive for work queued on that stream
    with torch.cuda.device(x.device):
        err = lib.maa3_aa_snake(x.data_ptr(), y.data_ptr(), a.data_ptr(),
                                b.data_ptr(), B * C, C, T,
                                cuda.DTYPE_CODES[x.dtype], int(has_beta),
                                int(logscale), int(bool(fast_sin2)),
                                cuda.stream_ptr(x))
    cuda.check(err, "aa_snake_fused")
    launches += 1
    return y

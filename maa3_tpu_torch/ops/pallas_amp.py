"""K2: fused [anti-aliased snake -> dilated Conv1d + bias] for the narrow
BigVGAN stages (the counterpart of maa3_tpu/ops/pallas_amp.py, whose name it
keeps; the kernel is CUDA C++, csrc/conv_snake.cu). In bf16 the conv runs on
the tensor cores (mma.sync) and takes C_in, C_out <= 64; fp32 runs an FMA
loop (the tensor cores would take fp32 only as TF32).

`conv_snake_fused(x, ...)` equals
conv1d(aa_snake(x), w, b, padding=(k*d - d)//2, dilation=d) with the
activation output stored in x's dtype and the conv in x's dtype (fp32
accumulation). On a CUDA tensor it launches the kernel (or raises; also
under grad mode when x or a parameter requires grad, as the kernel has no
backward); on a CPU tensor it runs `conv_snake_plain`, the same function in
plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from maa3_tpu_torch import cuda
from maa3_tpu_torch.ops.conv import conv1d
from maa3_tpu_torch.ops.pallas_aa_snake import _params, aa_snake_plain, refuse_autograd
from maa3_tpu_torch.ops.resample import use_fast_sin2

launches = 0  # kernel launches by conv_snake_fused (chip_smoke resets and reads)

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def conv_snake_plain(x: torch.Tensor, alpha: torch.Tensor,
                     beta: Optional[torch.Tensor], w: torch.Tensor,
                     b: torch.Tensor, *, k: int, dilation: int = 1,
                     logscale: bool = True, has_beta: bool = True,
                     fast_sin2: Optional[bool] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    act = aa_snake_plain(x, alpha, beta, logscale=logscale, has_beta=has_beta,
                         fast_sin2=fast_sin2)
    return conv1d(act, w, b, padding=(k * dilation - dilation) // 2,
                  dilation=dilation, compute_dtype=x.dtype)


def conv_snake_fused(x: torch.Tensor, alpha: torch.Tensor,
                     beta: Optional[torch.Tensor], w: torch.Tensor,
                     b: torch.Tensor, *, k: int, dilation: int = 1,
                     logscale: bool = True, has_beta: bool = True,
                     fast_sin2: Optional[bool] = None) -> torch.Tensor:
    """x (B, C_in, T) fp32/bf16; w (C_out, C_in, k); b (C_out,)."""
    global launches
    if fast_sin2 is None:
        fast_sin2 = use_fast_sin2(x.dtype)
    if x.device.type == "cpu":
        return conv_snake_plain(x, alpha, beta, w, b, k=k, dilation=dilation,
                                logscale=logscale, has_beta=has_beta,
                                fast_sin2=fast_sin2)
    if x.device.type != "cuda":
        raise ValueError(f"conv_snake_fused: unsupported device {x.device}")
    refuse_autograd("conv_snake_fused", x, alpha, beta if has_beta else None, w, b)
    if x.dim() != 3 or x.dtype not in cuda.DTYPE_CODES:
        raise ValueError(f"conv_snake_fused: need (B, C, T) fp32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, C, T = x.shape
    c_out = w.shape[0]
    if tuple(w.shape) != (c_out, C, k) or k % 2 == 0 or b.numel() != c_out:
        raise ValueError(f"conv_snake_fused: weight {tuple(w.shape)} / bias "
                         f"{tuple(b.shape)} do not fit C_in={C}, odd k={k}")
    if has_beta and beta is None:
        raise ValueError("conv_snake_fused: has_beta needs beta")
    if B > 65535:
        raise ValueError(f"conv_snake_fused: batch {B} exceeds the grid limit")
    lib = cuda.load()
    smem = lib.maa3_conv_snake_smem(C, c_out, k, dilation, cuda.DTYPE_CODES[x.dtype])
    if smem < 0:
        raise ValueError(f"conv_snake_fused: the bf16 kernel takes C_in and C_out "
                         f"<= 64, got C_in={C}, C_out={c_out}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"conv_snake_fused: C_in={C}, k={k}, d={dilation} "
                         f"needs {smem} bytes of shared memory")
    x = x.contiguous()
    a, bt = _params(alpha, beta, has_beta, x.device)
    wf = w.to(x.device, torch.float32).contiguous()
    bf = b.to(x.device, torch.float32).contiguous()
    y = torch.empty((B, c_out, T), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):  # see aa_snake_fused
        err = lib.maa3_conv_snake(x.data_ptr(), y.data_ptr(), a.data_ptr(),
                                  bt.data_ptr(), wf.data_ptr(), bf.data_ptr(), B,
                                  C, c_out, T, k, dilation,
                                  cuda.DTYPE_CODES[x.dtype], int(has_beta),
                                  int(logscale), int(bool(fast_sin2)),
                                  cuda.stream_ptr(x))
    cuda.check(err, "conv_snake_fused")
    launches += 1
    return y

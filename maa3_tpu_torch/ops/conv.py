"""1-D convolutions in NCL layout (counterpart of maa3_tpu/ops/conv.py).

Plain conv products stay on PyTorch's F.conv1d, as the JAX package left
them to XLA. Weights use torch layouts: Conv1d (out, in, k),
ConvTranspose1d (in, out, k).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _cast(x, w, b, compute_dtype):
    dt = compute_dtype or torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt), None if b is None else b.to(dt)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding=0, dilation: int = 1,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (B, C, T); padding: int (symmetric) or (lo, hi)."""
    x, w, b = _cast(x, w, b, compute_dtype)
    if not isinstance(padding, int):
        x = F.pad(x, tuple(padding))
        padding = 0
    return F.conv1d(x, w, b, stride=stride, padding=padding, dilation=dilation)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor], stride: int, padding: int = 0,
                     groups: int = 1,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """torch ConvTranspose1d: out length (T-1)*stride - 2*pad + k."""
    x, w, b = _cast(x, w, b, compute_dtype)
    return F.conv_transpose1d(x, w, b, stride=stride, padding=padding,
                              groups=groups)


def conv_transpose1d_polyphase(x: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor], stride: int,
                               padding: int = 0,
                               compute_dtype: Optional[torch.dtype] = None
                               ) -> torch.Tensor:
    """ConvTranspose1d as one kernel-3 conv to (stride * out) channels plus
    an interleave (k <= 3 * stride and k - 2 * pad == stride, as in every
    BigVGAN stage): y[u*m + r] = sum_d x[m + d] W[:, :, r + pad + u - u*d]."""
    x, w, b = _cast(x, w, b, compute_dtype)
    cin, cout, k = w.shape
    u = stride
    if not (k <= 3 * u and k - 2 * padding == u):
        raise ValueError(f"polyphase lowering needs k<=3u and k-2p==u, got "
                         f"k={k} u={u} p={padding}")
    bsz, _, t = x.shape
    kappa = (padding + u + torch.arange(u)[:, None]
             - u * torch.arange(3)[None, :])                    # (u, 3)
    valid = (kappa >= 0) & (kappa < k)
    w_ext = torch.cat([w, w.new_zeros(cin, cout, 1)], dim=-1)    # slot k -> 0
    gath = w_ext[:, :, torch.where(valid, kappa, k).to(w.device)]  # (in, out, u, 3)
    w3 = gath.permute(2, 1, 0, 3).reshape(u * cout, cin, 3)
    y = F.conv1d(F.pad(x, (1, 1)), w3)                           # (B, u*out, T)
    y = y.reshape(bsz, u, cout, t).permute(0, 2, 3, 1).reshape(bsz, cout, u * t)
    if b is not None:
        y = y + b[None, :, None]
    return y


# -- int8 (w8a8) convolutions: serving only, no gradient -------------------------

class QuantConv1d(torch.nn.Module):
    """A stride-1 conv site quantized by quantize_conv_int8: w_q (C_out,
    k * C_in) int8 in the tap-major GEMM layout (column j * C_in + c holds
    tap j, input channel c), w_scale (C_out,) fp32, the float bias; `taps`
    holds each tap's (C_out, C_in) codes contiguous for the tap-GEMMs."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor], k: int):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("bias", bias)
        self.k = k
        c_out, c_in = w_q.shape[0], w_q.shape[1] // k
        self.register_buffer("taps", w_q.reshape(c_out, k, c_in).transpose(0, 1)
                             .contiguous(), persistent=False)


@torch.no_grad()
def quantize_conv_int8(w: torch.Tensor, b: Optional[torch.Tensor]) -> QuantConv1d:
    """Per-output-channel symmetric int8 of a (C_out, C_in, k) conv weight in
    the tap-major (C_out, k * C_in) layout, scales from the fp32 weight
    (maa3_tpu/ops/conv.py:91)."""
    from maa3_tpu_torch.ops.quant import _quantize_rows
    wf = w.detach().float()
    o, i, k = wf.shape
    w_q, scale = _quantize_rows(wf.permute(0, 2, 1).reshape(o, k * i))
    return QuantConv1d(w_q, scale, None if b is None else b.detach().clone(), k)


def _pad_time(x: torch.Tensor, padding):
    if isinstance(padding, int):
        padding = (padding, padding)
    return F.pad(x.float(), tuple(padding))


def _finish(y: torch.Tensor, q: QuantConv1d, dtype) -> torch.Tensor:
    """(B, T, C_out) fp32 sums (already times the activation scales) ->
    times w_scale, plus the bias, as (B, C_out, T) in `dtype`."""
    y = y * q.w_scale.float()
    if q.bias is not None:
        y = y + q.bias.float()
    return y.transpose(1, 2).to(dtype)


def conv1d_unfold_w8a8(q: QuantConv1d, x: torch.Tensor, padding=0,
                       dilation: int = 1) -> torch.Tensor:
    """The unfold-GEMM conv in int8 (maa3_tpu/ops/conv.py:113): the (B, T,
    k * C_in) im2col rows quantized with one scale per (batch, t) window, one
    int8 product against w_q, dequantized by the window's and the output
    channel's scales. Output in x's dtype."""
    from maa3_tpu_torch.ops.quant import int8_matmul, quantize_activations
    bsz, c_in, _ = x.shape
    xp = _pad_time(x, padding)
    t_out = xp.shape[-1] - (q.k - 1) * dilation
    cols = torch.cat([xp[:, :, j * dilation:j * dilation + t_out]
                      for j in range(q.k)], dim=1)        # (B, k*C_in, T)
    cols_q, sx = quantize_activations(cols.transpose(1, 2))  # (B, T, kC), (B, T, 1)
    acc = int8_matmul(cols_q.reshape(bsz * t_out, -1), q.w_q.t())
    y = acc.float().reshape(bsz, t_out, -1) * sx
    return _finish(y, q, x.dtype)


def conv1d_tapgemm_w8a8(q: QuantConv1d, x: torch.Tensor, padding=0,
                        dilation: int = 1) -> torch.Tensor:
    """The int8 conv as k shifted tap-GEMMs, the wide-channel lowering
    (maa3_tpu/ops/conv.py:148): x quantized once per (batch, t) column, each
    tap's int8 product dequantized by its own shifted slice of the column
    scales, the taps summed in order. Output in x's dtype."""
    from maa3_tpu_torch.ops.quant import int8_matmul, quantize_activations
    bsz = x.shape[0]
    xp = _pad_time(x, padding)
    t_out = xp.shape[-1] - (q.k - 1) * dilation
    x_q, sx = quantize_activations(xp.transpose(1, 2))     # (B, Tp, C), (B, Tp, 1)
    y = None
    for j in range(q.k):
        xs = x_q[:, j * dilation:j * dilation + t_out].reshape(bsz * t_out, -1)
        acc = int8_matmul(xs, q.taps[j].t()).float().reshape(bsz, t_out, -1)
        part = acc * sx[:, j * dilation:j * dilation + t_out]
        y = part if y is None else y + part
    return _finish(y, q, x.dtype)

"""What every reference model shares: exact fp32 arithmetic, the norms and
activations written out in plain PyTorch, and the fp8 rounding that the
controls of `correct` compute in.

Nothing here imports the program under test: the reference reads state
dicts by the upstream key names and recomputes every derived tensor itself.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


@contextlib.contextmanager
def exact_fp32():
    """fp32 matmuls and convolutions without TF32."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8_e4m3fn with one scale per tensor, in t's dtype; the
    rounding passes the gradient straight through. The precision below bf16,
    which the controls of `correct` compute in (benchmark/control.py)."""
    d = t.detach()
    s = d.abs().amax().clamp_min(1e-30) / FP8_MAX
    r = (d / s).to(torch.float8_e4m3fn).to(d.dtype) * s
    return t + (r - d)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w=None, b=None, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def silu(x):
    return x * torch.sigmoid(x)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def attention(q, k, v, scale, mask=None, bias=None):
    """Softmax attention on (B, H, L, D); mask (B, Lk) bool, True = valid;
    bias broadcast onto the (B, H, Lq, Lk) logits."""
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
    return torch.matmul(torch.softmax(logits, dim=-1), v)

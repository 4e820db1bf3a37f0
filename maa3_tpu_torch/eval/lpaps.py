"""LPAPS, learned perceptual audio patch similarity over VGGishish features
(counterpart of maa3_tpu/eval/lpaps.py; ldm/modules/losses_audio/lpaps.py:
17-142):

  (inp - shift) / scale             per-frequency ScalingLayer
  VGGishish16 (no BN)               5 taps relu1_2 .. relu5_3
  x / (||x||_C + eps)               eps outside the square root
  lin_k: 1x1 conv C_k -> 1          NetLinLayer, no bias
  sum_k spatial_mean(lin_k(diff^2))

Keys are the reference's: scaling_layer.{shift, scale} (1, 1, F, 1),
net.slice{s}.{i} (the conv at index i of the VGGishish16 features, slice s
holding indices [0, 4), [4, 9), [9, 16), [16, 23), [23, 30)) and
lin{k}.model.1.weight (1, C_k, 1, 1).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from maa3_tpu_torch.models.melclf import (DEFAULT_CONV_LAYERS, conv_stack,
                                          melclf_features, vgg_conv_init_)

LPAPS_CHNS = (64, 128, 256, 512, 512)
SLICE_BOUNDS = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))


def _normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)


class LPAPS(nn.Module):
    def __init__(self, n_mels: int = 80):
        super().__init__()
        self.scaling_layer = nn.Module()
        self.scaling_layer.register_buffer("shift", torch.zeros(1, 1, n_mels, 1))
        self.scaling_layer.register_buffer("scale", torch.ones(1, 1, n_mels, 1))
        self.net = nn.Module()
        layers = conv_stack(DEFAULT_CONV_LAYERS)
        for s, (lo, hi) in enumerate(SLICE_BOUNDS, 1):
            sl = nn.Sequential()
            for i in range(lo, hi):
                sl.add_module(str(i), layers[i])
            setattr(self.net, f"slice{s}", sl)
        for k, c in enumerate(LPAPS_CHNS):
            lin = nn.Module()
            lin.model = nn.Sequential(nn.Dropout(), nn.Conv2d(c, 1, 1, bias=False))
            setattr(self, f"lin{k}", lin)


@torch.no_grad()
def lpaps_init_(m: LPAPS, generator: torch.Generator) -> LPAPS:
    """As lpaps_init (maa3_tpu/eval/lpaps.py:66): the convs kaiming normal
    (fan_out), identity scaling, each lin the uniform average 1 / C."""
    vgg_conv_init_(m.net, generator)
    m.scaling_layer.shift.zero_()
    m.scaling_layer.scale.fill_(1.0)
    for k, c in enumerate(LPAPS_CHNS):
        getattr(m, f"lin{k}").model[1].weight.fill_(1.0 / c)
    return m


def lpaps_features(m: LPAPS, x: torch.Tensor) -> List[torch.Tensor]:
    """The five slice outputs of a (B, 1, F, T) input."""
    taps = []
    for s in range(1, 6):
        x = getattr(m.net, f"slice{s}")(x)
        taps.append(x)
    return taps


def lpaps_apply(m: LPAPS, mel_a: torch.Tensor, mel_b: torch.Tensor) -> torch.Tensor:
    """LPAPS.forward over two (B, n_mels, T) mels -> (B,)
    (maa3_tpu/eval/lpaps.py:93)."""
    shift, scale = m.scaling_layer.shift[0], m.scaling_layer.scale[0]  # (1, F, 1)
    fa = lpaps_features(m, ((mel_a.float() - shift) / scale)[:, None])
    fb = lpaps_features(m, ((mel_b.float() - shift) / scale)[:, None])
    total = 0.0
    for k, (xa, xb) in enumerate(zip(fa, fb)):
        d = (_normalize(xa) - _normalize(xb)) ** 2               # (B, C, H, W)
        w = getattr(m, f"lin{k}").model[1].weight.reshape(-1)
        total = total + torch.einsum("bchw,c->bhw", d, w).mean(dim=(1, 2))
    return total


def lpaps_distance(features: nn.Module, mel_a: torch.Tensor, mel_b: torch.Tensor,
                   layer_weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """sum_l w_l mean(||norm(f_l(a)) - norm(f_l(b))||^2) over the taps of any
    classifier's conv stack (a MelClf's `features`, trained or not)
    (maa3_tpu/eval/lpaps.py:115)."""
    fa = melclf_features(features, mel_a)
    fb = melclf_features(features, mel_b)
    if layer_weights is None:
        layer_weights = [1.0] * len(fa)
    total = 0.0
    for w, a, b in zip(layer_weights, fa, fb):
        total = total + w * ((_normalize(a) - _normalize(b)) ** 2).mean(dim=(1, 2, 3))
    return total

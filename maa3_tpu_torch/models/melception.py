"""Melception, the Inception3-for-mel FD backbone (counterpart of
maa3_tpu/models/melception.py; vggishish/train_melception.py:20-34).

torchvision's Inception3 with a 1-channel stem and both stem max-pools
removed (the mel is 80 high). Module names are torchvision's
(Conv2d_1a_3x3.conv / .bn, Mixed_5b.branch1x1, ..., AuxLogits, fc), so a
torchvision-trained melception state dict loads key for key. Every conv is
a BasicConv2d: Conv2d without bias, BatchNorm2d eps 1e-3 (running
statistics when the model holds them, else the batch's, as in JAX), ReLU.
The FD feature is the 2048-d global average before `fc`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from maa3_tpu_torch.models.bert import _ns
from maa3_tpu_torch.ops.basic import BatchNorm2d


@dataclasses.dataclass(frozen=True)
class MelceptionConfig:
    num_classes: int = 309       # VGGSound
    aux_logits: bool = True


class BasicConv2d(nn.Module):
    def __init__(self, c_in: int, c_out: int, kh: int, kw: int, running_stats: bool,
                 stddev: float = 0.1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, (kh, kw), bias=False)
        self.bn = BatchNorm2d(c_out, 1e-3, running_stats)
        self.stddev = stddev  # the init's truncated-normal scale


def _blocks(rs: bool) -> dict:
    def bc(ci, co, kh, kw, stddev=0.1):
        return BasicConv2d(ci, co, kh, kw, rs, stddev)

    def inception_a(ci, pool):
        return _ns(branch1x1=bc(ci, 64, 1, 1), branch5x5_1=bc(ci, 48, 1, 1),
                   branch5x5_2=bc(48, 64, 5, 5), branch3x3dbl_1=bc(ci, 64, 1, 1),
                   branch3x3dbl_2=bc(64, 96, 3, 3), branch3x3dbl_3=bc(96, 96, 3, 3),
                   branch_pool=bc(ci, pool, 1, 1))

    def inception_b(ci):
        return _ns(branch3x3=bc(ci, 384, 3, 3), branch3x3dbl_1=bc(ci, 64, 1, 1),
                   branch3x3dbl_2=bc(64, 96, 3, 3), branch3x3dbl_3=bc(96, 96, 3, 3))

    def inception_c(ci, c7):
        return _ns(branch1x1=bc(ci, 192, 1, 1), branch7x7_1=bc(ci, c7, 1, 1),
                   branch7x7_2=bc(c7, c7, 1, 7), branch7x7_3=bc(c7, 192, 7, 1),
                   branch7x7dbl_1=bc(ci, c7, 1, 1), branch7x7dbl_2=bc(c7, c7, 7, 1),
                   branch7x7dbl_3=bc(c7, c7, 1, 7), branch7x7dbl_4=bc(c7, c7, 7, 1),
                   branch7x7dbl_5=bc(c7, 192, 1, 7), branch_pool=bc(ci, 192, 1, 1))

    def inception_d(ci):
        return _ns(branch3x3_1=bc(ci, 192, 1, 1), branch3x3_2=bc(192, 320, 3, 3),
                   branch7x7x3_1=bc(ci, 192, 1, 1), branch7x7x3_2=bc(192, 192, 1, 7),
                   branch7x7x3_3=bc(192, 192, 7, 1), branch7x7x3_4=bc(192, 192, 3, 3))

    def inception_e(ci):
        return _ns(branch1x1=bc(ci, 320, 1, 1), branch3x3_1=bc(ci, 384, 1, 1),
                   branch3x3_2a=bc(384, 384, 1, 3), branch3x3_2b=bc(384, 384, 3, 1),
                   branch3x3dbl_1=bc(ci, 448, 1, 1), branch3x3dbl_2=bc(448, 384, 3, 3),
                   branch3x3dbl_3a=bc(384, 384, 1, 3), branch3x3dbl_3b=bc(384, 384, 3, 1),
                   branch_pool=bc(ci, 192, 1, 1))

    return dict(
        Conv2d_1a_3x3=bc(1, 32, 3, 3), Conv2d_2a_3x3=bc(32, 32, 3, 3),
        Conv2d_2b_3x3=bc(32, 64, 3, 3), Conv2d_3b_1x1=bc(64, 80, 1, 1),
        Conv2d_4a_3x3=bc(80, 192, 3, 3),
        Mixed_5b=inception_a(192, 32), Mixed_5c=inception_a(256, 64),
        Mixed_5d=inception_a(288, 64), Mixed_6a=inception_b(288),
        Mixed_6b=inception_c(768, 128), Mixed_6c=inception_c(768, 160),
        Mixed_6d=inception_c(768, 160), Mixed_6e=inception_c(768, 192),
        Mixed_7a=inception_d(768), Mixed_7b=inception_e(1280), Mixed_7c=inception_e(2048))


class Melception(nn.Module):
    def __init__(self, cfg: MelceptionConfig = MelceptionConfig(),
                 running_stats: bool = False):
        super().__init__()
        self.cfg = cfg
        for name, m in _blocks(running_stats).items():
            setattr(self, name, m)
        if cfg.aux_logits:
            self.AuxLogits = nn.Module()
            self.AuxLogits.conv0 = BasicConv2d(768, 128, 1, 1, running_stats)
            self.AuxLogits.conv1 = BasicConv2d(128, 768, 5, 5, running_stats, 0.01)
            self.AuxLogits.fc = nn.Linear(768, cfg.num_classes)
        self.fc = nn.Linear(2048, cfg.num_classes)


def _trunc_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """N(0, 1) truncated to 2 sigma by redrawing, times std (torchvision's
    inception init, as maa3_tpu/models/melception.py:55 draws it)."""
    x = torch.randn(shape, generator=generator)
    bad = x.abs() > 2.0
    while bad.any():
        x[bad] = torch.randn(int(bad.sum()), generator=generator)
        bad = x.abs() > 2.0
    return x * std


@torch.no_grad()
def melception_init_(m: Melception, generator: torch.Generator) -> Melception:
    """Random init as melception_init: conv weights truncated normal 0.1
    (AuxLogits.conv1 0.01), fc 0.1 and the aux fc 0.001 with zero bias,
    unit BN."""
    for mod in m.modules():
        if isinstance(mod, BasicConv2d):
            mod.conv.weight.copy_(_trunc_normal(mod.conv.weight.shape, mod.stddev,
                                                generator))
    fcs = [(m.fc, 0.1)] + ([(m.AuxLogits.fc, 0.001)] if m.cfg.aux_logits else [])
    for fc, std in fcs:
        fc.weight.copy_(_trunc_normal(fc.weight.shape, std, generator))
        fc.bias.zero_()
    return m


def _bc(p: BasicConv2d, x, stride=1, padding=(0, 0)):
    return F.relu(p.bn(F.conv2d(x, p.conv.weight, None, stride, padding)))


def _avg_pool3(x):
    """F.avg_pool2d(x, 3, 1, 1): count_include_pad divides by 9 everywhere,
    as JAX's _avg_pool3 does."""
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _inception_a(p, x):
    b1 = _bc(p.branch1x1, x)
    b5 = _bc(p.branch5x5_2, _bc(p.branch5x5_1, x), padding=(2, 2))
    b3 = _bc(p.branch3x3dbl_1, x)
    b3 = _bc(p.branch3x3dbl_2, b3, padding=(1, 1))
    b3 = _bc(p.branch3x3dbl_3, b3, padding=(1, 1))
    bp = _bc(p.branch_pool, _avg_pool3(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p, x):
    b3 = _bc(p.branch3x3, x, stride=2)
    bd = _bc(p.branch3x3dbl_1, x)
    bd = _bc(p.branch3x3dbl_2, bd, padding=(1, 1))
    bd = _bc(p.branch3x3dbl_3, bd, stride=2)
    return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)


def _inception_c(p, x):
    b1 = _bc(p.branch1x1, x)
    b7 = _bc(p.branch7x7_1, x)
    b7 = _bc(p.branch7x7_2, b7, padding=(0, 3))
    b7 = _bc(p.branch7x7_3, b7, padding=(3, 0))
    bd = _bc(p.branch7x7dbl_1, x)
    bd = _bc(p.branch7x7dbl_2, bd, padding=(3, 0))
    bd = _bc(p.branch7x7dbl_3, bd, padding=(0, 3))
    bd = _bc(p.branch7x7dbl_4, bd, padding=(3, 0))
    bd = _bc(p.branch7x7dbl_5, bd, padding=(0, 3))
    bp = _bc(p.branch_pool, _avg_pool3(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p, x):
    b3 = _bc(p.branch3x3_2, _bc(p.branch3x3_1, x), stride=2)
    b7 = _bc(p.branch7x7x3_1, x)
    b7 = _bc(p.branch7x7x3_2, b7, padding=(0, 3))
    b7 = _bc(p.branch7x7x3_3, b7, padding=(3, 0))
    b7 = _bc(p.branch7x7x3_4, b7, stride=2)
    return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


def _inception_e(p, x):
    b1 = _bc(p.branch1x1, x)
    b3 = _bc(p.branch3x3_1, x)
    b3 = torch.cat([_bc(p.branch3x3_2a, b3, padding=(0, 1)),
                    _bc(p.branch3x3_2b, b3, padding=(1, 0))], dim=1)
    bd = _bc(p.branch3x3dbl_1, x)
    bd = _bc(p.branch3x3dbl_2, bd, padding=(1, 1))
    bd = torch.cat([_bc(p.branch3x3dbl_3a, bd, padding=(0, 1)),
                    _bc(p.branch3x3dbl_3b, bd, padding=(1, 0))], dim=1)
    bp = _bc(p.branch_pool, _avg_pool3(x))
    return torch.cat([b1, b3, bd, bp], dim=1)


def _aux(p, x):
    s = F.avg_pool2d(x, 5, stride=3)
    s = _bc(p.conv1, _bc(p.conv0, s))
    return p.fc(s.mean(dim=(2, 3)))


def melception_apply(m: Melception, mel: torch.Tensor, return_features: bool = False,
                     return_aux: bool = False):
    """mel (B, 80, T) -> logits (B, num_classes); return_features adds the
    2048-d pooled embedding, return_aux the InceptionAux logits (None
    without the head) (maa3_tpu/models/melception.py:269)."""
    x = mel[:, None].float()
    x = _bc(m.Conv2d_1a_3x3, x, stride=2)
    x = _bc(m.Conv2d_2a_3x3, x)
    x = _bc(m.Conv2d_2b_3x3, x, padding=(1, 1))
    x = _bc(m.Conv2d_3b_1x1, x)       # maxpool1 removed
    x = _bc(m.Conv2d_4a_3x3, x)       # maxpool2 removed
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _inception_a(getattr(m, name), x)
    x = _inception_b(m.Mixed_6a, x)
    for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _inception_c(getattr(m, name), x)
    aux = _aux(m.AuxLogits, x) if return_aux and m.cfg.aux_logits else None
    x = _inception_d(m.Mixed_7a, x)
    x = _inception_e(m.Mixed_7b, x)
    x = _inception_e(m.Mixed_7c, x)
    feats = x.mean(dim=(2, 3))
    out = (m.fc(feats),)
    if return_features:
        out = out + (feats,)
    if return_aux:
        out = out + (aux,)
    return out[0] if len(out) == 1 else out

"""The mel classifiers behind the FD / KL metrics and their CLIs
(cal_fd_score, train_melclf, predict_melclf): the VGGishish (models/melclf)
or the Melception (models/melception) by name, built at random or from a
file, with one forward for evaluation and one for training.

Files: a reference state dict (.pt / .pth / .ckpt, optionally under
`model` or `state_dict`; running BN statistics used when present) or a
file of train_melclf ({"model", "backbone", "conv_layers",
"num_classes", "classes"}; no running statistics, so evaluated with batch
statistics as JAX evaluates its own trained classifiers). A JAX CLI's
Orbax directory exits with a message naming orbax_to_torch.py, which
converts it to a train_melclf file where JAX is installed.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from maa3_tpu_torch.models.melception import (Melception, MelceptionConfig,
                                              melception_apply, melception_init_)
from maa3_tpu_torch.models.melclf import (DEFAULT_CONV_LAYERS, SMALL_CONV_LAYERS,
                                          MelClf, MelClfConfig, melclf_apply, melclf_init_)


def new_classifier(backbone: str, num_classes: int, small: bool = False,
                   conv_layers=None, generator: Optional[torch.Generator] = None) -> nn.Module:
    """A random classifier (batch-statistics BN) drawn from `generator`
    (seed 0 when None); `small` is the VGGishish's --small stack."""
    generator = generator or torch.Generator().manual_seed(0)
    if backbone == "melception":
        return melception_init_(Melception(MelceptionConfig(num_classes=num_classes)),
                                generator)
    if conv_layers is None:
        conv_layers = SMALL_CONV_LAYERS if small else DEFAULT_CONV_LAYERS
    cfg = MelClfConfig(conv_layers=tuple(conv_layers), num_classes=num_classes)
    return melclf_init_(MelClf(cfg), generator)


def load_classifier(path: str, backbone: str, num_classes: int,
                    small: bool = False) -> nn.Module:
    """The classifier of a train_melclf file or a reference state dict;
    num_classes and small shape a reference VGGishish (a train_melclf file
    carries its own)."""
    from maa3_tpu_torch.torch_import import (OrbaxDirectory, load_module_state,
                                             melception_from_torch, melclf_from_torch,
                                             read_checkpoint, unwrap_state_dict)
    try:
        ckpt = read_checkpoint(path)
    except OrbaxDirectory as e:
        raise SystemExit(str(e)) from None
    if isinstance(ckpt, dict) and "backbone" in ckpt:
        if ckpt["backbone"] != backbone:
            raise ValueError(f"{path} holds a {ckpt['backbone']} classifier, "
                             f"not a {backbone}")
        m = new_classifier(backbone, ckpt["num_classes"], conv_layers=ckpt["conv_layers"])
        load_module_state(m, ckpt["model"], backbone)
        return m
    sd = unwrap_state_dict(ckpt)
    if backbone == "melception":
        return melception_from_torch(sd)
    conv = SMALL_CONV_LAYERS if small else DEFAULT_CONV_LAYERS
    return melclf_from_torch(sd, MelClfConfig(conv_layers=conv, num_classes=num_classes))


def embed(m: nn.Module, mel: torch.Tensor):
    """(logits, FD embedding): the VGGishish's 4096-d fc2 output or the
    Melception's 2048-d pool."""
    if isinstance(m, Melception):
        return melception_apply(m, mel, return_features=True)
    return melclf_apply(m, mel, return_embedding=True)


def train_forward(m: nn.Module, mel: torch.Tensor):
    """(logits, aux logits or None), the training forward of
    scripts/train_melclf.py (the Melception's with return_aux=True)."""
    if isinstance(m, Melception):
        return melception_apply(m, mel, return_aux=True)
    return melclf_apply(m, mel), None


def checkpoint(m: nn.Module, backbone: str, num_classes: int, classes=None) -> dict:
    """train_melclf's file: the reference keys and what rebuilds the model."""
    conv = list(m.cfg.conv_layers) if isinstance(m, MelClf) else None
    return {"model": {k: v.detach().cpu() for k, v in m.state_dict().items()},
            "backbone": backbone, "conv_layers": conv, "num_classes": num_classes,
            "classes": classes}

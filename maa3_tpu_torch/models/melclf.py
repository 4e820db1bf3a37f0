"""VGGishish mel classifier, the FD / KL eval backbone and LPAPS's feature
net (counterpart of maa3_tpu/models/melclf.py; ldm/modules/losses_audio/
vggishish/model.py:1-68).

VGG conv3 stacks (Conv2d, BatchNorm2d when use_bn, ReLU; MaxPool2d(2) per
"MP") over (B, 80, T) log-mels, adaptive average pool to (5, 10), then
Linear-ReLU-Linear-ReLU-Linear. The penultimate 4096-d activation is the
FD embedding. Keys are the reference's: features.{i} (a conv and its BN at
consecutive indices) and classifier.{0,2,4}.

BatchNorm follows the JAX package's rule (ops/basic.BatchNorm2d): running
statistics when the model holds them (an imported reference file), batch
statistics otherwise (random init, and a classifier trained by
train_melclf, which keeps none). Such a classifier's embeddings depend on
the batch they are computed in, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maa3_tpu_torch.ops.basic import BatchNorm2d

DEFAULT_CONV_LAYERS: Tuple[Union[int, str], ...] = (
    64, 64, "MP", 128, 128, "MP", 256, 256, 256, "MP",
    512, 512, 512, "MP", 512, 512, 512)
SMALL_CONV_LAYERS: Tuple[Union[int, str], ...] = (16, "MP", 32, "MP", 64, "MP")
EMBED_DIM = 4096


@dataclasses.dataclass(frozen=True)
class MelClfConfig:
    conv_layers: Tuple[Union[int, str], ...] = DEFAULT_CONV_LAYERS
    use_bn: bool = True
    num_classes: int = 309    # VGGSound
    pool_hw: Tuple[int, int] = (5, 10)


def conv_stack(conv_layers, use_bn: bool = False, running_stats: bool = False,
               eps: float = 1e-5) -> List[nn.Module]:
    """The features Sequential's modules, in the reference's order."""
    layers: List[nn.Module] = []
    in_ch = 1
    for v in conv_layers:
        if v == "MP":
            layers.append(nn.MaxPool2d(2, 2))
            continue
        layers.append(nn.Conv2d(in_ch, v, 3, padding=1))
        if use_bn:
            layers.append(BatchNorm2d(v, eps, running_stats))
        layers.append(nn.ReLU())
        in_ch = v
    return layers


class MelClf(nn.Module):
    def __init__(self, cfg: MelClfConfig = MelClfConfig(), running_stats: bool = False):
        super().__init__()
        self.cfg = cfg
        self.features = nn.Sequential(*conv_stack(cfg.conv_layers, cfg.use_bn,
                                                  running_stats))
        last = [v for v in cfg.conv_layers if v != "MP"][-1]
        flat = last * cfg.pool_hw[0] * cfg.pool_hw[1]
        self.classifier = nn.Sequential(
            nn.Linear(flat, EMBED_DIM), nn.ReLU(), nn.Linear(EMBED_DIM, EMBED_DIM),
            nn.ReLU(), nn.Linear(EMBED_DIM, cfg.num_classes))


@torch.no_grad()
def vgg_conv_init_(features: nn.Module, generator: torch.Generator) -> None:
    """Convs as melclf_init draws them: kaiming normal (fan_out, relu), std
    sqrt(2 / (C_out * 9)), zero bias."""
    for m in features.modules():
        if isinstance(m, nn.Conv2d):
            std = float(np.sqrt(2.0 / (m.out_channels * 9)))
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            m.bias.zero_()


@torch.no_grad()
def melclf_init_(m: MelClf, generator: torch.Generator) -> MelClf:
    """Random init as melclf_init (maa3_tpu/models/melclf.py:38): the convs
    by vgg_conv_init_, unit BN, the Linears N(0, 0.01) with zero bias."""
    vgg_conv_init_(m.features, generator)
    for lin in m.classifier:
        if isinstance(lin, nn.Linear):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=generator) * 0.01)
            lin.bias.zero_()
    return m


def melclf_apply(m: MelClf, mel: torch.Tensor, return_embedding: bool = False):
    """mel (B, 80, T) -> logits (B, classes) [or (logits, 4096-d embedding)]
    (maa3_tpu/models/melclf.py:97). F.adaptive_avg_pool2d's bins are
    JAX's: floor(i H / oh) .. ceil((i + 1) H / oh)."""
    x = m.features(mel[:, None].float())
    x = F.adaptive_avg_pool2d(x, m.cfg.pool_hw).flatten(1)
    c = m.classifier
    emb = F.relu(c[2](F.relu(c[0](x))))
    logits = c[4](emb)
    return (logits, emb) if return_embedding else logits


def melclf_features(features: nn.Module, mel: torch.Tensor) -> List[torch.Tensor]:
    """The activations before each max-pool and at the end of a conv stack
    (relu1_2 ... relu5_3 of the VGGishish16 stack; maa3_tpu/eval/lpaps.py:43)."""
    x = mel[:, None].float()
    taps = []
    for layer in features:
        if isinstance(layer, nn.MaxPool2d):
            taps.append(x)
        x = layer(x)
    taps.append(x)
    return taps


# ---------------------------------------------------------------------------
# FD / KL over classifier embeddings, numpy float64 as in JAX
# ---------------------------------------------------------------------------

def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """FD between two embedding sets (n, d): ||mu1 - mu2||^2 +
    Tr(C1 + C2 - 2 (C1 C2)^{1/2}) (maa3_tpu/models/melclf.py:128)."""
    from scipy import linalg
    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    c1 = np.cov(feats_a, rowvar=False)
    c2 = np.cov(feats_b, rowvar=False)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(c1 @ c2)  # JAX's disp=False gives the same array
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(c1 + c2 - 2.0 * covmean))


def kl_divergence_softmax(logits_gen: np.ndarray, logits_ref: np.ndarray) -> float:
    """Mean KL(ref || gen) over paired classifier posteriors
    (maa3_tpu/models/melclf.py:142)."""
    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
    p = softmax(logits_ref)
    q = softmax(logits_gen)
    return float(np.mean(np.sum(p * (np.log(p + 1e-10) - np.log(q + 1e-10)), axis=-1)))

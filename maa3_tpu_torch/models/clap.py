"""CLAP caption tower plus the combined CLAP + FLAN-T5 conditioner
(counterpart of maa3_tpu/models/clap.py).

FrozenCLAPFLANEmbedder.encode (modules.py:174-191):
  z  = Projection(BERT(ori caption).last_hidden)     (B, 77, 1024)
  z2 = T5(struct caption).last_hidden                 (B, 77, 1024)
  return cat([z, z2], 1)                              (B, 154, 1024)
Keys: caption_encoder.base.* (BERT), caption_encoder.projection.{linear1,
linear2,layer_norm}, t5_transformer.* (T5 encoder).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from maa3_tpu_torch.models.bert import Bert, BertConfig, _ns, bert_apply
from maa3_tpu_torch.models.t5 import T5Config, T5Encoder, t5_apply
from maa3_tpu_torch.ops.basic import layer_norm, linear


@dataclasses.dataclass(frozen=True)
class CLAPFLANConfig:
    bert: BertConfig = BertConfig()
    t5: T5Config = T5Config()
    d_proj: int = 1024


class CLAPFLAN(nn.Module):
    def __init__(self, cfg: CLAPFLANConfig):
        super().__init__()
        self.cfg = cfg
        d_in = cfg.bert.hidden_size
        proj = _ns(linear1=nn.Linear(d_in, cfg.d_proj, bias=False),
                   linear2=nn.Linear(cfg.d_proj, cfg.d_proj, bias=False),
                   layer_norm=nn.LayerNorm(cfg.d_proj))
        self.caption_encoder = _ns(base=Bert(cfg.bert), projection=proj)
        self.t5_transformer = T5Encoder(cfg.t5)


@torch.no_grad()
def clap_flan_init_(m: CLAPFLAN, generator: torch.Generator) -> CLAPFLAN:
    """As clap_flan_init: embeddings N(0, 0.02) (T5 shared N(0, 1), relative
    bias N(0, 0.1)), xavier-uniform linears with zero bias, unit norms."""
    for name, mod in m.named_modules():
        if isinstance(mod, nn.Embedding):
            std = 0.02
            if name.endswith("shared"):
                std = 1.0
            elif name.endswith("relative_attention_bias"):
                std = 0.1
            mod.weight.normal_(0.0, std, generator=generator)
        elif isinstance(mod, nn.Linear):
            fan_out, fan_in = mod.weight.shape
            lim = (6.0 / (fan_in + fan_out)) ** 0.5
            mod.weight.uniform_(-lim, lim, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif hasattr(mod, "weight") and not list(mod.children()):
            mod.weight.data.fill_(1.0)  # LayerNorm / RMSNorm
            if getattr(mod, "bias", None) is not None:
                mod.bias.data.zero_()
    return m


def projection_apply(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    e1 = linear(p.linear1, x)
    e2 = linear(p.linear2, F.gelu(e1))
    return layer_norm(e1 + e2, p.layer_norm.weight, p.layer_norm.bias, eps=1e-5)


def clap_flan_encode(m: CLAPFLAN, ori_ids: torch.Tensor, struct_ids: torch.Tensor,
                     ori_mask: Optional[torch.Tensor] = None,
                     struct_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 77) + (B, 77) token ids -> (B, 154, d) conditioning in fp32;
    features of every position are kept, padding included, as the
    reference does."""
    z = bert_apply(m.caption_encoder.base, ori_ids, ori_mask)
    z = projection_apply(m.caption_encoder.projection, z)
    z2 = t5_apply(m.t5_transformer, struct_ids, struct_mask)
    return torch.cat([z, z2], dim=1)


def clap_flan_encode_batch(m: CLAPFLAN, tokens: dict) -> torch.Tensor:
    """clap_flan_encode of a token batch {ori_ids, ori_mask, struct_ids,
    struct_mask} (MAA3System.tokenize): the trainable conditioner's call,
    under autograd when the caller trains it."""
    return clap_flan_encode(m, tokens["ori_ids"], tokens["struct_ids"],
                            tokens.get("ori_mask"), tokens.get("struct_mask"))

"""The text conditioners (counterpart of maa3_tpu/models/clap.py).

FrozenCLAPFLANEmbedder.encode (modules.py:174-191), `CLAPFLAN`:
  z  = Projection(BERT(ori caption).last_hidden)     (B, 77, 1024)
  z2 = T5(struct caption).last_hidden                 (B, 77, 1024)
  return cat([z, z2], 1)                              (B, 154, 1024)
Keys: caption_encoder.base.* (BERT), caption_encoder.projection.{linear1,
linear2,layer_norm}, t5_transformer.* (T5 encoder).
FrozenCLAPEmbedder (modules.py:91-129), `CLAP`: the CLAP branch alone,
under the same caption_encoder.* keys -> (B, 77, 1024).
FrozenFLANEmbedder (modules.py:54-88), `FLAN`: the T5 alone, under
transformer.* -> (B, 77, d_model).
All three take a CLAPFLANConfig; each reads only its towers' parts of it.
The video model's conditioner, Video_Feat_Encoder_NoPosembed (modules.py:
16-27), `VideoFeatEncoder`: one Linear (keys embedder.0.*) from 512-wide
video features to the DiT's context width. `ClapFusion` (the fork's
video2audio_flow_CLAP.py:485): video features concatenated per frame with a
tiled CLAP text embedding, projected back to 512 (keys fuse.*).
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


def _caption_encoder(cfg: CLAPFLANConfig) -> nn.Module:
    d_in = cfg.bert.hidden_size
    proj = _ns(linear1=nn.Linear(d_in, cfg.d_proj, bias=False),
               linear2=nn.Linear(cfg.d_proj, cfg.d_proj, bias=False),
               layer_norm=nn.LayerNorm(cfg.d_proj))
    return _ns(base=Bert(cfg.bert), projection=proj)


class CLAPFLAN(nn.Module):
    def __init__(self, cfg: CLAPFLANConfig):
        super().__init__()
        self.cfg = cfg
        self.caption_encoder = _caption_encoder(cfg)
        self.t5_transformer = T5Encoder(cfg.t5)


class CLAP(nn.Module):
    def __init__(self, cfg: CLAPFLANConfig):
        super().__init__()
        self.cfg = cfg
        self.caption_encoder = _caption_encoder(cfg)


class FLAN(nn.Module):
    def __init__(self, cfg: CLAPFLANConfig):
        super().__init__()
        self.cfg = cfg
        self.transformer = T5Encoder(cfg.t5)


class VideoFeatEncoder(nn.Module):
    def __init__(self, origin_dim: int = 512, embed_dim: int = 768):
        super().__init__()
        self.embedder = nn.Sequential(nn.Linear(origin_dim, embed_dim))


class ClapFusion(nn.Module):
    def __init__(self, visual_dim: int = 512, text_dim: int = 1024, out_dim: int = 512):
        super().__init__()
        self.fuse = nn.Linear(visual_dim + text_dim, out_dim)


# the text conditioner module of each cond_kind (config.ModelSpec)
COND_MODULES = {"clap_flan": CLAPFLAN, "clap": CLAP, "flan": FLAN}


def make_conditioner(kind: str, clap_cfg: CLAPFLANConfig, context_dim: int) -> nn.Module:
    """The conditioner of a cond_kind: a text one of COND_MODULES, or the
    video feature encoder (512 -> context_dim, as maa3_tpu/system.py:164
    builds it) for video_feat and video_feat_inpaint."""
    if kind.startswith("video_feat"):
        return VideoFeatEncoder(512, context_dim)
    return COND_MODULES[kind](clap_cfg)


@torch.no_grad()
def clap_flan_init_(m: nn.Module, generator: torch.Generator) -> nn.Module:
    """As clap_flan_init, for any of the three conditioners: embeddings
    N(0, 0.02) (T5 shared N(0, 1), relative bias N(0, 0.1)), xavier-uniform
    linears with zero bias, unit norms."""
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


def clap_encode(m: CLAP, ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FrozenCLAPEmbedder: (B, 77) BERT ids -> (B, 77, d_proj)."""
    z = bert_apply(m.caption_encoder.base, ids, mask)
    return projection_apply(m.caption_encoder.projection, z)


def flan_encode(m: FLAN, ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FrozenFLANEmbedder: (B, 77) T5 ids -> (B, 77, d_model)."""
    return t5_apply(m.transformer, ids, mask)


def video_feat_encoder_apply(m: VideoFeatEncoder, x: torch.Tensor,
                             compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, Lv, 512) video features -> (B, Lv, context_dim)
    (maa3_tpu/models/clap.py:137)."""
    return linear(m.embedder[0], x, compute_dtype)


def clap_fusion_apply(m: ClapFusion, video_feat: torch.Tensor, text_emb: torch.Tensor,
                      compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """video_feat (B, Lv, Dv) and text_emb (B, Dt) -> (B, Lv, out): each frame
    concatenated with the text embedding, then one Linear
    (maa3_tpu/models/clap.py:117)."""
    tiled = text_emb[:, None, :].expand(-1, video_feat.shape[1], -1).to(video_feat.dtype)
    return linear(m.fuse, torch.cat([video_feat, tiled], dim=-1), compute_dtype)


def clap_flan_encode_batch(m: nn.Module, tokens: dict) -> torch.Tensor:
    """The conditioner's encode of a token batch {ori_ids, ori_mask,
    struct_ids, struct_mask} (MAA3System.tokenize): CLAPFLAN reads both,
    CLAP the original captions' BERT ids, FLAN the structured captions' T5
    ids (as the JAX trainer feeds them, maa3_tpu/train/loop.py:257-268).
    The trainable conditioner's call, under autograd when the caller trains
    it."""
    if isinstance(m, FLAN):
        return flan_encode(m, tokens["struct_ids"], tokens.get("struct_mask"))
    if isinstance(m, CLAP):
        return clap_encode(m, tokens["ori_ids"], tokens.get("ori_mask"))
    return clap_flan_encode(m, tokens["ori_ids"], tokens["struct_ids"],
                            tokens.get("ori_mask"), tokens.get("struct_mask"))

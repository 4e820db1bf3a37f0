"""CLAP's BERT caption tower with its projection, and the FLAN-T5 encoder
(FrozenCLAPFLANEmbedder of Make-An-Audio 3): context = cat(proj(BERT(ori)),
T5(struct)) over the sequence, (B, 154, 1024). Keys as in HF's BertModel
under caption_encoder.base., the CLAP projection under
caption_encoder.projection., and T5EncoderModel under t5_transformer."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .core import attention, gelu_tanh, layer_norm, rms_norm
from .tokenizer import hash_tokens


def _lin(sd, name, x):
    return F.linear(x, sd[name + ".weight"], sd.get(name + ".bias"))


def bert(sd, cfg, ids, mask, p="caption_encoder.base."):
    eps, h = cfg["layer_norm_eps"], cfg["num_heads"]
    b, n = ids.shape
    x = (sd[p + "embeddings.word_embeddings.weight"][ids]
         + sd[p + "embeddings.position_embeddings.weight"][:n][None]
         + sd[p + "embeddings.token_type_embeddings.weight"][torch.zeros_like(ids)])
    x = layer_norm(x, sd[p + "embeddings.LayerNorm.weight"], sd[p + "embeddings.LayerNorm.bias"],
                   eps)
    d = x.shape[-1]
    for i in range(cfg["num_layers"]):
        q = p + f"encoder.layer.{i}."

        def heads(name):
            y = _lin(sd, q + "attention.self." + name, x)
            return y.reshape(b, n, h, d // h).transpose(1, 2)

        a = attention(heads("query"), heads("key"), heads("value"), 1.0 / math.sqrt(d // h),
                      mask=mask).transpose(1, 2).reshape(b, n, d)
        x = layer_norm(x + _lin(sd, q + "attention.output.dense", a),
                       sd[q + "attention.output.LayerNorm.weight"],
                       sd[q + "attention.output.LayerNorm.bias"], eps)
        f = _lin(sd, q + "output.dense", F.gelu(_lin(sd, q + "intermediate.dense", x)))
        x = layer_norm(x + f, sd[q + "output.LayerNorm.weight"], sd[q + "output.LayerNorm.bias"],
                       eps)
    return x


def clap_projection(sd, x, p="caption_encoder.projection."):
    e1 = _lin(sd, p + "linear1", x)
    e2 = _lin(sd, p + "linear2", F.gelu(e1))
    return layer_norm(e1 + e2, sd[p + "layer_norm.weight"], sd[p + "layer_norm.bias"], 1e-5)


def t5_buckets(q_len: int, k_len: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional relative-position buckets of the T5 encoder."""
    rel = np.arange(k_len)[None, :] - np.arange(q_len)[:, None]
    half = num_buckets // 2
    out = (rel > 0).astype(np.int64) * half
    n = np.abs(rel)
    exact = half // 2
    far = exact + (np.log(np.maximum(n, 1) / exact) / np.log(max_distance / exact)
                   * (half - exact)).astype(np.int64)
    return out + np.where(n < exact, n, np.minimum(far, half - 1))


def t5_encoder(sd, cfg, ids, mask, p="t5_transformer."):
    eps, h, dk = cfg["layer_norm_eps"], cfg["num_heads"], cfg["d_kv"]
    b, n = ids.shape
    x = sd[p + "shared.weight"][ids]
    table = sd[p + "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    buckets = t5_buckets(n, n, cfg["relative_attention_num_buckets"],
                         cfg["relative_attention_max_distance"])
    bias = table[torch.as_tensor(buckets, device=table.device)].permute(2, 0, 1)[None]
    for i in range(cfg["num_layers"]):
        q = p + f"encoder.block.{i}.layer."
        y = rms_norm(x, sd[q + "0.layer_norm.weight"], eps)

        def heads(name):
            return _lin(sd, q + "0.SelfAttention." + name, y).reshape(b, n, h, dk).transpose(1, 2)

        a = attention(heads("q"), heads("k"), heads("v"), 1.0, mask=mask, bias=bias)
        x = x + _lin(sd, q + "0.SelfAttention.o", a.transpose(1, 2).reshape(b, n, h * dk))
        y = rms_norm(x, sd[q + "1.layer_norm.weight"], eps)
        ff = q + "1.DenseReluDense."
        x = x + _lin(sd, ff + "wo", gelu_tanh(_lin(sd, ff + "wi_0", y)) * _lin(sd, ff + "wi_1", y))
    return rms_norm(x, sd[p + "encoder.final_layer_norm.weight"], eps)


def tokens(ori, struct, device):
    """The BERT ids and mask of the original captions, the T5 ids and mask of
    the structured ones, from the frozen hash tokenizer."""
    oi, om = hash_tokens(list(ori))
    si, sm = hash_tokens(list(struct))

    def dev(a):
        return torch.as_tensor(a, device=device)

    return dev(oi), dev(om).bool(), dev(si), dev(sm).bool()


def clap_flan(sd, cfg, ori, struct, device):
    """Captions -> the (B, 154, d) context of CLAP + FLAN-T5, in fp32."""
    oi, om, si, sm = tokens(ori, struct, device)
    z = clap_projection(sd, bert(sd, cfg["bert"], oi, om))
    return torch.cat([z, t5_encoder(sd, cfg["t5"], si, sm)], dim=1)

"""Checkpoint import: the reference's PyTorch-Lightning `.ckpt` files and
BigVGAN generator files into the port's modules (counterpart of
maa3_tpu/torch_import.py).

A Lightning state dict holds `model.diffusion_model.*` (the DiT),
`first_stage_model.*` (the VAE), `cond_stage_model.*` (the conditioner),
optionally `model_ema.*` (LitEma's shadows of the DiT, dots removed from
their names) and the `scale_factor` buffer. The port's modules carry the
reference's own keys (the video MoE DiT's too: blocks.{i}.feed_forward.
{time,freq}_experts.{e}.w{1,2,3} and c_embedder.mlp.{0,2,3}, the keys JAX's
dit_from_torch(moe=True) reads), so a component loads by stripping its prefix,
folding weight norm (vocoder) and `load_module_state`: the keys no JAX
importer reads (HF's tied `encoder.embed_tokens.weight`, `*.position_ids`,
`*.pooler.*`, the vocoder's resampling filters, LitEma's counters, a
first stage's loss) are left out and counted, every key the module needs
must be there (KeyError otherwise, as in JAX), and the rest loads with
strict=True, shapes checked. Tensors stay on the CPU (memory-mapped where
the file allows it) until they are copied into the modules.
"""

from __future__ import annotations

import os
from typing import Dict

import torch
from torch import nn

State = Dict[str, torch.Tensor]


class OrbaxDirectory(ValueError):
    """A directory given as a checkpoint: an Orbax checkpoint of the JAX
    package, which the port does not read."""


def read_checkpoint(path: str, weights_only: bool = False):
    """torch.load of a .ckpt / .pt file onto the CPU, memory-mapped where the
    file's format allows it. Lightning files pickle more than tensors
    (hyper-parameters), so by default this unpickles with weights_only=False,
    as the reference's loaders do: load only files you trust. A directory
    raises OrbaxDirectory, naming the converter that makes it a file."""
    if os.path.isdir(path):
        raise OrbaxDirectory(
            f"{path} is a directory: an Orbax checkpoint of the JAX package. Convert "
            f"it where JAX is installed with `python orbax_to_torch.py {path} OUT.pt` "
            f"(-b CONFIG ... for a Trainer checkpoint) and pass OUT.pt")
    try:
        return torch.load(path, map_location="cpu", weights_only=weights_only, mmap=True)
    except RuntimeError:  # a file in the legacy (non-zip) format cannot be mapped
        return torch.load(path, map_location="cpu", weights_only=weights_only)


def unwrap_state_dict(ckpt) -> State:
    """The tensors of a checkpoint's `state_dict`, `generator` or `model`
    entry, or of the file itself when it has none of them."""
    if isinstance(ckpt, dict):
        for key in ("state_dict", "generator", "model"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
    return {k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


def load_torch_checkpoint(path: str) -> State:
    """read_checkpoint + unwrap_state_dict (maa3_tpu/torch_import.py:501)."""
    return unwrap_state_dict(read_checkpoint(path))


def strip_prefix(sd: State, prefix: str) -> State:
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


def split_lightning_ckpt(sd: State) -> dict:
    """{dit, vae, cond, ema} sub-dicts by prefix, and the scale_factor
    (a float, or None when the file has none) (torch_import.py:41)."""
    sf = sd.get("scale_factor")
    return {"dit": strip_prefix(sd, "model.diffusion_model."),
            "vae": strip_prefix(sd, "first_stage_model."),
            "cond": strip_prefix(sd, "cond_stage_model."),
            "ema": strip_prefix(sd, "model_ema."),
            "scale_factor": None if sf is None else float(sf)}


def remap_ema_state(ema_sd: State, model_sd: State,
                    prefix: str = "diffusion_model.") -> State:
    """LitEma keeps each shadow under its parameter's name with the dots
    removed (ldm/modules/ema.py:16-21): the shadows of model_sd's keys under
    their own names, for those the EMA has (torch_import.py:486)."""
    out = {}
    for k in model_sd:
        s_name = (prefix + k).replace(".", "")
        if s_name in ema_sd:
            out[k] = ema_sd[s_name]
    return out


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w = g v / ||v||, the norm over every dim but 0 (torch weight_norm
    dim=0), computed in fp64 and returned in fp32 (torch_import.py:267)."""
    v64 = v.double()
    norm = v64.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return (g.double() * v64 / norm).float()


WN_NAMES = ((".weight_g", ".weight_v"),
            (".parametrizations.weight.original0", ".parametrizations.weight.original1"))


def fold_weight_norms(sd: State) -> State:
    """Every weight-normed `<name>` of either naming (`weight_g` /
    `weight_v`, or torch.nn.utils.parametrize's `original0` / `original1`)
    replaced by its folded `<name>.weight` (torch_import.py:274)."""
    out = dict(sd)
    for g_suffix, v_suffix in WN_NAMES:
        for k in [k for k in sd if k.endswith(g_suffix)]:
            name = k[:-len(g_suffix)]
            out[name + ".weight"] = fold_weight_norm(out.pop(k),
                                                     out.pop(name + v_suffix))
    return out


def load_module_state(module: nn.Module, sd: State, what: str) -> None:
    """Load sd into module: keys the module lacks are left out and logged,
    a key it needs that sd lacks raises KeyError, and the rest loads with
    strict=True (shapes checked), so no parameter keeps its init."""
    own = module.state_dict()
    extra = sorted(k for k in sd if k not in own)
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {len(missing)} of the "
                       f"model's {len(own)} keys, e.g. {missing[:5]}")
    if extra:
        print(f"{what}: skipped {len(extra)} checkpoint keys the model does not "
              f"read, e.g. {extra[:5]}")
    module.load_state_dict({k: sd[k] for k in own}, strict=True)


def lightning_parts(sd: State) -> dict:
    """split_lightning_ckpt of a Lightning state dict, with the DiT part
    replaced by the EMA shadows when they cover every DiT key of the file
    (maa3_tpu/system.py:127-131; a partial EMA is ignored, not half
    applied). parts["used_ema"] says which was taken."""
    parts = split_lightning_ckpt(sd)
    parts["used_ema"] = False
    if parts["ema"]:
        ema = remap_ema_state(parts["ema"], parts["dit"])
        if len(ema) == len(parts["dit"]):
            rest = sorted(set(parts["ema"]) - {("diffusion_model." + k).replace(".", "")
                                               for k in ema})
            print(f"using EMA weights from checkpoint; skipped {len(rest)} EMA "
                  f"keys that shadow no DiT key, e.g. {rest[:5]}")
            parts["dit"], parts["used_ema"] = ema, True
        else:
            print(f"EMA covers {len(ema)} of {len(parts['dit'])} DiT keys; "
                  "using the live weights")
    return parts


def mpd_from_torch(sd: State, mpd: nn.Module) -> nn.Module:
    """A BigVGAN MultiPeriodDiscriminator file's weights (models.py:255-277;
    weight norm folded, in either naming) loaded strictly into `mpd`
    (maa3_tpu/torch_import.py:328)."""
    load_module_state(mpd, fold_weight_norms(sd), "mpd")
    return mpd


def mrd_from_torch(sd: State, mrd: nn.Module) -> nn.Module:
    """A MultiResolutionDiscriminator's weights (models.py:281-357; the STFT
    frontend has none) loaded as mpd_from_torch loads an MPD
    (maa3_tpu/torch_import.py:341)."""
    load_module_state(mrd, fold_weight_norms(sd), "mrd")
    return mrd


def nlayer_disc_from_torch(sd: State, disc: nn.Module) -> nn.Module:
    """The PatchGAN NLayerDiscriminator's `main.{i}.*` weights, after any
    `discriminator.` prefix is stripped, loaded strictly into `disc`
    (maa3_tpu/torch_import.py:384). BatchNorm is train-mode only, so the
    file's running statistics are among the skipped keys."""
    if any(k.startswith("discriminator.") for k in sd):
        sd = strip_prefix(sd, "discriminator.")
    load_module_state(disc, sd, "nlayer_disc")
    return disc


# ---------------------------------------------------------------------------
# Eval towers: each builds its module and loads the file's keys strictly
# ---------------------------------------------------------------------------

def _has_running_stats(sd: State) -> bool:
    return any(k.endswith(".running_mean") for k in sd)


def cnn14_from_torch(sd: State, prefix: str = ""):
    """A PANNs Cnn14 state dict (keys under `prefix`) into a Cnn14
    (maa3_tpu/models/cnn14.py:141)."""
    from maa3_tpu_torch.models.cnn14 import Cnn14
    m = Cnn14()
    load_module_state(m, strip_prefix(sd, prefix) if prefix else sd, "cnn14")
    return m


def clap_scorer_from_torch(sd: State, bert_cfg=None, d_proj: int = 1024):
    """CLAP_weights_2022.pth's `model` dict into a CLAPModel: the keys under
    audio_encoder.base. (Cnn14), audio_encoder.projection.,
    caption_encoder.base. (BERT) and caption_encoder.projection.
    (maa3_tpu/eval/clap_score.py:56)."""
    from maa3_tpu_torch.eval.clap_score import CLAPModel
    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.cnn14 import Cnn14Config
    m = CLAPModel(Cnn14Config(), bert_cfg or BertConfig(), d_proj)
    load_module_state(m, sd, "clap")
    return m


def melclf_from_torch(sd: State, cfg=None):
    """A VGGishish state dict (features.{i}, classifier.{0,2,4}) into a
    MelClf (maa3_tpu/torch_import.py:404): with BN running statistics when
    the file has them (a reference classifier), else batch statistics (a
    classifier trained by train_melclf, which keeps none)."""
    from maa3_tpu_torch.models.melclf import MelClf, MelClfConfig
    m = MelClf(cfg or MelClfConfig(), running_stats=_has_running_stats(sd))
    load_module_state(m, sd, "melclf")
    return m


def melception_from_torch(sd: State):
    """A torchvision-keyed melception state dict into a Melception
    (maa3_tpu/torch_import.py:435): the classes from fc.weight, the aux
    head when the file has AuxLogits.*, BN running statistics when it has
    them."""
    from maa3_tpu_torch.models.melception import Melception, MelceptionConfig
    cfg = MelceptionConfig(num_classes=int(sd["fc.weight"].shape[0]),
                           aux_logits=any(k.startswith("AuxLogits.") for k in sd))
    m = Melception(cfg, running_stats=_has_running_stats(sd))
    load_module_state(m, sd, "melception")
    return m


def lpaps_from_torch(sd: State):
    """An LPAPS state dict (scaling_layer.*, net.slice{s}.{i}, lin{k}.model.1)
    into an LPAPS (maa3_tpu/torch_import.py:355)."""
    from maa3_tpu_torch.eval.lpaps import LPAPS
    m = LPAPS(n_mels=int(sd["scaling_layer.shift"].numel()))
    load_module_state(m, sd, "lpaps")
    return m

"""YAML config surface (counterpart of maa3_tpu/config.py) without PyYAML.

`load_yaml` reads the YAML subset the repository's configs use: block
mappings nested by indentation, flow lists of scalars, plain scalars and
comments; anything else (block lists, flow maps, quotes, anchors) raises.
Plain scalars resolve as PyYAML's YAML 1.1 resolver does (null, bools,
ints, floats with a dot). `load_config` merges files and `a.b.c=value`
overrides; `parse_model_config` maps a config onto the port's model configs
and `parse_data_config` reads the training data settings.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

from maa3_tpu_torch.models.dit import REMAT_SAVES, DiTConfig
from maa3_tpu_torch.models.dit_moe import MoEDiTConfig
from maa3_tpu_torch.models.vae1d import VAEConfig

_FLOAT = re.compile(r"""^[-+]?(?:[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?
                        |\.[0-9_]+(?:[eE][-+][0-9]+)?
                        |\.inf|\.Inf|\.INF|\.nan|\.NaN|\.NAN)$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_NULL = ("", "~", "null", "Null", "NULL")
_TRUE = ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON")
_FALSE = ("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF")


def parse_scalar(s: str) -> Any:
    """One plain scalar, resolved like PyYAML's safe_load."""
    s = s.strip()
    if s[:1] in ("'", '"', "&", "*", "!", "|", ">", "{") or s.startswith("- "):
        raise ValueError(f"YAML outside the supported subset: {s!r}")
    if s in _NULL:
        return None
    if s in _TRUE or s in _FALSE:
        return s in _TRUE
    if _INT.match(s):
        return int(s.replace("_", ""))
    if re.match(r"^[-+]?0[0-9_]+$|^[-+]?0[box]", s):
        raise ValueError(f"YAML outside the supported subset: {s!r}")
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        return float("nan") if t.endswith("nan") else float(t)
    return s


def _value(s: str) -> Any:
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        body = s[1:-1]
        if "[" in body or "]" in body:
            raise ValueError(f"YAML outside the supported subset: {s!r}")
        return [parse_scalar(p) for p in body.split(",")] if body.strip() else []
    return parse_scalar(s)


def load_yaml(text: str) -> Any:
    lines = []
    for raw in text.splitlines():
        line = re.sub(r"(^|\s)#.*$", "", raw).rstrip()
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    pos = 0

    def mapping(indent: int) -> dict:
        nonlocal pos
        out = {}
        while pos < len(lines) and lines[pos][0] == indent:
            m = re.match(r"^([A-Za-z0-9_.]+):(?:\s+(.*))?$", lines[pos][1])
            if not m:
                raise ValueError(f"YAML outside the supported subset: {lines[pos][1]!r}")
            pos += 1
            if m.group(2) is not None:
                out[m.group(1)] = _value(m.group(2))
            elif pos < len(lines) and lines[pos][0] > indent:
                out[m.group(1)] = mapping(lines[pos][0])
            else:
                out[m.group(1)] = None
        return out

    result = mapping(lines[0][0]) if lines else None
    if pos != len(lines):
        raise ValueError(f"YAML outside the supported subset: {lines[pos][1]!r}")
    return result


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(paths: Sequence[str], overrides: Sequence[str] = ()) -> dict:
    """Merge YAML files left to right, then apply `a.b.c=value` overrides."""
    cfg: dict = {}
    for p in paths:
        with open(p, encoding="utf-8") as f:
            cfg = _deep_merge(cfg, load_yaml(f.read()) or {})
    for ov in overrides:
        if "=" not in ov:
            continue
        key, val = ov.split("=", 1)
        node = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _value(val)
    return cfg


# the reference's `target:` classes the port runs, with the kind each maps to
# (maa3_tpu/config.py:67-90)
TARGET_KINDS = {
    "ldm.models.diffusion.cfm1_audio.CFM": "cfm",
    "ldm.models.diffusion.cfm1_audio.CFM_inpaint": "cfm_inpaint",
    "ldm.modules.diffusionmodules.flag_large_dit.TxtFlagLargeDiT": "text_dit",
    "ldm.modules.diffusionmodules.flag_large_dit.TxtFlagLargeImprovedDiTV2": "text_dit",
    "ldm.modules.diffusionmodules.flag_large_dit_moe.VideoFlagLargeDiT": "video_moe_dit",
    "ldm.models.autoencoder1d.AutoencoderKL": "vae1d",
    "ldm.modules.encoders.modules.FrozenCLAPFLANEmbedder": "clap_flan",
    "ldm.modules.encoders.modules.FrozenFLANEmbedder": "flan",
    "ldm.modules.encoders.modules.FrozenCLAPEmbedder": "clap",
    "ldm.modules.encoders.modules.Video_Feat_Encoder_NoPosembed": "video_feat",
    "ldm.modules.encoders.modules.Video_Feat_Encoder_NoPosembed_inpaint":
        "video_feat_inpaint",
}
SUPPORTED_TARGETS = set(TARGET_KINDS)


@dataclasses.dataclass
class ModelSpec:
    dit: Any                        # DiTConfig | MoEDiTConfig
    vae: VAEConfig
    mel_dim: int = 20
    mel_length: int = 312
    scale_factor: float = 1.0
    timesteps: int = 1000
    scale_by_std: bool = False
    cond_stage_trainable: bool = False
    base_learning_rate: float = 3.0e-6
    cond_kind: str = "clap_flan"  # clap_flan | flan | clap | video_feat(_inpaint)
    kind: str = "cfm"               # cfm | cfm_inpaint
    backbone_kind: str = "text_dit"  # text_dit | video_moe_dit


@dataclasses.dataclass
class DataSpec:
    """One split of a config's data section, as scripts/train.py build_loader
    reads it: a manifest (TextSpecDataset, `dataset_name`) or a directory of
    manifests (AnyLenSpecDataset, `main_spec_dir_path`)."""
    dataset_name: str
    spec_crop_len: int = 624
    drop: float = 0.0
    batch_size: int = 16
    split: str = "train"                # the dataset's split: train | valid
    any_len: bool = False               # AnyLenSpecDataset over main_spec_dir_path


# JAX's remat policies (maa3_tpu/models/dit.py:254-293)
REMAT_POLICIES = tuple(REMAT_SAVES)


def parse_model_config(cfg: dict) -> ModelSpec:
    """cfg: the full YAML dict (with `model:`) or the model subtree. The port
    covers text-to-audio and text-to-music CFM with the text DiT, the 1-D
    VAE and the CLAP+FLAN, FLAN or CLAP conditioner, and video-to-audio CFM
    (and CFM_inpaint) with the MoE DiT and the video feature encoder."""
    model = cfg.get("model", cfg)
    params = model.get("params", {})
    unet = params["unet_config"]
    up = unet.get("params", {})
    first = params["first_stage_config"]
    cond = params.get("cond_stage_config", {})
    for sub in (model, unet, first, cond):
        if sub.get("target") not in SUPPORTED_TARGETS:
            raise KeyError(f"config target not supported by the port: "
                           f"{sub.get('target')}")
    backbone_kind = TARGET_KINDS[unet["target"]]
    if backbone_kind == "video_moe_dit":
        dit = _moe_cfg(up)
    else:
        dit = _dit_cfg(up)
    fp = first.get("params", {})
    dd = fp.get("ddconfig", {})
    vae = VAEConfig(
        in_channels=dd.get("in_channels", 80),
        out_ch=dd.get("out_ch", 80),
        ch=dd.get("ch", 384), ch_mult=tuple(dd.get("ch_mult", (1, 2, 4))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        attn_layers=tuple(dd.get("attn_layers", ())),
        down_layers=tuple(dd.get("down_layers", (0,))),
        kernel_size=dd.get("kernel_size", 5),
        z_channels=dd.get("z_channels", 20), double_z=dd.get("double_z", True),
        embed_dim=fp.get("embed_dim", 20))
    return ModelSpec(
        dit=dit, vae=vae, mel_dim=params.get("mel_dim", 20),
        mel_length=params.get("mel_length", 312),
        scale_factor=params.get("scale_factor", 1.0),
        timesteps=params.get("timesteps", 1000),
        scale_by_std=params.get("scale_by_std", False),
        cond_stage_trainable=params.get("cond_stage_trainable", False),
        base_learning_rate=model.get("base_learning_rate", 3.0e-6),
        cond_kind=TARGET_KINDS[cond["target"]], kind=TARGET_KINDS[model["target"]],
        backbone_kind=backbone_kind)


def _moe_cfg(up: dict) -> MoEDiTConfig:
    """The video MoE DiT's config (maa3_tpu/config.py:148-149)."""
    return MoEDiTConfig(
        in_channels=up.get("in_channels", 20),
        context_dim=up.get("context_dim", 1024),
        hidden_size=up.get("hidden_size", 768),
        depth=up.get("depth", 16),
        num_heads=up.get("num_heads", 32),
        max_len=up.get("max_len", 1000),
        n_kv_heads=up.get("n_kv_heads"),
        multiple_of=up.get("multiple_of", 256),
        ffn_dim_multiplier=up.get("ffn_dim_multiplier"),
        norm_eps=up.get("norm_eps", 1e-5),
        qk_norm=bool(up.get("qk_norm") or False),
        rope_scaling_factor=up.get("rope_scaling_factor", 1.0),
        ntk_factor=up.get("ntk_factor", 1.0),
        use_flash=up.get("use_flash"),
        num_experts=up.get("num_experts", 4))


def _dit_cfg(up: dict) -> DiTConfig:
    return DiTConfig(
        in_channels=up.get("in_channels", 20),
        context_dim=up.get("context_dim", 1024),
        hidden_size=up.get("hidden_size", 768),
        depth=up.get("depth", 16),
        num_heads=up.get("num_heads", 32),
        n_kv_heads=up.get("n_kv_heads"),
        multiple_of=up.get("multiple_of", 256),
        ffn_dim_multiplier=up.get("ffn_dim_multiplier"),
        norm_eps=up.get("norm_eps", 1e-5),
        qk_norm=bool(up.get("qk_norm") or False),
        rope_scaling_factor=up.get("rope_scaling_factor", 1.0),
        ntk_factor=up.get("ntk_factor", 1.0),
        use_flash=up.get("use_flash"),
        remat=bool(up.get("remat") or False),
        remat_policy=up.get("remat_policy", "nothing"))


def parse_data_config(cfg: dict, split: str = "train") -> DataSpec:
    """data.params: batch_size and the dataset of `split` (train or
    validation), as scripts/train.py build_loader chooses it: a missing
    `validation` entry falls back to the train entry's valid split (its
    first 100 rows); TextSpecDataset when the target names txt_spec_dataset
    or the dataset_cfg has dataset_name (spec_crop_len, drop), else
    AnyLenSpecDataset over main_spec_dir_path. Validation drops no caption."""
    data = cfg.get("data", {}).get("params", {})
    entry = data.get(split if split in data else "train", {})
    params = entry.get("params", {})
    dcfg = params.get("dataset_cfg", params.get("specs_dataset_cfg", params))
    train = split == "train"
    common = dict(drop=dcfg.get("drop", 0.0) if train else 0.0,
                  batch_size=data.get("batch_size", 16),
                  split="train" if train else "valid")
    if "txt_spec_dataset" in entry.get("target", "") or "dataset_name" in dcfg:
        return DataSpec(dataset_name=dcfg["dataset_name"],
                        spec_crop_len=dcfg.get("spec_crop_len", 624), **common)
    if "main_spec_dir_path" not in dcfg:
        raise KeyError(f"data.params.{split}: neither dataset_name nor "
                       "main_spec_dir_path is set")
    return DataSpec(dataset_name=dcfg["main_spec_dir_path"],
                    spec_crop_len=dcfg.get("spec_crop_len", 1248), any_len=True, **common)

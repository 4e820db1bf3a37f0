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

from maa3_tpu_torch.models.dit import DiTConfig
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


# the reference's `target:` classes the port runs
SUPPORTED_TARGETS = {
    "ldm.models.diffusion.cfm1_audio.CFM",
    "ldm.modules.diffusionmodules.flag_large_dit.TxtFlagLargeDiT",
    "ldm.modules.diffusionmodules.flag_large_dit.TxtFlagLargeImprovedDiTV2",
    "ldm.models.autoencoder1d.AutoencoderKL",
    "ldm.modules.encoders.modules.FrozenCLAPFLANEmbedder",
    "ldm.modules.encoders.modules.FrozenFLANEmbedder",
    "ldm.modules.encoders.modules.FrozenCLAPEmbedder",
}

# the conditioner kind of each cond-stage target (maa3_tpu/config.py:84-87)
COND_KINDS = {
    "ldm.modules.encoders.modules.FrozenCLAPFLANEmbedder": "clap_flan",
    "ldm.modules.encoders.modules.FrozenFLANEmbedder": "flan",
    "ldm.modules.encoders.modules.FrozenCLAPEmbedder": "clap",
}


@dataclasses.dataclass
class ModelSpec:
    dit: DiTConfig
    vae: VAEConfig
    mel_dim: int = 20
    mel_length: int = 312
    scale_factor: float = 1.0
    timesteps: int = 1000
    scale_by_std: bool = False
    cond_stage_trainable: bool = False
    base_learning_rate: float = 3.0e-6
    cond_kind: str = "clap_flan"  # clap_flan | flan | clap (COND_KINDS)


@dataclasses.dataclass
class DataSpec:
    """The text-to-spectrogram training set of a config's data section."""
    dataset_name: str
    spec_crop_len: int = 624
    drop: float = 0.0
    batch_size: int = 16


# the only remat policy the port has: recompute the whole block
REMAT_POLICIES = ("nothing",)


def parse_model_config(cfg: dict) -> ModelSpec:
    """cfg: the full YAML dict (with `model:`) or the model subtree. The port
    covers text-to-audio and text-to-music CFM with the text DiT, the 1-D
    VAE and the CLAP+FLAN, FLAN or CLAP conditioner."""
    model = cfg.get("model", cfg)
    params = model.get("params", {})
    unet = params["unet_config"]
    up = unet.get("params", {})
    dit = DiTConfig(
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
        remat=bool(up.get("remat") or False))
    policy = up.get("remat_policy", "nothing")
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} is not supported by the port "
                         f"(supported: {', '.join(REMAT_POLICIES)})")
    first = params["first_stage_config"]
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
    cond = params.get("cond_stage_config", {})
    for sub in (model, unet, first, cond):
        if sub.get("target") not in SUPPORTED_TARGETS:
            raise KeyError(f"config target not supported by the port: "
                           f"{sub.get('target')}")
    return ModelSpec(
        dit=dit, vae=vae, mel_dim=params.get("mel_dim", 20),
        mel_length=params.get("mel_length", 312),
        scale_factor=params.get("scale_factor", 1.0),
        timesteps=params.get("timesteps", 1000),
        scale_by_std=params.get("scale_by_std", False),
        cond_stage_trainable=params.get("cond_stage_trainable", False),
        base_learning_rate=model.get("base_learning_rate", 3.0e-6),
        cond_kind=COND_KINDS[cond["target"]])


def parse_data_config(cfg: dict) -> DataSpec:
    """data.params: batch_size and the train set's dataset_cfg (dataset_name,
    spec_crop_len, drop) of a manifest (TSV) dataset."""
    data = cfg.get("data", {}).get("params", {})
    train = data.get("train", {}).get("params", {})
    dcfg = train.get("dataset_cfg", train.get("specs_dataset_cfg", train))
    if "dataset_name" not in dcfg:
        raise KeyError("the port trains from a manifest: data.params.train."
                       "params.dataset_cfg.dataset_name is not set")
    return DataSpec(dataset_name=dcfg["dataset_name"],
                    spec_crop_len=dcfg.get("spec_crop_len", 624),
                    drop=dcfg.get("drop", 0.0),
                    batch_size=data.get("batch_size", 16))

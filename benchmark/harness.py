"""The benchmark's frame: reading BENCHMARK.json and the files it names,
the run's guards (the cards asked for, no JAX in the process), the program
under test built from the benchmark's seeded weights, the per-layer metric
readers, and the result line.

Everything one configuration, cell, traffic driver or per-layer metric
needs is found by its name: benchmark/configs/<file named in
BENCHMARK.json>, benchmark/workloads/<cell>.json, benchmark/traffic/
<driver>.py, benchmark/metrics/<metric>.py (or <metric before its first
dot>.py, which serves every suffix). A later cell or metric is a new file
and a new entry, never an edit."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "maa3_tpu")


class Refused(RuntimeError):
    """The run cannot give a result: no result line is printed."""


def forbidden_loaded() -> list:
    """Modules of a forbidden top-level name (compared whole) in this process."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_env(root: Path) -> None:
    """Fixed cache directories inside the checkout, and no JAX behind a
    library's back."""
    build = root / "build"
    for k, v in (("TRITON_CACHE_DIR", build / "triton-cache"),
                 ("TORCH_EXTENSIONS_DIR", build / "torch-extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", build / "inductor-cache"),
                 ("CUDA_CACHE_PATH", build / "cuda-cache")):
        os.environ[k] = str(v)
    for k, v in (("USE_FLAX", "0"), ("USE_JAX", "0"), ("USE_TF", "0"), ("HF_HUB_OFFLINE", "1")):
        os.environ[k] = v


class Bench:
    """BENCHMARK.json under `root`, and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise Refused(f"no BENCHMARK.json at {self.root}")
        self.spec = json.loads(path.read_text())
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.configs = {c["name"]: c for c in self.spec["configs"]}
        self.end_to_end = {m["name"]: m for m in self.spec["end_to_end"]}
        self.per_layer = {m["name"]: m for m in self.spec["per_layer"]}

    def _find(self, kind: str, name: str) -> Path:
        for base in (self.root / "benchmark" / kind, PKG / kind):
            p = base / name
            if p.is_file():
                return p
        raise Refused(f"no {kind} file {name!r}")

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise Refused(f"unknown workload {name!r}; BENCHMARK.json has {sorted(self.cells)}")
        entry = self.cells[name]
        data = json.loads(self._find("workloads", f"{name}.json").read_text())
        for key in ("config", "traffic"):
            if data.get(key) != entry[key]:
                raise Refused(f"workload {name}: its file says {key} {data.get(key)!r}, "
                              f"BENCHMARK.json {entry[key]!r}")
        return data

    def config(self, name: str) -> dict:
        if name not in self.configs:
            raise Refused(f"unknown configuration {name!r}")
        return json.loads((self.root / self.configs[name]["file"]).read_text())

    def metrics_of(self, cell: str, trace: bool) -> Dict[str, dict]:
        """The cell's end-to-end metrics (trace 0) or per-layer ones (trace 1)."""
        e2e = {n: m for n, m in self.end_to_end.items()
               if "workloads" not in m or cell in m["workloads"]}
        if not trace:
            return e2e
        return {n: m for n, m in self.per_layer.items()
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)}

    def driver(self, name: str):
        if not name.isidentifier():
            raise Refused(f"bad traffic driver name {name!r}")
        self._find("traffic", f"{name}.py")
        return importlib.import_module(f"benchmark.traffic.{name}")

    def reader(self, metric: str):
        for fname in (f"{metric}.py", f"{metric.split('.')[0]}.py"):
            try:
                path = self._find("metrics", fname)
            except Refused:
                continue
            spec = importlib.util.spec_from_file_location(
                "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
        raise Refused(f"no reader for per-layer metric {metric!r}")


# -- the program under test ----------------------------------------------------

def model_spec(cfg: dict, mel_length: int):
    """The port's ModelSpec of a configuration file; mel_length is the
    latent length the server defaults to and warms up (the cell's)."""
    from maa3_tpu_torch.config import ModelSpec
    from maa3_tpu_torch.models.dit import DiTConfig
    from maa3_tpu_torch.models.vae1d import VAEConfig
    m = cfg["model"]
    vae = {k: tuple(v) if isinstance(v, list) else v for k, v in m["vae"].items()}
    return ModelSpec(dit=DiTConfig(**m["dit"]), vae=VAEConfig(**vae),
                     mel_dim=m["latent_channels"], mel_length=mel_length,
                     scale_factor=m["scale_factor"], timesteps=m["timesteps"],
                     scale_by_std=m["scale_by_std"],
                     cond_stage_trainable=m["cond_stage_trainable"],
                     base_learning_rate=m["base_learning_rate"], cond_kind=m["cond_kind"])


def part_configs(cfg: dict):
    """(BigVGANConfig, CLAPFLANConfig) of a configuration file."""
    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig
    from maa3_tpu_torch.models.t5 import T5Config
    v = cfg["vocoder"]
    voc = BigVGANConfig(**{k: (tuple(tuple(d) for d in x) if k == "resblock_dilation_sizes"
                               else tuple(x) if isinstance(x, list) else x)
                           for k, x in v.items()})
    c = cfg["conditioner"]
    return voc, CLAPFLANConfig(bert=BertConfig(**c["bert"]), t5=T5Config(**c["t5"]),
                               d_proj=c["d_proj"])


def meta_modules(cfg: dict, spec) -> dict:
    """The program's modules of a configuration on the meta device: their
    parameter names and shapes, nothing computed."""
    import torch
    from maa3_tpu_torch.models.bigvgan import BigVGAN
    from maa3_tpu_torch.models.clap import make_conditioner
    from maa3_tpu_torch.models.vae1d import AutoencoderKL
    from maa3_tpu_torch.system import dit_module
    voc, clap = part_configs(cfg)
    with torch.device("meta"):
        return {"dit": dit_module(spec), "vae": AutoencoderKL(spec.vae), "vocoder": BigVGAN(voc),
                "cond": make_conditioner(spec.cond_kind, clap, spec.dit.context_dim)}


def seeded_state(cfg: dict, seed: int, device, mel_length: int = 312) -> dict:
    from benchmark.weights import make_state
    return make_state(meta_modules(cfg, model_spec(cfg, mel_length)), seed, device)


def build_system(cfg: dict, seed: int, device, mel_length: int):
    """MAA3System from the benchmark's seeded weights (bf16 compute)."""
    import torch
    from maa3_tpu_torch.system import MAA3System
    spec = model_spec(cfg, mel_length)
    state = seeded_state(cfg, seed, device, mel_length)
    voc, clap = part_configs(cfg)
    system = MAA3System.from_state_dicts(spec, state, voc, clap,
                                         scale_factor=cfg["model"]["scale_factor"],
                                         device=device, compute_dtype=torch.bfloat16)
    del state
    return system


def free_device() -> None:
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# -- the result ---------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile with linear interpolation (numpy's default); a
    missing value (inf) counts as the slowest."""
    import numpy as np
    return float(np.percentile(np.asarray(values, np.float64), q))


def finite(x) -> bool:
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)


def emit(result: dict, checks: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error; the result as the last line of standard output, checks last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)

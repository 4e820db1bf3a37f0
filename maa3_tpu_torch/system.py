"""MAA3System: config, weights, conditioning, sampling and decoding in one
runtime object (counterpart of maa3_tpu/system.py: text-to-audio,
text-to-music, and video-to-audio with the MoE DiT).

Weights come from a seed, from the reference's Lightning `.ckpt` (with its
vocoder directory), or from a checkpoint of the port's own Trainer
(`from_config(ckpt_path=, vocoder_dir=)`). Serving in bf16 runs a serving
copy of the DiT (matmul weights rounded to bf16, q/k/v and w1/w3 fused)
with the residual stream carried in fp32 for the text DiT
(system.py:421-433); the VAE decodes in fp32; the vocoder runs in the
compute dtype through the K1/K2 kernels on CUDA.

int8 serving (`set_serving_quant("int8[:g<N>][,now2][,voc|,novoc][,smooth]")`):
the serving copy is fused, migrated (SmoothQuant, after `calibrate_smooth`),
quantized from the fp32 weights and cast to bf16 (ops/quant.py); `:voc`
also runs the wide vocoder stages' resblock convs w8a8
(models/bigvgan.py quantize_bigvgan). Both serving copies are rebuilt when
the mode or a canonical parameter changes.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from maa3_tpu_torch import config as config_mod
from maa3_tpu_torch import torch_import, trace
from maa3_tpu_torch.config import ModelSpec
from maa3_tpu_torch.data.tokenizers import load_tokenizer
from maa3_tpu_torch.diffusion import cfm
from maa3_tpu_torch.models.bigvgan import (BigVGAN, BigVGANConfig, bigvgan_init_,
                                           quantize_bigvgan)
from maa3_tpu_torch.models.clap import (CLAPFLANConfig, clap_flan_encode_batch,
                                        clap_flan_init_, make_conditioner,
                                        video_feat_encoder_apply)
from maa3_tpu_torch.models.dit import (DiT, dit_apply, dit_init_, dit_route,
                                       quant_serving_copy, serving_copy, unfreeze_zero_init)
from maa3_tpu_torch.models.dit_moe import MoEDiT, moe_dit_apply
from maa3_tpu_torch.models.vae1d import (AutoencoderKL, gaussian_sample,
                                         vae_encode_moments, vae_init_)
from maa3_tpu_torch.ops.flash_attention import MAX_HEAD_DIM
from maa3_tpu_torch.pipeline import T2APipeline, full_fp32, sample_planned

# a vocoder directory's generator file: the first of these names it holds
# (maa3_tpu/system.py:189-190)
VOCODER_FILES = ("generator.pt", "generator.pth", "g_02500000", "g_02500000.pth",
                 "bigvgan_generator.pt", "best_netG.pt")


def _parse_quant_mode(mode: str):
    """ "int8[:g<N>][,now2][,voc|,novoc][,smooth]" -> (group_size, skip_w2,
    quant_voc, smooth); anything else raises ValueError
    (maa3_tpu/system.py:42)."""
    base, _, opts = mode.partition(":")
    if base != "int8":
        raise ValueError(f"unknown serving quant mode: {mode!r}")
    group, skip_w2, quant_voc, smooth = 0, False, False, False
    for o in filter(None, opts.split(",")):
        if o.startswith("g") and o[1:].isdigit():
            group = int(o[1:])
        elif o == "now2":
            skip_w2 = True
        elif o == "voc":
            quant_voc = True
        elif o == "novoc":
            quant_voc = False
        elif o == "smooth":
            smooth = True
        else:
            raise ValueError(f"unknown int8 variant option: {o!r} in {mode!r}")
    return group, skip_w2, quant_voc, smooth


def with_cfg(dit: nn.Module, cfg) -> nn.Module:
    """`dit` run under another config: a shallow copy sharing its weights."""
    d = copy.copy(dit)
    d.cfg = cfg
    return d


def dit_module(spec: ModelSpec) -> nn.Module:
    """The config's backbone, uninitialised: the text DiT or the video MoE."""
    return (MoEDiT if spec.backbone_kind == "video_moe_dit" else DiT)(spec.dit)


def _versions(m: nn.Module):
    return (id(m), tuple(t._version for t in m.parameters()))


def check_limits(spec: ModelSpec, device, latent_len: Optional[int] = None) -> None:
    """Refuse, before any launch, a config whose serving route the card's
    kernels cannot run: a DiT head dim above the flash kernels' MAX_HEAD_DIM
    where models/dit.py `dit_route` sends self-attention to flash at
    latent_len (default: the config's latent length). At such head dims the
    planned step on the card follows the inference rule asked here."""
    cfg = spec.dit
    n = spec.mel_length if latent_len is None else latent_len
    if (torch.device(device).type == "cuda" and cfg.head_dim > MAX_HEAD_DIM
            and dit_route(cfg, n).self_flash):
        raise ValueError(
            f"DiT head dim {cfg.head_dim} (hidden {cfg.hidden_size} / "
            f"{cfg.num_heads} heads) exceeds the flash kernels' {MAX_HEAD_DIM}, "
            f"and self-attention at latent length {n} "
            f"(use_flash={cfg.use_flash}) runs on them")


def vocoder_from_dir(vocoder_dir: str, voc_cfg: BigVGANConfig, device,
                     generator: torch.Generator) -> BigVGAN:
    """A vocoder directory (maa3_tpu/system.py:182-199, _load_vocoder :236):
    its config.json (else voc_cfg) and the weights of its first generator
    file among VOCODER_FILES, weight norm folded; random init when it holds
    no generator file."""
    cfg_json = os.path.join(vocoder_dir, "config.json")
    if os.path.exists(cfg_json):
        with open(cfg_json) as f:
            voc_cfg = BigVGANConfig.from_dict(json.load(f))
    with torch.device(device):
        voc = bigvgan_init_(BigVGAN(voc_cfg), generator)
    for name in VOCODER_FILES:
        path = os.path.join(vocoder_dir, name)
        if os.path.exists(path):
            sd = torch_import.fold_weight_norms(torch_import.load_torch_checkpoint(path))
            torch_import.load_module_state(voc, sd, f"vocoder {path}")
            break
    return voc


def _trainer_states(payload: dict, mods: Dict[str, nn.Module]) -> Dict[str, dict]:
    """The state dicts of a checkpoint of the port's Trainer
    (train/loop.py save_checkpoint): the trained modules ({dit, cond?}),
    their EMA shadows in place of the live weights when the file has them
    (as _from_orbax prefers ema_params, maa3_tpu/system.py:217), and the
    frozen VAE."""
    params = payload["params"]
    states = {k: dict(v) for k, v in params.items()}
    if "ema_params" in payload:
        # the shadows follow Trainer.state.trainable_parameters(): the DiT's
        # parameters, then the trained conditioner's
        names = [(k, n) for k in params for n, _ in mods[k].named_parameters()]
        ema = payload["ema_params"]
        if len(ema) != len(names):
            raise ValueError(f"{len(ema)} EMA shadows for {len(names)} parameters")
        for (k, n), t in zip(names, ema):
            states[k][n] = t
        print("using EMA weights from checkpoint")
    if "frozen" in payload:
        states["vae"] = payload["frozen"]["vae"]
    return states


class MAA3System:
    def __init__(self, spec: ModelSpec, dit: nn.Module, vae: AutoencoderKL,
                 vocoder: BigVGAN, cond: Optional[nn.Module],
                 scale_factor: float = 1.0,
                 tokenizer_dir: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.bfloat16):
        """dit: a DiT, or a MoEDiT for the video backbone; cond: the
        conditioner of spec.cond_kind (clap.make_conditioner), or None."""
        self.spec = spec
        self.dit, self.vae, self.vocoder, self.cond = dit, vae, vocoder, cond
        for m in (dit, vae, vocoder, cond):  # inference only
            if m is not None:
                m.requires_grad_(False)
        self.scale_factor = float(scale_factor)
        self.compute_dtype = compute_dtype
        self.device = next(dit.parameters()).device
        tk_root = tokenizer_dir or os.environ.get("MAA3_TOKENIZER_DIR")
        self.bert_tokenizer = load_tokenizer(
            os.path.join(tk_root, "bert") if tk_root else None, "bert")
        self.t5_tokenizer = load_tokenizer(
            os.path.join(tk_root, "t5") if tk_root else None, "t5")
        self._serving_dit = None
        self._serving_key = None
        self._serving_voc = None
        self._serving_voc_key = None
        self._smooth_stats = None   # SmoothQuant calibration (calibrate_smooth)
        self.serve_quant: Optional[str] = None  # set_serving_quant
        self._serving_mesh = None   # shard_serving

    # -- construction ------------------------------------------------------

    @classmethod
    def from_config(cls, config_paths: Sequence[str], overrides: Sequence[str] = (),
                    seed: int = 0, compute_dtype: torch.dtype = torch.bfloat16,
                    device="cuda", clap_cfg: Optional[CLAPFLANConfig] = None,
                    voc_cfg: Optional[BigVGANConfig] = None,
                    unfreeze: bool = False,
                    tokenizer_dir: Optional[str] = None,
                    ckpt_path: Optional[str] = None,
                    vocoder_dir: Optional[str] = None,
                    init_cond: bool = True) -> "MAA3System":
        """Build on `device` (maa3_tpu/system.py:103-200). Every module starts
        from a torch.Generator seeded with `seed`; then:
        - ckpt_path, a Lightning `.ckpt` of the reference: the DiT (its EMA
          shadows when they cover every DiT key), the VAE, the conditioner of
          the config's kind when the file has one, and its scale_factor;
        - ckpt_path, a `.pt` of the port's Trainer: the DiT and the trained
          conditioner (their EMA shadows when present), the frozen VAE and
          the scale_factor;
        - vocoder_dir: config.json and the generator (vocoder_from_dir).
        The video config builds the MoE DiT and the video feature encoder.
        Checkpoint tensors are read on the CPU and copied into the modules.
        init_cond=False leaves the system without a conditioner when the
        checkpoint has none. unfreeze=True makes a random DiT's zero-init
        adaLN, final layer and gates nonzero (it is otherwise an identity)."""
        spec = config_mod.parse_model_config(
            config_mod.load_config(config_paths, overrides))
        check_limits(spec, device)
        raw = torch_import.read_checkpoint(ckpt_path) if ckpt_path else None
        trainer_file = isinstance(raw, dict) and "params" in raw and "opt_state" in raw
        states, scale_factor = {}, spec.scale_factor
        if raw is not None and not trainer_file:
            parts = torch_import.lightning_parts(torch_import.unwrap_state_dict(raw))
            states = {k: parts[k] for k in ("dit", "vae", "cond") if parts[k]}
            if parts["scale_factor"] is not None:
                scale_factor = parts["scale_factor"]
        gen = torch.Generator(device=device).manual_seed(seed)
        has_cond = init_cond or "cond" in states or (
            trainer_file and "cond" in raw["params"])
        with torch.device(device):
            dit = dit_module(spec)
            vae = AutoencoderKL(spec.vae)
            cond = make_conditioner(spec.cond_kind, clap_cfg or CLAPFLANConfig(),
                                    spec.dit.context_dim) if has_cond else None
        dit_init_(dit, gen)
        if unfreeze:
            unfreeze_zero_init(dit, gen)
        vae_init_(vae, gen)
        if vocoder_dir:
            voc = vocoder_from_dir(vocoder_dir, voc_cfg or BigVGANConfig(), device, gen)
        else:
            with torch.device(device):
                voc = bigvgan_init_(BigVGAN(voc_cfg or BigVGANConfig()), gen)
        if cond is not None:
            clap_flan_init_(cond, gen)
        mods = {"dit": dit, "vae": vae, "cond": cond}
        if trainer_file:
            states = _trainer_states(raw, mods)
            scale_factor = float(raw.get("scale_factor", scale_factor))
        for k, sd in states.items():
            torch_import.load_module_state(mods[k], sd, f"{k} of {ckpt_path}")
        return cls(spec, dit, vae, voc, cond, scale_factor, tokenizer_dir,
                   compute_dtype)

    @classmethod
    def from_state_dicts(cls, spec: ModelSpec, state: Dict[str, dict],
                         voc_cfg: BigVGANConfig, clap_cfg: CLAPFLANConfig,
                         scale_factor: float = 1.0, device="cuda",
                         compute_dtype: torch.dtype = torch.bfloat16,
                         tokenizer_dir: Optional[str] = None) -> "MAA3System":
        """Build from {dit, vae, vocoder, cond} state dicts with the
        reference keys (e.g. weights.params_from_jax); the conditioner is
        spec.cond_kind's."""
        with torch.device(device):
            mods = {"dit": dit_module(spec), "vae": AutoencoderKL(spec.vae),
                    "vocoder": BigVGAN(voc_cfg),
                    "cond": make_conditioner(spec.cond_kind, clap_cfg,
                                             spec.dit.context_dim)}
        for k, m in mods.items():
            m.load_state_dict(state[k])
        return cls(spec, mods["dit"], mods["vae"], mods["vocoder"], mods["cond"],
                   scale_factor, tokenizer_dir, compute_dtype)

    def _load_vocoder(self, vocoder_dir: str, seed: int = 0) -> None:
        """Replace the vocoder by a vocoder directory's (system.py:236)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.vocoder = vocoder_from_dir(vocoder_dir, self.vocoder.cfg, self.device, gen)
        self.vocoder.requires_grad_(False)

    # -- conditioning ------------------------------------------------------

    def tokenize(self, c) -> Dict[str, torch.Tensor]:
        """c: {'ori_caption': [...], 'struct_caption': [...]} or list[str] ->
        the conditioner's token batch on the device: BERT ids and mask of the
        original captions, T5 ids and mask of the structured ones
        (maa3_tpu/train/loop.py:284-289)."""
        ori = c["ori_caption"] if isinstance(c, dict) else list(c)
        struct = c["struct_caption"] if isinstance(c, dict) else list(c)
        ori_ids, ori_mask = self.bert_tokenizer(ori)
        st_ids, st_mask = self.t5_tokenizer(struct)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

        return {"ori_ids": dev(ori_ids), "ori_mask": dev(ori_mask),
                "struct_ids": dev(st_ids), "struct_mask": dev(st_mask)}

    def captions(self, ori: Sequence[str], struct: Sequence[str]):
        """The argument get_learned_conditioning takes for these captions:
        the {ori_caption, struct_caption} dict for clap_flan, the structured
        captions for flan and the original ones for clap (the captions the
        JAX trainer tokenizes for each, maa3_tpu/train/loop.py:257-289)."""
        kind = self.spec.cond_kind
        if kind == "clap_flan":
            return {"ori_caption": list(ori), "struct_caption": list(struct)}
        return list(struct) if kind == "flan" else list(ori)

    @torch.no_grad()
    def get_learned_conditioning(self, c) -> torch.Tensor:
        """In fp32, per spec.cond_kind (maa3_tpu/system.py:371-400):
        clap_flan takes {'ori_caption', 'struct_caption'} or list[str] ->
        (B, 154, 1024); flan and clap take list[str] -> (B, 77, 1024); the
        video conditioners take (B, Lv, 512) features -> (B, Lv, context). A
        dict given to flan or clap raises TypeError: JAX's list(c) of it
        encodes the dict's two keys as captions."""
        kind = self.spec.cond_kind
        if self.cond is None:
            raise ValueError("this system has no conditioner (init_cond=False "
                             "and none in the checkpoint)")
        if kind.startswith("video_feat"):
            return video_feat_encoder_apply(
                self.cond, torch.as_tensor(c, dtype=torch.float32, device=self.device))
        if kind != "clap_flan" and isinstance(c, dict):
            raise TypeError(f"the {kind} conditioner takes a list of captions, "
                            f"not a dict (see MAA3System.captions)")
        return clap_flan_encode_batch(self.cond, self.tokenize(c))

    # -- sampling ----------------------------------------------------------

    @property
    def moe(self) -> bool:
        return self.spec.backbone_kind == "video_moe_dit"

    def _serving_cfg(self):
        """The DiT config the samplers run: in bf16 the text DiT carries its
        residual stream in fp32; the MoE has no such knob
        (maa3_tpu/system.py:421-432)."""
        cfg = self.dit.cfg
        if self.compute_dtype == torch.bfloat16 and not self.moe:
            cfg = dataclasses.replace(cfg, fp32_residual=True)
        return cfg

    def set_serving_quant(self, mode: Optional[str]) -> None:
        """None (bf16 / fp32 by compute_dtype) or an int8 mode
        "int8[:g<N>][,now2][,voc|,novoc][,smooth]" (maa3_tpu/system.py:332):
        w8a8 per-step DiT GEMMs; g<N> per-group scales, now2 keeps w2 float,
        voc also quantizes the wide vocoder convs, smooth needs
        calibrate_smooth first. Raises ValueError on any other string."""
        if mode is not None:
            _parse_quant_mode(mode)
        self.serve_quant = mode
        self._serving_dit = self._serving_voc = None

    def shard_serving(self, mesh) -> None:
        """Tensor- and expert-parallel serving (maa3_tpu/system.py:319): over a
        ("data", "model") mesh (parallel/mesh.py make_mesh) the serving DiT
        becomes this rank's Megatron shards over "model" (parallel/tp.py
        shard_serving_dit_; bf16 and every int8 mode, the int8 copy quantized
        before it is sharded; the video MoE's experts by the same column /
        row rules); over a ("data", "model", "expert") mesh (make_moe_mesh)
        the video MoE also keeps only this rank's experts (add_ep_specs,
        maa3_tpu/system.py:307-315; a text DiT's expert coordinates are
        replicas, as in JAX). sample_cfg splits its batch rows over
        "data", gathering the latents, so it returns what one device
        returns. None: back to one device."""
        self._serving_mesh = mesh
        self._serving_dit = None

    def calibrate_smooth(self, cond: torch.Tensor, uncond: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         timesteps: int = 25, scale: float = 5.0, shape=None,
                         x0: Optional[torch.Tensor] = None) -> None:
        """SmoothQuant calibration for int8:smooth (maa3_tpu/system.py:346):
        one CFG ODE of the canonical DiT from x0 (drawn from `generator` when
        not given) records the per-(block, channel) amax of the quantized-GEMM
        inputs; the next serving copy migrates its weights by them."""
        if self.moe:
            raise NotImplementedError(
                "smooth migration targets the text DiT serving path")
        from maa3_tpu_torch.ops.quant import calibrate_dit_smooth
        if x0 is None:
            if shape is None:
                shape = (cond.shape[0], self.spec.mel_dim, self.spec.mel_length)
            x0 = torch.randn(shape, generator=generator, device=self.device)
        self._smooth_stats = calibrate_dit_smooth(
            with_cfg(self.dit, self._serving_cfg()), x0, cond, uncond,
            guidance_scale=scale, steps=timesteps, compute_dtype=self.compute_dtype)
        self._serving_dit = None

    def serving_dit(self) -> nn.Module:
        """The DiT as the sampler runs it (maa3_tpu/system.py:259-317): with an
        int8 mode the quantized copy (models/dit.py quant_serving_copy), in
        bf16 a serving copy, in fp32 the DiT itself; rebuilt whenever the mode
        or a canonical parameter changed."""
        mesh = self._serving_mesh
        tp = mesh is not None and mesh.n_model > 1
        ep = mesh is not None and mesh.n_expert > 1 and self.moe  # the text DiT has no experts
        if (self.serve_quant is None and self.compute_dtype == torch.float32
                and not tp and not ep):
            return self.dit
        key = (_versions(self.dit), self.serve_quant, id(self._smooth_stats), id(mesh))
        if self._serving_dit is None or self._serving_key != key:
            with trace.span("serve.serving_copy"):
                self._serving_dit = self._build_serving_dit(tp, ep, mesh)
            self._serving_key = key
        return self._serving_dit

    def _build_serving_dit(self, tp: bool, ep: bool, mesh) -> nn.Module:
        if self.serve_quant:
            group, skip_w2, _, smooth = _parse_quant_mode(self.serve_quant)
            if smooth and self._smooth_stats is None:
                raise RuntimeError(
                    "serve_quant 'int8:smooth' needs activation stats - call "
                    "system.calibrate_smooth(cond, uncond) once before sampling")
            s = quant_serving_copy(self.dit, group, skip_w2,
                                   self._smooth_stats if smooth else None)
        else:  # bf16; or fp32 under TP / EP: the fused layout, fp32 weights
            s = serving_copy(self.dit, self.compute_dtype)
        s.cfg = self._serving_cfg()
        if tp or ep:
            from maa3_tpu_torch.parallel.tp import EP, TP, shard_serving_dit_
            shard_serving_dit_(s, TP.of(mesh),
                               EP.of(mesh, s.cfg.num_experts) if ep else None)
        return s

    def velocity_fn(self, dit: nn.Module):
        """velocity(x, t_int, context) of `dit` in the compute dtype, as the
        system's unplanned samplers run it (maa3_tpu/system.py:404): the MoE
        through moe_dit_apply, the text DiT under the serving config."""
        if self.moe:
            return lambda x, t, c: moe_dit_apply(dit, x, t, c, self.compute_dtype)
        d = with_cfg(dit, self._serving_cfg())
        return lambda x, t, c: dit_apply(d, x, t, c, compute_dtype=self.compute_dtype)

    @torch.no_grad()
    def sample_cfg(self, cond: torch.Tensor, scale: float, uncond: torch.Tensor,
                   generator: Optional[torch.Generator] = None, shape=None,
                   timesteps: int = 25, cond_mask=None, uncond_mask=None,
                   x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Planned CFG ODE; x0 (B, C, L) overrides generator/shape. The video
        MoE takes no context masks (ValueError)."""
        if cond_mask is not None and self.moe:
            raise ValueError("context masks are not supported for the video "
                             "MoE backbone (fixed-length features)")
        if x0 is None:
            if shape is None:
                shape = (cond.shape[0], self.spec.mel_dim, self.spec.mel_length)
            x0 = torch.randn(shape, generator=generator, device=self.device)
        mesh = self._serving_mesh
        if mesh is not None and mesh.n_data > 1:
            return self._sample_data_parallel(x0, cond, uncond, scale, timesteps,
                                              cond_mask, uncond_mask)
        return sample_planned(self.serving_dit(), x0.float(), cond, uncond, scale,
                              timesteps, cond_mask, uncond_mask,
                              self.compute_dtype, self.spec.timesteps)

    def _sample_data_parallel(self, x0, cond, uncond, scale, timesteps,
                              cond_mask, uncond_mask) -> torch.Tensor:
        """sample_cfg over the mesh's data ranks: every rank holds the whole
        batch (the same noise and conditioning), samples its rows (the batch
        padded to a multiple of n_data by repeating its last row) and the
        latents are all-gathered."""
        from maa3_tpu_torch.parallel.mesh import all_gather_dim, local_slice
        mesh = self._serving_mesh
        b, n = x0.shape[0], mesh.n_data
        pad = -b % n

        def mine(t):
            if t is None:
                return None
            if pad:
                t = torch.cat([t, t[-1:].expand((pad,) + tuple(t.shape[1:]))])
            return local_slice(t, 0, mesh.data_rank, n)

        z = sample_planned(self.serving_dit(), mine(x0.float()), mine(cond),
                           mine(uncond), scale, timesteps, mine(cond_mask),
                           mine(uncond_mask), self.compute_dtype, self.spec.timesteps)
        return all_gather_dim(z, 0, mesh.data_group, n)[:b]

    @torch.no_grad()
    def sample(self, cond: torch.Tensor, generator: Optional[torch.Generator] = None,
               shape=None, timesteps: int = 25,
               x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Euler ODE without guidance (maa3_tpu/system.py:544) through the
        serving DiT; x0 (B, C, L) overrides generator/shape."""
        if x0 is None:
            if shape is None:
                shape = (cond.shape[0], self.spec.mel_dim, self.spec.mel_length)
            x0 = torch.randn(shape, generator=generator, device=self.device)
        return cfm.sample(self.velocity_fn(self.serving_dit()), x0.float(), cond,
                          steps=timesteps, num_timesteps=self.spec.timesteps)

    # -- first stage / vocoder --------------------------------------------

    def _pipeline(self) -> T2APipeline:
        return T2APipeline(self.dit, self.vae, self.serving_vocoder(),
                           self.scale_factor, self.compute_dtype)

    def serving_vocoder(self) -> BigVGAN:
        """The vocoder as vocode runs it: under an int8 mode with `voc`, a copy
        whose wide-stage resblock convs are int8 (quantize_bigvgan), rebuilt
        when the mode or a vocoder parameter changed
        (maa3_tpu/system.py:582-595)."""
        if not self.serve_quant or not _parse_quant_mode(self.serve_quant)[2]:
            return self.vocoder
        key = _versions(self.vocoder)
        if self._serving_voc is None or self._serving_voc_key != key:
            self._serving_voc, self._serving_voc_key = quantize_bigvgan(self.vocoder), key
        return self._serving_voc

    @torch.no_grad()
    def encode_first_stage(self, mel: torch.Tensor,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mel (B, 80, T) -> the scaled latent (B, embed_dim, T/2)
        (maa3_tpu/system.py:560): the posterior mean, or a sample drawn from
        `generator` when one is given. The encode runs in fp32 without TF32,
        as the training step runs it."""
        with full_fp32():
            moments = vae_encode_moments(self.vae, mel.float())
            z = (gaussian_sample(moments, generator) if generator is not None
                 else moments.chunk(2, dim=1)[0])
        return z * self.scale_factor

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """fp32 decode even when serving in bf16."""
        return self._pipeline().decode_mel(z)

    def vocode(self, mel: torch.Tensor) -> np.ndarray:
        return self._pipeline().vocode(mel).float().cpu().numpy()

"""MAA3System: config, weights, conditioning, sampling and decoding in one
runtime object (counterpart of maa3_tpu/system.py: text-to-audio and
text-to-music).

Weights come from a seed, from the reference's Lightning `.ckpt` (with its
vocoder directory), or from a checkpoint of the port's own Trainer
(`from_config(ckpt_path=, vocoder_dir=)`). Serving in bf16 runs a serving
copy of the DiT (matmul weights rounded to bf16, q/k/v and w1/w3 fused)
with the residual stream carried in fp32 (system.py:421-433); the VAE
decodes in fp32; the vocoder runs in the compute dtype through the K1/K2
kernels on CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from maa3_tpu_torch import config as config_mod
from maa3_tpu_torch import torch_import
from maa3_tpu_torch.config import ModelSpec
from maa3_tpu_torch.data.tokenizers import load_tokenizer
from maa3_tpu_torch.diffusion import cfm
from maa3_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, bigvgan_init_
from maa3_tpu_torch.models.clap import (COND_MODULES, CLAPFLANConfig,
                                        clap_flan_encode_batch, clap_flan_init_)
from maa3_tpu_torch.models.dit import (DiT, dit_apply, dit_init_, serving_copy,
                                       unfreeze_zero_init)
from maa3_tpu_torch.models.vae1d import (AutoencoderKL, gaussian_sample,
                                         vae_encode_moments, vae_init_)
from maa3_tpu_torch.ops.flash_attention import MAX_HEAD_DIM
from maa3_tpu_torch.pipeline import T2APipeline, full_fp32, sample_planned

# a vocoder directory's generator file: the first of these names it holds
# (maa3_tpu/system.py:189-190)
VOCODER_FILES = ("generator.pt", "generator.pth", "g_02500000", "g_02500000.pth",
                 "bigvgan_generator.pt", "best_netG.pt")


def check_limits(spec: ModelSpec, device, latent_len: Optional[int] = None) -> None:
    """Refuse, before any launch, a config whose serving route the card's
    kernels cannot run: a DiT head dim above the flash kernels' MAX_HEAD_DIM
    where the DiT sends self-attention to flash at latent_len (default: the
    config's latent length; models/dit.py resolve_flash)."""
    cfg = spec.dit
    n = spec.mel_length if latent_len is None else latent_len
    if (torch.device(device).type == "cuda" and cfg.head_dim > MAX_HEAD_DIM
            and cfg.flash_for_len(n)):
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
    def __init__(self, spec: ModelSpec, dit: DiT, vae: AutoencoderKL,
                 vocoder: BigVGAN, cond: Optional[nn.Module],
                 scale_factor: float = 1.0,
                 tokenizer_dir: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.bfloat16):
        """cond: the conditioner of spec.cond_kind (COND_MODULES), or None."""
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
            dit = DiT(spec.dit)
            vae = AutoencoderKL(spec.vae)
            cond = COND_MODULES[spec.cond_kind](clap_cfg or CLAPFLANConfig()) \
                if has_cond else None
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
            mods = {"dit": DiT(spec.dit), "vae": AutoencoderKL(spec.vae),
                    "vocoder": BigVGAN(voc_cfg),
                    "cond": COND_MODULES[spec.cond_kind](clap_cfg)}
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
        (B, 154, 1024); flan and clap take list[str] -> (B, 77, 1024). A dict
        given to flan or clap raises TypeError: JAX's list(c) of it encodes
        the dict's two keys as captions."""
        kind = self.spec.cond_kind
        if self.cond is None:
            raise ValueError("this system has no conditioner (init_cond=False "
                             "and none in the checkpoint)")
        if kind != "clap_flan" and isinstance(c, dict):
            raise TypeError(f"the {kind} conditioner takes a list of captions, "
                            f"not a dict (see MAA3System.captions)")
        return clap_flan_encode_batch(self.cond, self.tokenize(c))

    # -- sampling ----------------------------------------------------------

    def serving_dit(self) -> DiT:
        """The DiT as the sampler runs it: in bf16 a serving copy with an
        fp32 residual, rebuilt whenever a canonical parameter changed."""
        if self.compute_dtype == torch.float32:
            return self.dit
        key = (id(self.dit), tuple(p._version for p in self.dit.parameters()))
        if self._serving_dit is None or self._serving_key != key:
            s = serving_copy(self.dit, self.compute_dtype)
            s.cfg = dataclasses.replace(s.cfg, fp32_residual=True)
            self._serving_dit, self._serving_key = s, key
        return self._serving_dit

    @torch.no_grad()
    def sample_cfg(self, cond: torch.Tensor, scale: float, uncond: torch.Tensor,
                   generator: Optional[torch.Generator] = None, shape=None,
                   timesteps: int = 25, cond_mask=None, uncond_mask=None,
                   x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Planned CFG ODE; x0 (B, C, L) overrides generator/shape."""
        if x0 is None:
            if shape is None:
                shape = (cond.shape[0], self.spec.mel_dim, self.spec.mel_length)
            x0 = torch.randn(shape, generator=generator, device=self.device)
        return sample_planned(self.serving_dit(), x0.float(), cond, uncond, scale,
                              timesteps, cond_mask, uncond_mask,
                              self.compute_dtype, self.spec.timesteps)

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
        dit = self.serving_dit()

        def velocity(x, t, c):
            return dit_apply(dit, x, t, c, compute_dtype=self.compute_dtype)

        return cfm.sample(velocity, x0.float(), cond, steps=timesteps,
                          num_timesteps=self.spec.timesteps)

    # -- first stage / vocoder --------------------------------------------

    def _pipeline(self) -> T2APipeline:
        return T2APipeline(self.dit, self.vae, self.vocoder, self.scale_factor,
                           self.compute_dtype)

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

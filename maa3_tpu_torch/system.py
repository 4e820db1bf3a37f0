"""MAA3System: config, weights, conditioning, sampling and decoding in one
runtime object (counterpart of maa3_tpu/system.py, text-to-audio path).

Serving in bf16 runs a serving copy of the DiT (matmul weights rounded to
bf16, q/k/v and w1/w3 fused) with the residual stream carried in fp32
(system.py:421-433); the VAE decodes in fp32; the vocoder runs in the
compute dtype through the K1/K2 kernels on CUDA.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from maa3_tpu_torch import config as config_mod
from maa3_tpu_torch.config import ModelSpec
from maa3_tpu_torch.data.tokenizers import load_tokenizer
from maa3_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, bigvgan_init_
from maa3_tpu_torch.models.clap import (CLAPFLAN, CLAPFLANConfig,
                                        clap_flan_encode_batch, clap_flan_init_)
from maa3_tpu_torch.models.dit import (DiT, dit_init_, serving_copy,
                                       unfreeze_zero_init)
from maa3_tpu_torch.models.vae1d import AutoencoderKL, vae_init_
from maa3_tpu_torch.pipeline import T2APipeline, sample_planned


class MAA3System:
    def __init__(self, spec: ModelSpec, dit: DiT, vae: AutoencoderKL,
                 vocoder: BigVGAN, cond: CLAPFLAN,
                 scale_factor: float = 1.0,
                 tokenizer_dir: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.spec = spec
        self.dit, self.vae, self.vocoder, self.cond = dit, vae, vocoder, cond
        for m in (dit, vae, vocoder, cond):  # inference only
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
                    tokenizer_dir: Optional[str] = None) -> "MAA3System":
        """Random init on `device` from a torch.Generator seeded with `seed`.
        unfreeze=True makes the DiT's zero-init adaLN, final layer and
        gates nonzero (a random-init DiT is otherwise an identity)."""
        spec = config_mod.parse_model_config(
            config_mod.load_config(config_paths, overrides))
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.device(device):
            dit = DiT(spec.dit)
            vae = AutoencoderKL(spec.vae)
            voc = BigVGAN(voc_cfg or BigVGANConfig())
            cond = CLAPFLAN(clap_cfg or CLAPFLANConfig())
        dit_init_(dit, gen)
        if unfreeze:
            unfreeze_zero_init(dit, gen)
        return cls(spec, dit, vae_init_(vae, gen), bigvgan_init_(voc, gen),
                   clap_flan_init_(cond, gen), spec.scale_factor,
                   tokenizer_dir, compute_dtype)

    @classmethod
    def from_state_dicts(cls, spec: ModelSpec, state: Dict[str, dict],
                         voc_cfg: BigVGANConfig, clap_cfg: CLAPFLANConfig,
                         scale_factor: float = 1.0, device="cuda",
                         compute_dtype: torch.dtype = torch.bfloat16,
                         tokenizer_dir: Optional[str] = None) -> "MAA3System":
        """Build from {dit, vae, vocoder, cond} state dicts with the
        reference keys (e.g. weights.params_from_jax)."""
        with torch.device(device):
            mods = {"dit": DiT(spec.dit), "vae": AutoencoderKL(spec.vae),
                    "vocoder": BigVGAN(voc_cfg), "cond": CLAPFLAN(clap_cfg)}
        for k, m in mods.items():
            m.load_state_dict(state[k])
        return cls(spec, mods["dit"], mods["vae"], mods["vocoder"], mods["cond"],
                   scale_factor, tokenizer_dir, compute_dtype)

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

    @torch.no_grad()
    def get_learned_conditioning(self, c) -> torch.Tensor:
        """c: as for `tokenize` -> (B, 154, 1024) context, computed in fp32."""
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

    # -- first stage / vocoder --------------------------------------------

    def _pipeline(self) -> T2APipeline:
        return T2APipeline(self.dit, self.vae, self.vocoder, self.scale_factor,
                           self.compute_dtype)

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """fp32 decode even when serving in bf16."""
        return self._pipeline().decode_mel(z)

    def vocode(self, mel: torch.Tensor) -> np.ndarray:
        return self._pipeline().vocode(mel).float().cpu().numpy()

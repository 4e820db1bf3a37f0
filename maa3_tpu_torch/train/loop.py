"""Trainer for one device (counterpart of maa3_tpu/train/loop.py, the
text-to-audio DiT with a frozen conditioner).

- lr = base_learning_rate * batch_size (main.py:786-790, one process);
- the latent std rescale on the first batch when the config asks for it
  (ddpm_audio.py:88-103);
- global-norm clip 1.0, AdamW, LambdaLinear warm-up, optional EMA;
- per-step metrics printed and appended to <ckpt_dir>/metrics.jsonl.

The conditioner (CLAP + FLAN-T5) is frozen: `prepare_batch` encodes the
captions outside the step. A config that trains it (cond_stage_trainable)
is refused. Checkpoints are not written yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from maa3_tpu_torch.models.vae1d import gaussian_sample, vae_encode_moments
from maa3_tpu_torch.train.optim import make_optimizer
from maa3_tpu_torch.train.step import create_train_state, make_eval_step, make_train_step


class Trainer:
    def __init__(self, system, batch_size: int = 16,
                 lr_multiplier: Optional[float] = None, use_ema: bool = False,
                 ema_decay: float = 0.9999, grad_clip: float = 1.0,
                 warm_up_steps: int = 10000, log_every: int = 50,
                 ckpt_dir: str = "logs/ckpt", train_cond: Optional[bool] = None):
        """system: MAA3System (config, DiT, VAE, conditioner, tokenizers).
        Trains system.dit in place, in system.compute_dtype."""
        self.system = system
        self.spec = system.spec
        self.log_every = log_every
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        train_cond = self.spec.cond_stage_trainable if train_cond is None else train_cond
        if train_cond:
            raise ValueError("training the conditioner is not ported: pass "
                             "train_cond=False or model.params."
                             "cond_stage_trainable=false")
        self.device = system.device
        system.dit.requires_grad_(True)
        lr_mult = lr_multiplier if lr_multiplier is not None else batch_size
        optimizer = make_optimizer(system.dit.parameters(),
                                   self.spec.base_learning_rate, lr_mult,
                                   warm_up_steps, grad_clip)
        self.state = create_train_state(system.dit, system.vae, optimizer,
                                        use_ema, self.spec.scale_factor)
        cdt = system.compute_dtype
        self._train_step = make_train_step(self.spec.timesteps, ema_decay, cdt)
        self._eval_step = make_eval_step(self.spec.timesteps, cdt)
        self._scale_by_std_done = not self.spec.scale_by_std
        self._metrics_path = os.path.join(self.ckpt_dir, "metrics.jsonl")
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def prepare_batch(self, raw: dict) -> Dict[str, torch.Tensor]:
        """Collated host batch -> device tensors: mel or moments, and the
        frozen conditioner's context for the captions."""
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        batch = ({"moments": dev(raw["moments"])} if "moments" in raw
                 else {"mel": dev(raw["image"])})
        if "context" in raw:
            batch["context"] = dev(raw["context"])
        else:
            batch["context"] = self.system.get_learned_conditioning(raw["caption"]).float()
        return batch

    @torch.no_grad()
    def maybe_rescale_by_std(self, batch: Dict[str, torch.Tensor],
                             generator: torch.Generator) -> None:
        if self._scale_by_std_done:
            return
        moments = (batch["moments"] if "moments" in batch
                   else vae_encode_moments(self.state.vae, batch["mel"]))
        z = gaussian_sample(moments, generator)
        scale = 1.0 / float(z.flatten().std(correction=0))
        print(f"### USING STD-RESCALING: scale_factor = {scale:.5f} ###")
        self.state.scale_factor = scale
        self.system.scale_factor = scale
        self._scale_by_std_done = True

    def fit(self, loader: Iterable[dict], max_steps: int = 1000,
            seed: int = 0) -> Dict[str, float]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        step0 = self.state.step
        t_start = time.time()
        last: Dict[str, float] = {}
        if max_steps <= 0:
            return last
        for raw in loader:
            batch = self.prepare_batch(raw)
            self.maybe_rescale_by_std(batch, gen)
            metrics = self._train_step(self.state, batch, gen)
            step = self.state.step
            done = step - step0 >= max_steps
            if step % self.log_every == 0 or done:
                last = {k: float(v) for k, v in metrics.items()}
                last["step"] = step
                last["steps_per_sec"] = (step - step0) / max(time.time() - t_start, 1e-9)
                if self.device.type == "cuda":
                    last["peak_memory_gib"] = torch.cuda.max_memory_allocated(
                        self.device) / 2 ** 30
                self._log(last)
            if done:  # before drawing another batch from the loader
                break
        return last

    def evaluate(self, loader: Iterable[dict], max_batches: int = 50,
                 seed: int = 0) -> Dict[str, float]:
        """Mean CFM validation loss over up to max_batches batches."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        losses = []
        for i, raw in enumerate(loader):
            if i >= max_batches:
                break
            losses.append(self._eval_step(self.state, self.prepare_batch(raw), gen))
        mean = float(torch.stack(losses).mean()) if losses else float("nan")
        metrics = {"val/loss_simple": mean, "val/batches": float(len(losses))}
        self._log(metrics | {"step": self.state.step})
        return metrics

    def _log(self, metrics: Dict[str, float]) -> None:
        print("  ".join(f"{k}={v:.5g}" for k, v in metrics.items()), flush=True)
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(metrics) + "\n")

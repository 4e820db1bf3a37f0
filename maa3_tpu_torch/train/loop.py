"""Trainer for one device (counterpart of maa3_tpu/train/loop.py, the
text-to-audio DiT with the CLAP+FLAN conditioner).

- lr = base_learning_rate * batch_size (main.py:786-790, one process);
- the latent std rescale on the first batch when the config asks for it
  (ddpm_audio.py:88-103);
- global-norm clip 1.0, AdamW, LambdaLinear warm-up, optional EMA, over the
  DiT and, when the config trains the cond stage (cond_stage_trainable, as
  every YAML in configs/ does), the conditioner too: `prepare_batch` then
  hands the step the captions' tokens and the step encodes them under
  autograd; otherwise the frozen conditioner encodes them outside the step;
- per-step metrics printed and appended to <ckpt_dir>/metrics.jsonl;
- checkpoints every `ckpt_every` steps (the newest `keep_last_k` kept), a
  `crash` checkpoint when a step raises, tagged saves (`last`, `usr1`), and
  `restore_checkpoint`.

Each step's random draws come from a generator seeded with (seed, step), so a
run resumed from a checkpoint draws what the uninterrupted run would have.

Checkpoints are `torch.save` files of the port's own layout: the JAX
package's Orbax checkpoints cannot be read here, nor these there.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from maa3_tpu_torch.models.clap import clap_flan_encode_batch
from maa3_tpu_torch.train.optim import make_optimizer
from maa3_tpu_torch.train.step import (create_train_state, make_eval_step,
                                       make_train_step, sample_latent)


class Trainer:
    def __init__(self, system, batch_size: int = 16,
                 lr_multiplier: Optional[float] = None, use_ema: bool = False,
                 ema_decay: float = 0.9999, grad_clip: float = 1.0,
                 warm_up_steps: int = 10000, log_every: int = 50,
                 ckpt_every: int = 2000, ckpt_dir: str = "logs/ckpt",
                 train_cond: Optional[bool] = None):
        """system: MAA3System (config, DiT, VAE, conditioner, tokenizers).
        Trains system.dit (and system.cond with train_cond, which defaults to
        the config's cond_stage_trainable) in place, in system.compute_dtype.
        ckpt_every=0 writes no periodic checkpoint."""
        self.system = system
        self.spec = system.spec
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.train_cond = (self.spec.cond_stage_trainable if train_cond is None
                           else train_cond)
        self.device = system.device
        cond = system.cond if self.train_cond else None
        trainable = [system.dit] + ([cond] if cond is not None else [])
        for m in trainable:
            m.requires_grad_(True)
        lr_mult = lr_multiplier if lr_multiplier is not None else batch_size
        # one AdamW and one global-norm clip over the DiT and the conditioner
        optimizer = make_optimizer([p for m in trainable for p in m.parameters()],
                                   self.spec.base_learning_rate, lr_mult,
                                   warm_up_steps, grad_clip)
        self.state = create_train_state(system.dit, system.vae, optimizer, use_ema,
                                        self.spec.scale_factor, cond=cond)
        conditioner = clap_flan_encode_batch if self.train_cond else None
        cdt = system.compute_dtype
        self._train_step = make_train_step(self.spec.timesteps, ema_decay, cdt,
                                           conditioner)
        self._eval_step = make_eval_step(self.spec.timesteps, cdt, conditioner)
        self._scale_by_std_done = not self.spec.scale_by_std
        self._metrics_path = os.path.join(self.ckpt_dir, "metrics.jsonl")
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def prepare_batch(self, raw: dict) -> Dict[str, torch.Tensor]:
        """Collated host batch -> device tensors: mel or moments, and the
        batch's `context` if it carries one, else the captions' tokens for
        the trainable conditioner, else the frozen conditioner's context."""
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        batch = ({"moments": dev(raw["moments"])} if "moments" in raw
                 else {"mel": dev(raw["image"])})
        if "context" in raw:
            batch["context"] = dev(raw["context"])
        elif self.train_cond:
            batch.update(self.system.tokenize(raw["caption"]))
        else:
            batch["context"] = self.system.get_learned_conditioning(raw["caption"]).float()
        return batch

    def maybe_rescale_by_std(self, batch: Dict[str, torch.Tensor],
                             generator: torch.Generator) -> None:
        if self._scale_by_std_done:
            return
        z = sample_latent(self.state.vae, batch, generator)
        scale = 1.0 / float(z.flatten().std(correction=0))
        print(f"### USING STD-RESCALING: scale_factor = {scale:.5f} ###")
        self.state.scale_factor = scale
        self.system.scale_factor = scale
        self._scale_by_std_done = True

    def train_step(self, raw: dict, seed: int = 0,
                   draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """One step on a collated host batch; a `crash` checkpoint is saved
        if the step raises. draws replaces the generator's noise (tests)."""
        # seeded by (seed, step): a resumed run draws what the uninterrupted one would
        gen = torch.Generator(device=self.device).manual_seed(
            seed * 2 ** 32 + self.state.step)
        batch = self.prepare_batch(raw)
        self.maybe_rescale_by_std(batch, gen)
        try:
            return self._train_step(self.state, batch, gen, draws)
        except Exception:
            self.save_checkpoint(tag="crash")  # SetupCallback.on_exception
            raise

    def fit(self, loader: Iterable[dict], max_steps: int = 1000,
            seed: int = 0) -> Dict[str, float]:
        step0 = self.state.step
        t_start = time.time()
        last: Dict[str, float] = {}
        if max_steps <= 0:
            return last
        for raw in loader:
            metrics = self.train_step(raw, seed)
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
            if self.ckpt_every and step % self.ckpt_every == 0:
                self.save_checkpoint()
            if done:  # before drawing another batch from the loader
                break
        return last

    def sync_system_params(self) -> None:
        """Hand the trained modules to the system for serving (the modules are
        trained in place, so system.dit and system.cond already are them; the
        serving copy is rebuilt at the next sample, as system.serving_dit's
        version key sees the changed parameters)."""
        self.system.dit = self.state.dit
        if self.state.cond is not None:
            self.system.cond = self.state.cond
        self.system.scale_factor = self.state.scale_factor

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

    # -- checkpoints (torch format) ---------------------------------------

    def save_checkpoint(self, tag: Optional[str] = None, keep_last_k: int = 10) -> str:
        """Write <ckpt_dir>/<tag or step_%08d>.pt (maa3_tpu/train/loop.py:407):
        the trainable modules' parameters, the optimizer state, step,
        scale_factor, the EMA shadows and the frozen VAE. Periodic
        checkpoints keep the newest keep_last_k; tagged ones (last, crash,
        usr1) are never rotated. The file is written under a temporary name
        and renamed into place."""
        st = self.state
        name = tag or f"step_{st.step:08d}"
        path = os.path.join(self.ckpt_dir, name + ".pt")
        payload = {"params": {k: m.state_dict() for k, m in st.trainable().items()},
                   "opt_state": st.optimizer.adamw.state_dict(),
                   "step": st.step,
                   "scale_factor": st.scale_factor,
                   # the frozen first stage travels with the checkpoint: a
                   # restored DiT decoded through another VAE is garbage
                   "frozen": {"vae": st.vae.state_dict()}}
        if st.ema is not None:
            payload["ema_params"] = list(st.ema)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if tag is None and keep_last_k > 0:
            steps = sorted(f for f in os.listdir(self.ckpt_dir)
                           if f.startswith("step_") and f.endswith(".pt"))
            for old in steps[:-keep_last_k]:
                os.remove(os.path.join(self.ckpt_dir, old))
        return path

    def restore_checkpoint(self, path: str) -> None:
        """Load a checkpoint of save_checkpoint into this trainer, deciding
        from the keys the file holds: its trainable set must be this
        trainer's (DiT, with or without the conditioner), else it raises; a
        file without a `frozen` section keeps the current VAE; EMA shadows
        are restored when both the file and the trainer have them."""
        st = self.state
        payload = torch.load(path, map_location=self.device, weights_only=True)
        mods = st.trainable()
        if set(payload["params"]) != set(mods):
            raise ValueError(
                f"{path}: checkpoint trains {sorted(payload['params'])}, this "
                f"trainer trains {sorted(mods)} (cond_stage_trainable differs)")
        for k, m in mods.items():
            m.load_state_dict(payload["params"][k])
        st.optimizer.adamw.load_state_dict(payload["opt_state"])
        st.step = int(payload["step"])
        st.scale_factor = float(payload["scale_factor"])
        if "frozen" in payload:
            st.vae.load_state_dict(payload["frozen"]["vae"])
        else:
            print(f"{path}: no frozen VAE in the checkpoint; keeping the current one")
        if st.ema is not None and "ema_params" in payload:
            with torch.no_grad():
                for e, x in zip(st.ema, payload["ema_params"], strict=True):
                    e.copy_(x)
        self.system.scale_factor = st.scale_factor
        self._scale_by_std_done = True

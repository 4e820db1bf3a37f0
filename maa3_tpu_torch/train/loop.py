"""Trainer for one device (counterpart of maa3_tpu/train/loop.py, the
text-to-audio DiT with its text conditioner).

- lr = base_learning_rate * accum_steps * batch_size (main.py:786-790, one
  process);
- the latent std rescale on the first batch when the config asks for it
  (ddpm_audio.py:88-103);
- global-norm clip 1.0, AdamW (its first moment in `mu_dtype`; adafactor
  with `factored`), LambdaLinear warm-up, optional EMA, over the DiT and,
  when the config trains the cond stage (cond_stage_trainable, as every YAML
  in configs/ does), the conditioner too: `prepare_batch` then hands the
  step the captions' tokens and the step encodes them under autograd;
  otherwise the frozen conditioner encodes them outside the step;
- gradient accumulation over `accum_steps` micro-steps (optax.MultiSteps
  semantics, train/optim.py); `state.step`, the logs and the checkpoint
  cadence count micro-steps, as in JAX;
- `fuse_gemms`: the DiT trains in the fused layout (wqkv, w13) on a copy
  of system.dit; checkpoints and `sync_system_params` use the canonical
  names, so fused and unfused runs share files;
- per-step metrics printed, appended to <ckpt_dir>/metrics.jsonl, and
  written to TensorBoard (<ckpt_dir>/tb) when torch.utils.tensorboard
  imports;
- `fit(audio_logger=)` writes generated samples every N steps
  (train/audio_logger.py);
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
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from maa3_tpu_torch.models.clap import clap_flan_encode_batch
from maa3_tpu_torch.models.dit import fuse_dit_gemms, fuse_dit_state, unfuse_dit_gemms
from maa3_tpu_torch.train.optim import make_optimizer
from maa3_tpu_torch.train.step import (create_train_state, make_eval_step,
                                       make_train_step, sample_latent)


def _caps_from_batch(raw: dict) -> List[dict]:
    cap = raw.get("caption")
    if not isinstance(cap, dict):
        return []
    return [{"ori_caption": o, "struct_caption": s}
            for o, s in zip(cap.get("ori_caption", []), cap.get("struct_caption", []))]


class Trainer:
    def __init__(self, system, batch_size: int = 16,
                 lr_multiplier: Optional[float] = None, use_ema: bool = False,
                 ema_decay: float = 0.9999, grad_clip: float = 1.0,
                 warm_up_steps: int = 10000, log_every: int = 50,
                 ckpt_every: int = 2000, ckpt_dir: str = "logs/ckpt",
                 train_cond: Optional[bool] = None, accum_steps: int = 1,
                 mu_dtype: torch.dtype = torch.float32, fuse_gemms: bool = False,
                 factored: bool = False):
        """system: MAA3System (config, DiT, VAE, conditioner, tokenizers).
        Trains system.dit (a fused copy of it with fuse_gemms) and system.cond
        with train_cond, which defaults to the config's cond_stage_trainable,
        in place, in system.compute_dtype. accum_steps: optimizer updates every
        accum_steps micro-batches (accumulate_grad_batches); mu_dtype: the
        storage dtype of the first moment; factored: adafactor instead of
        AdamW. ckpt_every=0 writes no periodic checkpoint."""
        self.system = system
        self.spec = system.spec
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.train_cond = (self.spec.cond_stage_trainable if train_cond is None
                           else train_cond)
        self.accum_steps = max(1, accum_steps)
        self.fuse_gemms = fuse_gemms
        self.device = system.device
        cond = system.cond if self.train_cond else None
        dit = fuse_dit_gemms(system.dit) if fuse_gemms else system.dit
        trainable = [dit] + ([cond] if cond is not None else [])
        for m in trainable:
            m.requires_grad_(True)
        lr_mult = (lr_multiplier if lr_multiplier is not None
                   else self.accum_steps * batch_size)
        # one optimizer and one global-norm clip over the DiT and the conditioner
        optimizer = make_optimizer([p for m in trainable for p in m.parameters()],
                                   self.spec.base_learning_rate, lr_mult,
                                   warm_up_steps, grad_clip, mu_dtype=mu_dtype,
                                   factored=factored, accum_steps=self.accum_steps)
        self.state = create_train_state(dit, system.vae, optimizer, use_ema,
                                        self.spec.scale_factor, cond=cond)
        conditioner = clap_flan_encode_batch if self.train_cond else None
        cdt = system.compute_dtype
        self._train_step = make_train_step(self.spec.timesteps, ema_decay, cdt,
                                           conditioner)
        self._eval_step = make_eval_step(self.spec.timesteps, cdt, conditioner)
        self._scale_by_std_done = not self.spec.scale_by_std
        self._metrics_path = os.path.join(self.ckpt_dir, "metrics.jsonl")
        self._tb = None
        self._tb_failed = False
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

    def _generator(self, seed: int) -> torch.Generator:
        # seeded by (seed, step): a resumed run draws what the uninterrupted one would
        return torch.Generator(device=self.device).manual_seed(
            seed * 2 ** 32 + self.state.step)

    def train_step(self, raw: dict, seed: int = 0,
                   draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """One (micro-)step on a collated host batch; a `crash` checkpoint is
        saved if the step raises. draws replaces the generator's noise (tests)."""
        gen = self._generator(seed)
        batch = self.prepare_batch(raw)
        self.maybe_rescale_by_std(batch, gen)
        try:
            return self._train_step(self.state, batch, gen, draws)
        except Exception:
            self.save_checkpoint(tag="crash")  # SetupCallback.on_exception
            raise

    def fit(self, loader: Iterable[dict], max_steps: int = 1000, seed: int = 0,
            audio_logger=None, sample_captions: Optional[List[dict]] = None
            ) -> Dict[str, float]:
        """Up to max_steps (micro-)steps from loader. Every step the
        audio_logger asks for, the system takes the trained weights and the
        logger generates from sample_captions (else the batch's captions)."""
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
            if audio_logger is not None and audio_logger.should_log(step):
                self.sync_system_params()
                caps = sample_captions or _caps_from_batch(raw)
                if caps:
                    audio_logger.log_samples(self.system, step, caps,
                                             self._generator(seed))
            if done:  # before drawing another batch from the loader
                break
        return last

    def sync_system_params(self) -> None:
        """Hand the trained modules to the system for serving, in the
        canonical layout (maa3_tpu/train/loop.py:375-387): an unfused DiT and
        the conditioner are trained in place, so system.dit and system.cond
        already are them; a fused DiT's weights are split into system.dit's
        wq/wk/wv and w1/w3. The serving copy is rebuilt at the next sample, as
        system.serving_dit's version key sees the changed parameters."""
        st = self.state
        if self.fuse_gemms:
            canon = self._canonical_dit(dict(st.dit.named_parameters()))
            with torch.no_grad():
                for n, p in self.system.dit.named_parameters():
                    p.copy_(canon[n])
        else:
            self.system.dit = st.dit
        if st.cond is not None:
            self.system.cond = st.cond
        self.system.scale_factor = st.scale_factor

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
        if self._tb is None and not self._tb_failed:
            try:  # TensorBoard logger (main.py's default logger)
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(self.ckpt_dir, "tb"))
            except Exception as e:
                self._tb_failed = True
                print(f"TensorBoard not written ({type(e).__name__}: {e})", flush=True)
        if self._tb is not None:
            step = int(metrics.get("step", 0))
            for k, v in metrics.items():
                if k != "step":
                    self._tb.add_scalar(k if k.startswith("val/") else f"train/{k}", v, step)

    def close(self) -> None:
        """Flush and close the TensorBoard writer (and its thread)."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    # -- the canonical layout of checkpoints --------------------------------

    def _canonical_dit(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if not self.fuse_gemms:
            return tensors
        cfg = self.spec.dit
        return unfuse_dit_gemms(tensors, cfg.num_heads, cfg.n_kv_heads)

    def _canonical_ema(self, to_canonical: bool, ema: List[torch.Tensor]) -> List[torch.Tensor]:
        """EMA shadows in the trainer's parameter order -> in the canonical
        order (system.dit's parameters, then the conditioner's), or back."""
        if not self.fuse_gemms:
            return list(ema)
        mods = self.state.trainable()
        canon_dit = [n for n, _ in self.system.dit.named_parameters()]
        mine_dit = [n for n, _ in mods["dit"].named_parameters()]
        src, dst = (mine_dit, canon_dit) if to_canonical else (canon_dit, mine_dit)
        d = dict(zip(src, ema[:len(src)]))
        d = (self._canonical_dit(d) if to_canonical
             else fuse_dit_state(d, self.spec.dit.depth))
        return [d[n] for n in dst] + list(ema[len(src):])

    # -- checkpoints (torch format) ---------------------------------------

    def save_checkpoint(self, tag: Optional[str] = None, keep_last_k: int = 10) -> str:
        """Write <ckpt_dir>/<tag or step_%08d>.pt (maa3_tpu/train/loop.py:407):
        the trainable modules' parameters and EMA shadows in the canonical
        names, the optimizer state (moments, the gradients accumulated so
        far), fuse_gemms, step, scale_factor and the frozen VAE. Periodic
        checkpoints keep the newest keep_last_k; tagged ones (last, crash,
        usr1) are never rotated. The file is written under a temporary name
        and renamed into place."""
        st = self.state
        name = tag or f"step_{st.step:08d}"
        path = os.path.join(self.ckpt_dir, name + ".pt")
        params = {k: m.state_dict() for k, m in st.trainable().items()}
        params["dit"] = self._canonical_dit(params["dit"])
        payload = {"params": params,
                   "opt_state": st.optimizer.state_dict(),
                   "fuse_gemms": self.fuse_gemms,
                   "step": st.step,
                   "scale_factor": st.scale_factor,
                   # the frozen first stage travels with the checkpoint: a
                   # restored DiT decoded through another VAE is garbage
                   "frozen": {"vae": st.vae.state_dict()}}
        if st.ema is not None:
            payload["ema_params"] = self._canonical_ema(True, st.ema)
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
        from the keys the file holds: its trainable set, fuse_gemms and
        optimizer (AdamW or adafactor, first-moment dtype, accum_steps) must
        be this trainer's, else it raises before anything is loaded; a file
        without a `frozen` section keeps the current VAE; EMA shadows are
        restored when both the file and the trainer have them."""
        st = self.state
        payload = torch.load(path, map_location=self.device, weights_only=True)
        mods = st.trainable()
        if set(payload["params"]) != set(mods):
            raise ValueError(
                f"{path}: checkpoint trains {sorted(payload['params'])}, this "
                f"trainer trains {sorted(mods)} (cond_stage_trainable differs)")
        if bool(payload.get("fuse_gemms", False)) != self.fuse_gemms:
            raise ValueError(f"{path}: checkpoint of a trainer with fuse_gemms="
                             f"{payload.get('fuse_gemms', False)}, this trainer has "
                             f"fuse_gemms={self.fuse_gemms}")
        st.optimizer.load_state_dict(payload["opt_state"])
        for k, m in mods.items():
            sd = payload["params"][k]
            if k == "dit" and self.fuse_gemms:
                sd = fuse_dit_state(sd, self.spec.dit.depth)
            m.load_state_dict(sd)
        st.step = int(payload["step"])
        st.scale_factor = float(payload["scale_factor"])
        if "frozen" in payload:
            st.vae.load_state_dict(payload["frozen"]["vae"])
        else:
            print(f"{path}: no frozen VAE in the checkpoint; keeping the current one")
        if st.ema is not None and "ema_params" in payload:
            with torch.no_grad():
                for e, x in zip(st.ema, self._canonical_ema(False, payload["ema_params"]),
                                strict=True):
                    e.copy_(x)
        self.system.scale_factor = st.scale_factor
        self._scale_by_std_done = True

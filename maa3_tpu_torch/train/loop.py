"""Trainer (counterpart of maa3_tpu/train/loop.py: the text-to-audio DiT
with its text conditioner, and the video MoE DiT with its video feature
encoder, trained through moe_dit_apply(training=True) on batches with
`video_feat`, as maa3_tpu/train/loop.py:217-222 and :290-291), on one
device or over a mesh of torch.distributed ranks (parallel/mesh.py):

- data parallelism: `batch_size` is the batch of a node (JAX's per-host
  batch); each data rank of the node takes its rows of it, and draws the
  posterior noise, the timesteps and the flow noise of the whole global
  batch from the step's shared (seed, step) generator and takes its rows,
  so the step is the one-device step on the global batch. The replicated
  gradients are averaged over the data ranks;
- fsdp: ZeRO-3 over the data ranks (parallel/fsdp.py, add_fsdp_specs'
  placements); a no-op on a data dim of width 1, as in JAX;
- n_model: Megatron tensor parallelism (parallel/tp.py) of the text DiT,
  with seq_parallel its sequence parallelism, and of the video MoE;
  fuse_gemms raises with it, as in JAX. JAX falls back to n_model = 1 when
  the device count does not divide; the port raises;
- n_pipe, n_micro: GPipe over a ("data", "pipe", "model") mesh
  (parallel/pipeline.py): each stage holds depth / n_pipe blocks, and the
  train and eval steps run n_micro microbatches through the pipelined
  apply; n_micro without n_pipe > 1 is a no-op, as in JAX. It refuses fsdp,
  fuse_gemms, seq_parallel and the video MoE with JAX's messages;
- n_expert: expert parallelism of the video MoE over a ("data", "model",
  "expert") mesh (each rank holds E / n_expert experts of each stack,
  models/dit_moe.py); it composes with n_model and fsdp and refuses the
  text DiT, n_pipe > 1 and fuse_gemms, as JAX does;
- the global-norm clip is taken over the whole model: every rank's squared
  norms, each replicated tensor counted once (a block's or an expert's by
  the coordinate owning it), summed over the world;
- lr = base_learning_rate * accum_steps * nodes * batch_size
  (main.py:786-790: base_lr * accum * global batch);
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
- with tracing on (maa3_tpu_torch/trace.py), `train.step` per iteration of
  `fit` (the step number), holding `train.loader_wait` (the loader's next),
  `train.prepare` (the host-to-device copies and tokens, and the first
  step's std rescale) and the step's own spans (train/step.py);
- checkpoints every `ckpt_every` steps (the newest `keep_last_k` kept), a
  `crash` checkpoint when a step raises, tagged saves (`last`, `usr1`), and
  `restore_checkpoint`.

Each step's random draws come from a generator seeded with (seed, step), so a
run resumed from a checkpoint draws what the uninterrupted run would have.

Checkpoints are `torch.save` files of the port's own layout; a JAX
Trainer's Orbax directory becomes one through orbax_to_torch.py (run where
JAX is installed), and restore_checkpoint given a directory raises a
ValueError naming it. The file
is the same at every world size: every rank gathers the whole state (the
shards over the data and the model groups, every stage's blocks and every
coordinate's experts) and rank 0 writes it;
`restore_checkpoint` loads any such file and takes this rank's shards.
Only rank 0 logs. A `crash` checkpoint is written at world size 1 only: the
other ranks may wait in a collective.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from maa3_tpu_torch import trace
from maa3_tpu_torch.models.clap import clap_flan_encode_batch, video_feat_encoder_apply
from maa3_tpu_torch.models.dit import fuse_dit_gemms, fuse_dit_state, unfuse_dit_gemms
from maa3_tpu_torch.models.dit_moe import moe_dit_apply
from maa3_tpu_torch.parallel import mesh as pmesh
from maa3_tpu_torch.parallel.fsdp import FSDP, average_grads
from maa3_tpu_torch.parallel.pipeline import dit_apply_pipelined
from maa3_tpu_torch.parallel.tp import EP, TP
from maa3_tpu_torch.torch_import import read_checkpoint
from maa3_tpu_torch.train.optim import make_optimizer
from maa3_tpu_torch.train.step import (create_train_state, make_eval_step,
                                       make_train_step, sample_latent)


# the optimizer's per-parameter state a checkpoint holds whole
OPT_STATE = ("mu", "nu", "acc", "v_row", "v_col", "v")


def _encode_video(cond, batch: dict) -> torch.Tensor:
    return video_feat_encoder_apply(cond, batch["video_feat"])


def _take_rows(raw: dict, lo: int, hi: int) -> dict:
    """Rows lo:hi of a collated batch (arrays, tensors, lists, and dicts of
    them such as the captions)."""
    def take(v):
        if isinstance(v, dict):
            return {k: take(x) for k, x in v.items()}
        return v[lo:hi]
    return {k: take(v) for k, v in raw.items()}


def _n_rows(raw: dict) -> int:
    for key in ("image", "moments", "video_feat", "context"):
        if key in raw:
            return len(raw[key])
    raise ValueError(f"no batch rows among {sorted(raw)}")


def sharded_norm(grads: List[torch.Tensor], weights: List[float]) -> torch.Tensor:
    """The global norm of the whole model's gradients from every rank's
    shards: each rank's squared norms weighted by 1 / (the ranks holding the
    same tensor), summed over the world."""
    sq = torch.stack([g.float().pow(2).sum() * w for g, w in zip(grads, weights)]).sum()
    dist.all_reduce(sq)
    return sq.sqrt()


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
                 factored: bool = False, n_model: int = 1, fsdp: bool = False,
                 fsdp_min_size: int = 65536, seq_parallel: bool = False,
                 n_pipe: int = 1, n_micro: int = 1, n_expert: int = 1,
                 mesh: Optional[pmesh.Mesh] = None):
        """system: MAA3System (config, DiT, VAE, conditioner, tokenizers).
        Trains system.dit (a fused copy of it with fuse_gemms) and system.cond
        with train_cond, which defaults to the config's cond_stage_trainable,
        in place, in system.compute_dtype. accum_steps: optimizer updates every
        accum_steps micro-batches (accumulate_grad_batches); mu_dtype: the
        storage dtype of the first moment; factored: adafactor instead of
        AdamW (the port's entry to JAX's make_optimizer(factored=True)).
        ckpt_every=0 writes no periodic checkpoint. batch_size: the batch of
        a node. n_model, fsdp (fsdp_min_size), seq_parallel, n_pipe,
        n_micro, n_expert: see the module's docstring; mesh: the mesh
        (default: make_pipe_mesh with n_pipe > 1, make_moe_mesh with
        n_expert > 1, else make_mesh, over the process group, which raise
        when the world cannot hold the shape). With sharded parameters
        system.dit holds this rank's shards until sync_system_params."""
        moe = system.spec.backbone_kind == "video_moe_dit"
        self.n_pipe, self.n_micro = max(1, n_pipe), max(1, n_micro)
        self.n_expert = max(1, n_expert)
        if self.n_expert > 1:
            if not moe:
                raise ValueError("n_expert>1 needs the video MoE backbone "
                                 "(the text DiT has no expert axis)")
            if self.n_pipe > 1 or fuse_gemms:
                raise ValueError("n_expert>1 is incompatible with n_pipe>1 and fuse_gemms")
        if self.n_pipe > 1:
            if fsdp:
                raise ValueError("n_pipe>1 + fsdp unsupported: FSDP's 'data' param shards "
                                 "conflict with the manual 'data' axis of the pipeline "
                                 "shard_map")
            if fuse_gemms:
                raise ValueError("n_pipe>1 requires the unfused GEMM layout")
            if seq_parallel:
                raise ValueError("n_pipe>1 + seq_parallel unsupported: the pipelined "
                                 "apply (parallel/pipeline.py) runs inside its own "
                                 "shard_map and does not place the Megatron SP sharding "
                                 "constraints — SP would be silently inert")
            if moe:
                raise ValueError("pipeline parallelism covers the text DiT backbone "
                                 "(the video MoE uses TP+DP)")
        elif self.n_micro > 1:
            print(f"n_micro={self.n_micro}: a no-op without n_pipe > 1 (as in JAX)",
                  flush=True)
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
        if mesh is None:
            if self.n_pipe > 1:
                mesh = pmesh.make_pipe_mesh(n_pipe=self.n_pipe, n_model=n_model)
            elif self.n_expert > 1:
                mesh = pmesh.make_moe_mesh(n_model=n_model, n_expert=self.n_expert)
            else:
                mesh = pmesh.make_mesh(n_model=n_model)
        self.mesh = mesh
        for axis, n in (("model", n_model), ("pipe", self.n_pipe), ("expert", self.n_expert)):
            if mesh.size(axis) != n:
                raise ValueError(f"n_{axis}={n} on a mesh of {mesh.shape}")
        self.is_main = pmesh.rank() == 0
        n_data = mesh.n_data
        self.fsdp = fsdp and n_data > 1
        if fsdp and not self.fsdp:
            print("fsdp: a no-op on a data dim of width 1 (as in JAX)", flush=True)
        self.sharded = n_model > 1 or self.fsdp or self.n_pipe > 1 or self.n_expert > 1
        if fuse_gemms and n_model > 1:
            raise ValueError("fuse_gemms training requires model-parallel size 1 "
                             "(the qkv concat axis does not align with TP shard "
                             "boundaries)")
        if batch_size % mesh.data_per_node:
            raise ValueError(f"batch_size {batch_size} (per node) does not divide over "
                             f"the node's {mesh.data_per_node} data ranks")
        cond = system.cond if self.train_cond else None
        dit = fuse_dit_gemms(system.dit) if fuse_gemms else system.dit
        if seq_parallel and n_model > 1 and not moe:
            dit.cfg = dataclasses.replace(dit.cfg, seq_parallel=True)
        mods = {"dit": dit} | ({"cond": cond} if cond is not None else {})
        names = [f"{k}.{n}" for k, m in mods.items() for n, _ in m.named_parameters()]
        # each trainable parameter's whole shape, placement and owner, in
        # trainable_parameters() order
        self._param_shapes = [tuple(p.shape) for m in mods.values() for p in m.parameters()]
        self.specs, self.owners = (self._shard(dit, fsdp_min_size) if self.sharded
                                   else ({}, {}))
        self._param_specs = [self.specs.get(n) for n in names]
        self._param_owners = [self.owners.get(n) for n in names]
        self._shapes = dict(zip(names, self._param_shapes))
        for m in mods.values():
            m.requires_grad_(True)
        lr_mult = (lr_multiplier if lr_multiplier is not None
                   else self.accum_steps * mesh.n_nodes * batch_size)
        # one optimizer and one global-norm clip over the DiT and the conditioner
        optimizer = make_optimizer([p for m in mods.values() for p in m.parameters()],
                                   self.spec.base_learning_rate, lr_mult,
                                   warm_up_steps, grad_clip, mu_dtype=mu_dtype,
                                   factored=factored, accum_steps=self.accum_steps,
                                   full_shapes=self._param_shapes,
                                   dim_groups=[self._dim_groups(sp) for sp in self._param_specs])
        self.state = create_train_state(dit, system.vae, optimizer, use_ema,
                                        self.spec.scale_factor, cond=cond)
        if pmesh.world_size() > 1:
            weights = []
            for spec, owner in zip(self._param_specs, self._param_owners):
                held = 1  # the ranks holding the same elements
                for axis in mesh.dim_names:
                    if (spec is None or axis not in spec) and (owner is None
                                                               or owner[0] != axis):
                        held *= mesh.size(axis)
                weights.append(1.0 / held)
            optimizer.norm_fn = functools.partial(sharded_norm, weights=weights)
        self.video = self.spec.cond_kind.startswith("video_feat")
        conditioner = None
        if self.train_cond:
            conditioner = (_encode_video if self.video else clap_flan_encode_batch)
        cdt = system.compute_dtype
        apply_fn = None
        if moe:
            def apply_fn(dit, x, t, c):
                return moe_dit_apply(dit, x, t, c, compute_dtype=cdt, training=True)
        elif self.n_pipe > 1:  # the train and the eval step (maa3_tpu/train/loop.py:453)
            def apply_fn(dit, x, t, c):
                return dit_apply_pipelined(dit, x, t, c, self.mesh, self.n_micro,
                                           compute_dtype=cdt, training=True)
        self._train_step = make_train_step(
            self.spec.timesteps, ema_decay, cdt, conditioner, apply_fn,
            grad_sync=self._average_grads if n_data > 1 else None)
        self._eval_step = make_eval_step(self.spec.timesteps, cdt, conditioner, apply_fn)
        self._scale_by_std_done = not self.spec.scale_by_std
        self._metrics_path = os.path.join(self.ckpt_dir, "metrics.jsonl")
        self._tb = None
        self._tb_failed = False
        os.makedirs(self.ckpt_dir, exist_ok=True)

    # -- parallelism -----------------------------------------------------------

    def _shard(self, dit, fsdp_min_size: int):
        """Shard the DiT in place: its model-parallel placements
        (dit_param_specs), ZeRO-3's data dim, and the stage or expert
        coordinate owning each block or expert tensor (the others drop
        it); returns the placements and the owners, by trainable name."""
        mesh = self.mesh
        named = dict(dit.named_parameters())
        # the model dims are taken at n_model 1 too, as in JAX, so that
        # FSDP picks the dims JAX's specs pick
        specs = pmesh.dit_param_specs(named)
        owners = {}
        if self.n_pipe > 1:
            owners = pmesh.add_pipe_specs(named, self.n_pipe)
        if self.n_expert > 1:
            owners = pmesh.add_ep_specs(named, self.n_expert)
        if self.fsdp:
            specs = pmesh.add_fsdp_specs(named, specs, mesh.n_data,
                                         min_size=fsdp_min_size)
        pmesh.free_unowned_(dit, owners, mesh)
        pmesh.shard_params_(dit, specs, mesh, ("model",))
        dit.tp = TP.of(mesh)
        if self.n_expert > 1:
            dit.ep = EP.of(mesh, dit.cfg.num_experts)
        if self.fsdp:
            dit.fsdp = FSDP(dit, specs, mesh)
        return ({"dit." + n: s for n, s in specs.items()},
                {"dit." + n: o for n, o in owners.items()})

    def _dim_groups(self, spec) -> Dict[int, tuple]:
        """The (process group, size) of each dim a placement shards."""
        out = {}
        for axis in ("model", "data"):
            d = None if spec is None else pmesh.spec_dim(spec, axis)
            if d is not None and self.mesh.size(axis) > 1:
                out[d] = (self.mesh.group(axis), self.mesh.size(axis))
        return out

    def _average_grads(self) -> None:
        """The data-parallel mean of the replicated gradients (FSDP shards
        were reduce-scattered in the backward)."""
        fs = getattr(self.state.dit, "fsdp", None)
        average_grads([p for p in self.state.trainable_parameters()
                       if fs is None or not fs.is_sharded(p)],
                      self.mesh.data_group, self.mesh.n_data)

    def _local_rows(self, raw: dict):
        """This data rank's rows of a node batch, and (lo, hi, n) of them in
        the global batch (None on one data rank)."""
        mesh = self.mesh
        if mesh.n_data == 1:
            return raw, None
        per = mesh.data_per_node
        n = _n_rows(raw)
        if n % per:
            raise ValueError(f"a batch of {n} rows does not divide over the node's "
                             f"{per} data ranks")
        k = n // per
        lo = (mesh.data_rank % per) * k
        if per > 1:
            raw = _take_rows(raw, lo, lo + k)
        return raw, (mesh.data_rank * k, (mesh.data_rank + 1) * k, k * mesh.n_data)

    def _data_mean(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh.n_data == 1:
            return t
        t = t.detach().clone()
        dist.all_reduce(t, group=self.mesh.data_group)
        return t / self.mesh.n_data

    def prepare_batch(self, raw: dict) -> Dict[str, torch.Tensor]:
        """Collated host batch -> device tensors: mel or moments, and the
        batch's `context` if it carries one, else the captions' tokens (the
        video features of a video system) for the trainable conditioner,
        else the frozen conditioner's context."""
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        batch = ({"moments": dev(raw["moments"])} if "moments" in raw
                 else {"mel": dev(raw["image"])})
        if "context" in raw:
            batch["context"] = dev(raw["context"])
        elif self.video:
            if self.train_cond:
                batch["video_feat"] = dev(raw["video_feat"])
            else:
                batch["context"] = self.system.get_learned_conditioning(raw["video_feat"])
        elif self.train_cond:
            batch.update(self.system.tokenize(raw["caption"]))
        else:
            batch["context"] = self.system.get_learned_conditioning(raw["caption"]).float()
        return batch

    def maybe_rescale_by_std(self, batch: Dict[str, torch.Tensor],
                             generator: torch.Generator, rows=None) -> None:
        """The first batch's latent std sets the scale factor (over the
        global batch: rows, see sample_latent)."""
        if self._scale_by_std_done:
            return
        z = sample_latent(self.state.vae, batch, generator, rows=rows)
        if rows is None:
            scale = 1.0 / float(z.flatten().std(correction=0))
        else:  # count, sum and sum of squares over the data ranks, in fp64
            zd = z.double()
            m = torch.stack([zd.new_tensor(float(z.numel())), zd.sum(), zd.square().sum()])
            dist.all_reduce(m, group=self.mesh.data_group)
            n, s1, s2 = m.tolist()
            scale = 1.0 / (s2 / n - (s1 / n) ** 2) ** 0.5
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
        """One (micro-)step on a collated host batch (a node's batch: this
        data rank takes its rows); a `crash` checkpoint is saved if the step
        raises. draws replaces the generator's noise of the global batch
        (tests)."""
        with trace.span("train.prepare"):
            gen = self._generator(seed)
            raw, rows = self._local_rows(raw)
            if draws is not None and rows is not None:
                draws = {k: v[rows[0]:rows[1]] for k, v in draws.items()}
            batch = self.prepare_batch(raw)
            self.maybe_rescale_by_std(batch, gen, rows)
        try:
            metrics = self._train_step(self.state, batch, gen, draws, rows)
        except Exception:
            if pmesh.world_size() == 1:
                self.save_checkpoint(tag="crash")  # SetupCallback.on_exception
            raise
        for k in ("loss", "loss_simple"):
            if k in metrics:
                metrics[k] = self._data_mean(metrics[k])
        return metrics

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
        feed = iter(loader)
        while True:
            with trace.span("train.step", step=self.state.step + 1):
                with trace.span("train.loader_wait"):
                    raw = next(feed, None)
                if raw is None:
                    break
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
                    if caps and self.is_main:
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
        if self.sharded:  # a whole DiT from every rank's shards (a collective)
            from maa3_tpu_torch.system import dit_module
            with torch.device(self.device):
                dit = dit_module(self.spec)
            dit.load_state_dict(self._canonical_dit(self._full_params()["dit"]))
            self.system.dit = dit.requires_grad_(False)
        elif self.fuse_gemms:
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
            raw, rows = self._local_rows(raw)
            losses.append(self._data_mean(self._eval_step(
                self.state, self.prepare_batch(raw), gen, rows=rows)))
        mean = float(torch.stack(losses).mean()) if losses else float("nan")
        metrics = {"val/loss_simple": mean, "val/batches": float(len(losses))}
        self._log(metrics | {"step": self.state.step})
        return metrics

    def _log(self, metrics: Dict[str, float]) -> None:
        if not self.is_main:
            return
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
        params = self._full_params()
        params["dit"] = self._canonical_dit(params["dit"])
        opt = st.optimizer.state_dict()
        for key in OPT_STATE:
            if key in opt:
                opt[key] = self._gather_list(opt[key], key)
        payload = {"params": params,
                   "opt_state": opt,
                   "fuse_gemms": self.fuse_gemms,
                   "step": st.step,
                   "scale_factor": st.scale_factor,
                   # the frozen first stage travels with the checkpoint: a
                   # restored DiT decoded through another VAE is garbage
                   "frozen": {"vae": st.vae.state_dict()}}
        if st.ema is not None:
            payload["ema_params"] = self._canonical_ema(True, self._gather_list(st.ema))
        if self.is_main:
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
            if tag is None and keep_last_k > 0:
                steps = sorted(f for f in os.listdir(self.ckpt_dir)
                               if f.startswith("step_") and f.endswith(".pt"))
                for old in steps[:-keep_last_k]:
                    os.remove(os.path.join(self.ckpt_dir, old))
        if pmesh.world_size() > 1:
            dist.barrier()
        return path

    def _state_layout(self, key: str):
        """(placement, owner, whole shape) of each parameter's optimizer
        state `key` ("mu", "nu", "acc": the parameter's; adafactor's "v_row"
        / "v_col": the parameter's without its reduced dim, "v" where not
        factored; the (1,) placeholders replicated)."""
        opt = self.state.optimizer
        out = []
        for i, (spec, owner, shape) in enumerate(zip(
                self._param_specs, self._param_owners, self._param_shapes)):
            if key in ("v_row", "v_col", "v") and opt.factored:
                d = opt.dims[i]
                if (d is None) != (key == "v"):
                    out.append((None, owner, (1,)))
                    continue
                if key != "v":
                    cut = d[1] if key == "v_row" else d[0]
                    spec = None if spec is None else spec[:cut] + spec[cut + 1:]
                    shape = shape[:cut] + shape[cut + 1:]
            out.append((spec, owner, shape))
        return out

    def _gather_list(self, tensors: List[torch.Tensor], key: str = "mu") -> List[torch.Tensor]:
        """Whole tensors of per-parameter state (trainable_parameters()
        order) from every rank's shards and owners (a collective)."""
        return [t if spec is None and owner is None else
                pmesh.gather_tensor(t, spec or (), self.mesh, owner=owner, full_shape=shape)
                for t, (spec, owner, shape) in zip(tensors, self._state_layout(key))]

    def _shard_list(self, tensors, key: str = "mu") -> List[torch.Tensor]:
        return [pmesh.shard_tensor(t, spec or (), self.mesh, owner=owner)
                for t, (spec, owner, _) in zip(tensors, self._state_layout(key))]

    def _full_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The trainable modules' state dicts with whole tensors."""
        out = {}
        for k, m in self.state.trainable().items():
            out[k] = {}
            for n, t in m.state_dict().items():
                name = f"{k}.{n}"
                spec, owner = self.specs.get(name), self.owners.get(name)
                out[k][n] = (t if spec is None and owner is None else pmesh.gather_tensor(
                    t, spec or (), self.mesh, owner=owner, full_shape=self._shapes.get(name)))
        return out

    def restore_checkpoint(self, path: str) -> None:
        """Load a checkpoint of save_checkpoint into this trainer, deciding
        from the keys the file holds: its trainable set, fuse_gemms and
        optimizer (AdamW or adafactor, first-moment dtype, accum_steps) must
        be this trainer's, else it raises before anything is loaded; a file
        without a `frozen` section keeps the current VAE; EMA shadows are
        restored when both the file and the trainer have them."""
        st = self.state
        payload = read_checkpoint(path, weights_only=True)
        mods = st.trainable()
        if set(payload["params"]) != set(mods):
            raise ValueError(
                f"{path}: checkpoint trains {sorted(payload['params'])}, this "
                f"trainer trains {sorted(mods)} (cond_stage_trainable differs)")
        if bool(payload.get("fuse_gemms", False)) != self.fuse_gemms:
            raise ValueError(f"{path}: checkpoint of a trainer with fuse_gemms="
                             f"{payload.get('fuse_gemms', False)}, this trainer has "
                             f"fuse_gemms={self.fuse_gemms}")
        opt = dict(payload["opt_state"])
        for key in OPT_STATE:
            if key in opt:
                opt[key] = self._shard_list(opt[key], key)
        st.optimizer.load_state_dict(opt)
        for k, m in mods.items():
            sd = payload["params"][k]
            if k == "dit" and self.fuse_gemms:
                sd = fuse_dit_state(sd, self.spec.dit.depth)
            sd = {n: pmesh.shard_tensor(t, self.specs.get(f"{k}.{n}") or (), self.mesh,
                                        owner=self.owners.get(f"{k}.{n}"))
                  for n, t in sd.items()}
            m.load_state_dict(sd)
        st.step = int(payload["step"])
        st.scale_factor = float(payload["scale_factor"])
        if "frozen" in payload:
            st.vae.load_state_dict(payload["frozen"]["vae"])
        else:
            print(f"{path}: no frozen VAE in the checkpoint; keeping the current one")
        if st.ema is not None and "ema_params" in payload:
            with torch.no_grad():
                ema = self._shard_list(self._canonical_ema(False, payload["ema_params"]))
                for e, x in zip(st.ema, ema, strict=True):
                    e.copy_(x)
        self.system.scale_factor = st.scale_factor
        self._scale_by_std_done = True

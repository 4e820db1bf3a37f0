"""Training CLI on the port (the flags of scripts/train.py):

    python -m maa3_tpu_torch.train -b configs/txt2audio-cfm-cfg-XL.yaml [-t] \\
        --max_steps 100 [--batch_size 6] [--device cuda] [--remat] \\
        [--accum_steps 2] [--mu_dtype bfloat16] [--fuse_gemms] \\
        [--val_every N --val_batches M] [--audio_log_every N] \\
        [-r CKPT] [--torch_ckpt model.ckpt] [--vae_ckpt step_N.pt] [--ckpt_every N] \\
        data.params.train.params.dataset_cfg.dataset_name=data/synth/manifest_mel.tsv

Builds MAA3System.from_config (random weights from --seed, or a warm start
from the reference's Lightning .ckpt with --torch_ckpt; --vae_ckpt then
loads the "vae" entry of a `python -m maa3_tpu_torch.train_vae` checkpoint
strictly into the frozen first stage, as scripts/train.py:157-162 does with
the JAX CLI's), reads the data
section as scripts/train.py build_loader does (a manifest through the lazy
TextSpecDataset, whose batches the native loader reads, or a directory of
manifests through AnyLenSpecDataset), with the batches loaded ahead by
PrefetchLoader threads, restores a checkpoint of the port's Trainer with -r,
and runs Trainer.fit for --max_steps (micro-)steps in bf16 (fp32 with
--fp32), logging to <ckpt_dir>/metrics.jsonl (and TensorBoard when it
imports). The conditioner trains when the config says so
(cond_stage_trainable, true in every YAML of configs/); the remat policy is
the config's `remat_policy` (model.params.unet_config.params.remat_policy=
save_gemms_lite). With --val_every, fit and the validation loss over
--val_batches batches of the validation split alternate every --val_every
steps (scripts/train.py:198-208); --audio_log_every writes generated
samples under <ckpt_dir>/audio. Checkpoints: every --ckpt_every steps,
`last` at the end, `crash` when a step raises, and `usr1` on SIGUSR1 (at
world size 1). -t/--train is accepted and ignored, as the JAX CLI does.

Parallelism, one process per GPU under torchrun (NCCL; gloo with --device
cpu):

    torchrun --nproc_per_node 8 -m maa3_tpu_torch.train -b CONFIG \\
        [--n_model 2] [--fsdp] [--seq_parallel] [--n_pipe 2 --n_micro 4]
        [--n_expert 2] [--batch_size 16] ...

--batch_size is the batch of a node (JAX's per-host batch): the node's
data ranks (nproc_per_node / n_model) split its rows, each node's sampler
takes its share of the batches, and the lr scales with nodes x batch_size,
so the same command on the same number of GPUs trains the same global
batch at the same lr. --n_model is the tensor-parallel width (it must
divide the world; without torchrun only 1), --fsdp shards the DiT's
parameters, moments and EMA over the data ranks (a no-op on one),
--seq_parallel adds sequence parallelism to n_model > 1, --multihost lets
the world span nodes (torchrun --nnodes). --n_pipe S --n_micro M runs
GPipe (each stage holds depth / S blocks; the world reshapes to (data, S,
n_model)), --n_expert E expert parallelism of the video MoE (the world
reshapes to (data, n_model, E)).

-r and --vae_ckpt read the port's own files; a JAX run's Orbax directory
raises a ValueError naming orbax_to_torch.py, which converts it (a Trainer
checkpoint for -r, a scripts/train_vae.py one for --vae_ckpt) where JAX is
installed.

--trace_out PATH turns the program's spans on (maa3_tpu_torch/trace.py:
each step's loader wait, host-to-device copies, VAE encode, conditioner,
forward, backward and optimizer) and writes them at the end of training to
PATH as JSON lines (a rank above 0 writes PATH.rank<k>).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import signal

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--base", nargs="+", required=True, help="config yamls")
    p.add_argument("-t", "--train", action="store_true",
                   help="accepted and ignored (the reference main.py's flag)")
    p.add_argument("-r", "--resume", type=str, default="",
                   help="a checkpoint (.pt) of the port's Trainer to continue from")
    p.add_argument("--torch_ckpt", type=str, default="",
                   help="warm-start from a reference .ckpt (Lightning)")
    p.add_argument("--vae_ckpt", type=str, default="",
                   help="a train_vae checkpoint (.pt) whose 'vae' is the frozen VAE")
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=None,
                   help="default: the config's data.params.batch_size")
    p.add_argument("--ckpt_dir", type=str, default="logs/maa3_torch")
    p.add_argument("--ckpt_every", type=int, default=2000,
                   help="steps between periodic checkpoints (0: none)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation (accumulate_grad_batches)")
    p.add_argument("--mu_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"], help="AdamW first-moment dtype")
    p.add_argument("--fuse_gemms", action="store_true",
                   help="train on the fused wqkv / w13 layout (wider GEMMs)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each DiT block in the backward")
    p.add_argument("--val_every", type=int, default=0,
                   help="validation interval in steps (0: off)")
    p.add_argument("--val_batches", type=int, default=20)
    p.add_argument("--audio_log_every", type=int, default=0,
                   help="AudioLogger sample interval in steps (0: off)")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--fp32", action="store_true", help="train in fp32")
    p.add_argument("--n_model", type=int, default=1,
                   help="tensor-parallel width (Megatron column / row shards)")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: shard the DiT's parameters, AdamW moments and EMA "
                        "over the data ranks (a no-op on one)")
    p.add_argument("--seq_parallel", action="store_true",
                   help="Megatron sequence parallelism (with --n_model > 1)")
    p.add_argument("--n_pipe", type=int, default=1,
                   help="GPipe pipeline-parallel stages: shard the DiT block stack "
                        "depth-wise over a 'pipe' mesh dim (parallel/pipeline.py); "
                        "composes with --n_model")
    p.add_argument("--n_micro", type=int, default=1,
                   help="microbatches per pipeline step (fill/drain bubble fraction = "
                        "(n_pipe-1)/(n_micro+n_pipe-1))")
    p.add_argument("--n_expert", type=int, default=1,
                   help="expert-parallel width for the video MoE: each rank of an "
                        "'expert' mesh dim holds E/n_expert experts of each stack "
                        "(mesh.py add_ep_specs; dense MoE, no all-to-all); composes "
                        "with --n_model")
    p.add_argument("--multihost", action="store_true",
                   help="initialise from the launcher's environment across nodes")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--trace_out", type=str, default="",
                   help="write the program's spans as JSON lines here at the end")
    p.add_argument("overrides", nargs="*", default=[], help="key.sub=value")
    return p.parse_args(argv)


def build_loader(data, batch_size: int, seed: int, moments_dim: int,
                 num_workers: int = 2, num_replicas: int = 1, rank: int = 0,
                 drop_last: bool = False):
    """Endless batches of the split `data` (config.DataSpec), reshuffled every
    epoch, this replica's share (BucketBatchSampler's split; a replica is a
    node, as a host is in scripts/train.py:128-130), loaded ahead by
    PrefetchLoader; close() the generator to stop and join the loader's
    threads."""
    from maa3_tpu_torch.data.datasets import (AnyLenSpecDataset, BucketBatchSampler,
                                              PrefetchLoader, TextSpecDataset)
    if data.any_len:
        ds = AnyLenSpecDataset(data.split, data.dataset_name,
                               spec_crop_len=data.spec_crop_len, drop=data.drop, seed=seed)
        indices = ds.ordered_indices()
    else:
        ds = TextSpecDataset(data.split, data.dataset_name, data.spec_crop_len,
                             data.drop, seed=seed, moments_dim=moments_dim, lazy=True)
        indices = range(len(ds))
    sampler = BucketBatchSampler(indices, batch_size, num_replicas=num_replicas,
                                 rank=rank, seed=seed, drop_last=drop_last)
    with PrefetchLoader(ds, sampler, num_workers=num_workers) as loader:
        for epoch in itertools.count():
            sampler.set_epoch(epoch)
            yield from loader


def load_vae_ckpt(vae: torch.nn.Module, path: str) -> None:
    """The "vae" entry of a train_vae checkpoint into `vae`, strictly: a
    missing, extra or misshapen key raises."""
    from maa3_tpu_torch.torch_import import read_checkpoint
    vae.load_state_dict(read_checkpoint(path)["vae"], strict=True)
    print(f"frozen VAE <- {path}", flush=True)


def main(argv=None):
    opt = parse_args(argv)
    from maa3_tpu_torch.parallel.mesh import distributed
    from maa3_tpu_torch import trace
    with distributed(opt.device, opt.multihost) as device:
        if opt.trace_out:
            trace.enable(device)
        try:
            return _train(opt, device)
        finally:
            if opt.trace_out:
                trace.dump(opt.trace_out)


def _train(opt, device):
    from maa3_tpu_torch import config as config_mod
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.system import MAA3System
    from maa3_tpu_torch.train.audio_logger import AudioLogger
    from maa3_tpu_torch.train.loop import Trainer

    if opt.n_pipe > 1:
        mesh = pmesh.make_pipe_mesh(n_pipe=opt.n_pipe, n_model=opt.n_model)
    elif opt.n_expert > 1:
        mesh = pmesh.make_moe_mesh(n_model=opt.n_model, n_expert=opt.n_expert)
    else:
        mesh = pmesh.make_mesh(n_model=opt.n_model)
    cfg = config_mod.load_config(opt.base, opt.overrides)
    data = config_mod.parse_data_config(cfg)
    system = MAA3System.from_config(
        opt.base, opt.overrides, seed=opt.seed, device=device,
        compute_dtype=torch.float32 if opt.fp32 else torch.bfloat16,
        ckpt_path=opt.torch_ckpt or None)
    if opt.vae_ckpt:
        load_vae_ckpt(system.vae, opt.vae_ckpt)
    if opt.remat:
        system.dit.cfg = dataclasses.replace(system.dit.cfg, remat=True)
    batch_size = opt.batch_size or data.batch_size
    trainer = Trainer(system, batch_size=batch_size, use_ema=opt.use_ema,
                      log_every=opt.log_every, ckpt_every=opt.ckpt_every,
                      ckpt_dir=opt.ckpt_dir, accum_steps=opt.accum_steps,
                      mu_dtype=getattr(torch, opt.mu_dtype), fuse_gemms=opt.fuse_gemms,
                      n_model=opt.n_model, fsdp=opt.fsdp, seq_parallel=opt.seq_parallel,
                      n_pipe=opt.n_pipe, n_micro=opt.n_micro, n_expert=opt.n_expert,
                      mesh=mesh)
    if opt.resume:
        trainer.restore_checkpoint(opt.resume)
        print(f"resumed from {opt.resume} at step {trainer.state.step}")
    audio_logger = (AudioLogger(opt.ckpt_dir, every_n_steps=opt.audio_log_every)
                    if opt.audio_log_every else None)
    moments_dim = 2 * system.spec.vae.embed_dim

    def melk(*_):  # SIGUSR1 -> checkpoint now (main.py:798-815)
        print("SIGUSR1: checkpointing...", flush=True)
        trainer.save_checkpoint(tag="usr1")

    # one rank's signal cannot checkpoint a sharded state alone
    single = pmesh.world_size() == 1
    previous = signal.signal(signal.SIGUSR1, melk) if single else None
    # the sampler splits over nodes; the node's data ranks split each batch
    split = dict(num_replicas=mesh.n_nodes, rank=mesh.data_rank // mesh.data_per_node,
                 drop_last=mesh.n_data > 1)
    loader = build_loader(data, batch_size, opt.seed, moments_dim, **split)
    try:
        # fit and evaluate alternate every val_every steps (scripts/train.py:198-208)
        chunk = opt.val_every or opt.max_steps
        done, metrics = 0, {}
        while done < opt.max_steps:
            n = min(chunk, opt.max_steps - done)
            metrics = trainer.fit(loader, max_steps=n, seed=opt.seed,
                                  audio_logger=audio_logger)
            done += n
            if opt.val_every:
                val = build_loader(config_mod.parse_data_config(cfg, "validation"),
                                   batch_size, opt.seed, moments_dim, **split)
                try:
                    trainer.evaluate(val, max_batches=opt.val_batches)
                finally:
                    val.close()
    finally:
        loader.close()
        if single:
            signal.signal(signal.SIGUSR1, previous)
    trainer.save_checkpoint(tag="last")
    trainer.close()
    if trainer.is_main:
        print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main()

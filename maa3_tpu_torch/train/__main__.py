"""Training CLI on the port (the flags of scripts/train.py that training the
text-to-audio DiT on one device uses):

    python -m maa3_tpu_torch.train -b configs/txt2audio-cfm-cfg-XL.yaml \\
        --max_steps 100 [--batch_size 6] [--device cuda] [--remat] \\
        [-r CKPT] [--torch_ckpt model.ckpt] [--ckpt_every N] \\
        data.params.train.params.dataset_cfg.dataset_name=data/synth/manifest_mel.tsv

Builds MAA3System.from_config (random weights from --seed, or a warm start
from the reference's Lightning .ckpt with --torch_ckpt), reads the
manifest named by the config's data section (TextSpecDataset: mels cropped
or tiled to spec_crop_len), restores a checkpoint of the port's Trainer with
-r, and runs Trainer.fit for --max_steps steps in bf16 (fp32 with --fp32),
logging to <ckpt_dir>/metrics.jsonl. The conditioner trains when the config
says so (cond_stage_trainable, true in every YAML of configs/). Checkpoints:
every --ckpt_every steps, `last` at the end, `crash` when a step raises, and
`usr1` on SIGUSR1. The JAX CLI's --vae_ckpt reads an Orbax directory and
is not in the port.
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
    p.add_argument("-r", "--resume", type=str, default="",
                   help="a checkpoint (.pt) of the port's Trainer to continue from")
    p.add_argument("--torch_ckpt", type=str, default="",
                   help="warm-start from a reference .ckpt (Lightning)")
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=None,
                   help="default: the config's data.params.batch_size")
    p.add_argument("--ckpt_dir", type=str, default="logs/maa3_torch")
    p.add_argument("--ckpt_every", type=int, default=2000,
                   help="steps between periodic checkpoints (0: none)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="recompute each DiT block in the backward")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--fp32", action="store_true", help="train in fp32")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("overrides", nargs="*", default=[], help="key.sub=value")
    return p.parse_args(argv)


def build_loader(data, batch_size: int, seed: int, moments_dim: int):
    """Endless batches of the manifest, reshuffled every epoch."""
    from maa3_tpu_torch.data.datasets import BucketBatchSampler, TextSpecDataset
    ds = TextSpecDataset("train", data.dataset_name, data.spec_crop_len, data.drop,
                         seed=seed, moments_dim=moments_dim)
    sampler = BucketBatchSampler(range(len(ds)), batch_size, seed=seed)
    for epoch in itertools.count():
        sampler.set_epoch(epoch)
        for idx in sampler:
            yield ds.collater([ds[i] for i in idx])


def main(argv=None):
    opt = parse_args(argv)
    from maa3_tpu_torch import config as config_mod
    from maa3_tpu_torch.system import MAA3System
    from maa3_tpu_torch.train.loop import Trainer

    data = config_mod.parse_data_config(config_mod.load_config(opt.base, opt.overrides))
    system = MAA3System.from_config(
        opt.base, opt.overrides, seed=opt.seed, device=opt.device,
        compute_dtype=torch.float32 if opt.fp32 else torch.bfloat16,
        ckpt_path=opt.torch_ckpt or None)
    if opt.remat:
        system.dit.cfg = dataclasses.replace(system.dit.cfg, remat=True)
    batch_size = opt.batch_size or data.batch_size
    trainer = Trainer(system, batch_size=batch_size, use_ema=opt.use_ema,
                      log_every=opt.log_every, ckpt_every=opt.ckpt_every,
                      ckpt_dir=opt.ckpt_dir)
    if opt.resume:
        trainer.restore_checkpoint(opt.resume)
        print(f"resumed from {opt.resume} at step {trainer.state.step}")

    def melk(*_):  # SIGUSR1 -> checkpoint now (main.py:798-815)
        print("SIGUSR1: checkpointing...", flush=True)
        trainer.save_checkpoint(tag="usr1")

    previous = signal.signal(signal.SIGUSR1, melk)
    try:
        loader = build_loader(data, batch_size, opt.seed, 2 * system.spec.vae.embed_dim)
        metrics = trainer.fit(loader, max_steps=opt.max_steps, seed=opt.seed)
    finally:
        signal.signal(signal.SIGUSR1, previous)
    trainer.save_checkpoint(tag="last")
    print("final:", metrics)
    return metrics


if __name__ == "__main__":
    main()

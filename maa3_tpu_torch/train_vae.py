"""Stage-1 VAE-GAN training CLI on the port (the flags of
scripts/train_vae.py, plus --device):

    python -m maa3_tpu_torch.train_vae --tsv train.tsv --steps 100000 \\
        [--kl_weight 1e-6] [--disc_start 50001] [--ckpt_dir logs/vae] [--device cuda]

The manifest's mel_path column names (80, T) .npy log-mels. Each iteration
draws batch_size of them with np.random.RandomState(0) (the JAX CLI's
draws), reads them with the native loader cropped or tiled to --mel_len,
and runs the ae step then the disc step on the same posterior noise
(vae_gan.posterior_noise, seeded by the iteration as JAX keys it). Weights
start from torch.Generator seed 0 (the VAE, then the PatchGAN). Steps run
in fp32 without TF32 (pipeline.full_fp32). Checkpoints are torch.save files
<ckpt_dir>/step_%08d.pt holding {"vae", "disc", "logvar"} (JAX's _save
writes the same entries to Orbax), every --ckpt_every iterations and at the
end; there is no resume, as in JAX. `python -m maa3_tpu_torch.train
--vae_ckpt <file>` takes the "vae" entry as the frozen first stage.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tsv", required=True, help="manifest with mel_path column")
    p.add_argument("--mel_len", type=int, default=624)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--lr", type=float, default=4.5e-6)
    p.add_argument("--lr_multiplier", type=float, default=16.0)
    p.add_argument("--kl_weight", type=float, default=1e-6)
    p.add_argument("--disc_start", type=int, default=50001)
    p.add_argument("--disc_weight", type=float, default=0.5)
    p.add_argument("--ch", type=int, default=384)
    p.add_argument("--ckpt_dir", default="logs/vae")
    p.add_argument("--ckpt_every", type=int, default=5000)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def init_state(cfg, device, lr: float, lr_multiplier: float):
    """The VAE then the PatchGAN from torch.Generator seed 0, on `device`."""
    from maa3_tpu_torch.models.vae1d import AutoencoderKL, vae_init_
    from maa3_tpu_torch.train.vae_gan import create_vae_gan_state
    gen = torch.Generator().manual_seed(0)
    vae = vae_init_(AutoencoderKL(cfg), gen).to(device)
    return create_vae_gan_state(vae, gen, lr, lr_multiplier)


def main(argv=None):
    opt = parse_args(argv)
    from maa3_tpu_torch.data.datasets import read_tsv
    from maa3_tpu_torch.models.vae1d import VAEConfig
    from maa3_tpu_torch.native.io import NativeLoader
    from maa3_tpu_torch.pipeline import full_fp32
    from maa3_tpu_torch.train.vae_gan import (make_vae_gan_steps, posterior_noise,
                                              vae_gan_checkpoint)

    device = torch.device(opt.device)
    cfg = VAEConfig(ch=opt.ch)
    paths = [r["mel_path"] for r in read_tsv(opt.tsv)]
    loader = NativeLoader(rows=80)
    state = init_state(cfg, device, opt.lr, opt.lr_multiplier)
    ae_step, disc_step = make_vae_gan_steps(
        cfg, kl_weight=opt.kl_weight, disc_weight=opt.disc_weight,
        disc_start=opt.disc_start)

    rng = np.random.RandomState(0)
    os.makedirs(opt.ckpt_dir, exist_ok=True)
    t0 = time.time()
    for it in range(opt.steps):
        idx = rng.randint(0, len(paths), opt.batch_size)
        mel = torch.from_numpy(loader.load_batch([paths[i] for i in idx], opt.mel_len,
                                                 mode="tile")).to(device)
        noise = posterior_noise(cfg, opt.batch_size, opt.mel_len, it)
        with full_fp32():
            m_ae = ae_step(state, mel, noise)
            m_d = disc_step(state, mel, noise)
        if it % 50 == 0 or it == opt.steps - 1:
            print(f"step {it}  aeloss {float(m_ae['aeloss']):.4f}  "
                  f"rec {float(m_ae['rec_loss']):.4f}  "
                  f"kl {float(m_ae['kl_loss']):.1f}  "
                  f"disc {float(m_d['discloss']):.4f}  "
                  f"({it / max(time.time() - t0, 1e-9):.2f} it/s)", flush=True)
        if opt.ckpt_every and it and it % opt.ckpt_every == 0:
            save(opt.ckpt_dir, vae_gan_checkpoint(state), it)
    return save(opt.ckpt_dir, vae_gan_checkpoint(state), opt.steps)


def save(ckpt_dir: str, payload: dict, step: int) -> str:
    """torch.save of payload to <ckpt_dir>/step_%08d.pt, written under a
    temporary name and renamed into place."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    print(f"ckpt -> {path}", flush=True)
    return path


if __name__ == "__main__":
    main()

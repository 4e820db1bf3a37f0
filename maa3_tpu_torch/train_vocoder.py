"""BigVGAN vocoder GAN training CLI on the port (the flags of
scripts/train_vocoder.py, plus --device):

    python -m maa3_tpu_torch.train_vocoder --tsv wavs.tsv --steps 100000 \\
        [--segment_frames 32] [--batch_size 8] [--ckpt_dir logs/vocoder] [--device cuda]

The manifest's audio_path column names wav files. Each is read with scipy,
integers scaled by their type's maximum, stereo averaged; a file shorter
than one segment plus a hop, or one that cannot be read, is skipped.
Each iteration crops batch_size segments of segment_frames hops at
hop-aligned starts drawn with np.random.RandomState(0) (the JAX CLI's
draws), takes the input mel from the port's frontend (ops/stft.py), and
runs the generator step then the discriminator step (MPD (2, 3, 5, 7, 11)
and MRD, three resolutions). Weights start from torch.Generator seed 0
(the generator, then the MPD, then the MRD). Steps run in fp32 without TF32
(pipeline.full_fp32). Checkpoints are torch.save files
<ckpt_dir>/step_%08d.pt holding {"generator"}, as JAX's _save does in
Orbax, every --ckpt_every iterations and at the end; there is no resume.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tsv", required=True)
    p.add_argument("--segment_frames", type=int, default=32,
                   help="mel frames per training segment")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--upsample_initial_channel", type=int, default=1536)
    p.add_argument("--ckpt_dir", default="logs/vocoder")
    p.add_argument("--ckpt_every", type=int, default=10000)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def read_wavs(paths, min_len: int):
    """The float32 mono wavs of `paths` that hold at least min_len samples."""
    from scipy.io import wavfile
    wavs = []
    for path in paths:
        try:
            _, w = wavfile.read(path)
        except (OSError, ValueError) as e:
            print(f"skip {path}: {e}", flush=True)
            continue
        if w.dtype.kind == "i":
            w = w.astype(np.float32) / np.iinfo(w.dtype).max
        if w.ndim == 2:
            w = w.mean(1)
        if len(w) >= min_len:
            wavs.append(w.astype(np.float32))
    return wavs


def init_state(cfg, device, lr: float):
    """The generator, MPD and MRD from torch.Generator seed 0, on `device`."""
    from maa3_tpu_torch.models.bigvgan import BigVGAN, bigvgan_init_
    from maa3_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                      MultiResolutionDiscriminator,
                                                      disc_init_)
    from maa3_tpu_torch.train.vocoder_gan import create_vocoder_gan_state
    g = torch.Generator().manual_seed(0)
    gen = bigvgan_init_(BigVGAN(cfg), g).to(device)
    mpd = disc_init_(MultiPeriodDiscriminator(), g).to(device)
    mrd = disc_init_(MultiResolutionDiscriminator(), g).to(device)
    return create_vocoder_gan_state(gen, mpd, mrd, lr)


def draw_batch(rng: np.random.RandomState, wavs, batch_size: int, seg: int, hop: int):
    """batch_size hop-aligned crops of seg samples (scripts/train_vocoder.py:80-86)."""
    out = []
    for _ in range(batch_size):
        w = wavs[rng.randint(len(wavs))]
        start = rng.randint(0, len(w) - seg - hop) // hop * hop
        out.append(w[start:start + seg])
    return np.stack(out)


def main(argv=None):
    opt = parse_args(argv)
    from maa3_tpu_torch.data.datasets import read_tsv
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.ops.stft import MelConfig, mel_spectrogram
    from maa3_tpu_torch.pipeline import full_fp32
    from maa3_tpu_torch.train.vocoder_gan import make_vocoder_gan_steps
    from maa3_tpu_torch.train_vae import save

    device = torch.device(opt.device)
    cfg = BigVGANConfig(upsample_initial_channel=opt.upsample_initial_channel)
    mel_cfg = MelConfig()
    hop = mel_cfg.hop_size
    seg = opt.segment_frames * hop
    wavs = read_wavs([r["audio_path"] for r in read_tsv(opt.tsv)], seg + hop)
    if not wavs:
        raise SystemExit("no usable wavs")
    print(f"{len(wavs)} training wavs", flush=True)

    state = init_state(cfg, device, opt.lr)
    gen_step, disc_step = make_vocoder_gan_steps(mel_cfg)
    rng = np.random.RandomState(0)
    os.makedirs(opt.ckpt_dir, exist_ok=True)
    t0 = time.time()
    for it in range(opt.steps):
        wav = torch.from_numpy(draw_batch(rng, wavs, opt.batch_size, seg, hop)).to(device)
        with full_fp32():
            batch = {"mel": mel_spectrogram(wav, mel_cfg)[:, :, :opt.segment_frames],
                     "wav": wav}
            mg = gen_step(state, batch)
            md = disc_step(state, batch)
        if it % 50 == 0 or it == opt.steps - 1:
            print(f"step {it}  gen {float(mg['gen_loss']):.3f}  "
                  f"mel_l1 {float(mg['mel_l1']):.4f}  "
                  f"fm {float(mg['fm']):.3f}  "
                  f"disc {float(md['disc_loss']):.3f}  "
                  f"({it / max(time.time() - t0, 1e-9):.2f} it/s)", flush=True)
        if opt.ckpt_every and it and it % opt.ckpt_every == 0:
            save(opt.ckpt_dir, {"generator": state.gen.state_dict()}, it)
    return save(opt.ckpt_dir, {"generator": state.gen.state_dict()}, opt.steps)


if __name__ == "__main__":
    main()

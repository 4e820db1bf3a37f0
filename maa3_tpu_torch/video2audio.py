"""Video-to-audio CLI on the port (the flags of scripts/video2audio.py):

    python -m maa3_tpu_torch.video2audio --feat_dir feats/ --outdir out \
        [-b configs/video2audio-cfm-cfg-moe.yaml] [-r model.ckpt] \
        [--vocoder-ckpt vocoder/] [--mel_gt_dir mels/ --inpaint --mask_ratio 0.5]
        [--renorm] [--clap_text "a dog barks"] [--fp32]

For each .npz of --feat_dir (its `feat`, (frames, 512) CLIP/CAVP features;
`empty_vid` is skipped): the frames cut into windows of fps x duration
(the last one zero-padded), each window encoded by the video conditioner
and sampled with the 25-step CFG ODE of the MoE DiT (with --inpaint and a
GT mel <name>_mel.npy in --mel_gt_dir: the canonical DiT through
cfm.sample_cfg_inpaint, keeping the GT latent outside a span of mask_ratio
of the window starting at its first quarter), decoded to a mel (with
--renorm: rescaled to the GT mel's mean and std), the windows' mels
concatenated and vocoded into one 16-bit wav at --sample_rate.

--clap_text fuses a text embedding into every frame's features
(models/clap.py ClapFusion, a random fusion layer from --seed + 1). The
video conditioner has no text tower, so the embedding is a (1, 1024) draw
of numpy's RandomState seeded by a stable hash of the text (zlib.crc32):
JAX's CLI seeds it with Python's hash(), which changes between processes
unless PYTHONHASHSEED is set.

Noise comes from one torch.Generator seeded with --seed: per window the
posterior sample of the GT latent (--inpaint) and then the initial noise.
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import time
import zlib

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--feat_dir", type=str, required=True,
                   help="dir of CAVP/CLIP .npz feature files")
    p.add_argument("--mel_gt_dir", type=str, default="",
                   help="optional GT mel dir (renorm stats / inpainting)")
    p.add_argument("--outdir", type=str, default="outputs/video2audio-samples")
    p.add_argument("--ddim_steps", type=int, default=25)
    p.add_argument("--scale", type=float, default=4.5)
    p.add_argument("-r", "--resume", type=str, default="")
    p.add_argument("-b", "--base", type=str, default="")
    p.add_argument("--vocoder-ckpt", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tokenizer_dir", type=str, default="",
                   help="dir with bert/vocab.txt + t5/tokenizer.json "
                        "(default: $MAA3_TOKENIZER_DIR)")
    p.add_argument("--fps", type=float, default=4.0)
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--hop_len", type=int, default=256)
    p.add_argument("--renorm", action="store_true",
                   help="z-renorm generated mel to GT stats (fork behavior)")
    p.add_argument("--inpaint", action="store_true")
    p.add_argument("--mask_ratio", type=float, default=0.5)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--clap_text", type=str, default="",
                   help="fuse a CLAP text prompt into the visual features "
                        "(video2audio_flow_CLAP.py fork experiment)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def text_embedding(text: str) -> np.ndarray:
    """The (1, 1024) stand-in text embedding of a system without a text
    tower: numpy's RandomState seeded by crc32 of the text."""
    rng = np.random.RandomState(zlib.crc32(text.encode("utf-8")) % (2 ** 31))
    return rng.randn(1, 1024).astype(np.float32)


def keep_mask(latent_len: int, mask_ratio: float) -> np.ndarray:
    """(1, 1, latent_len): 0 on the span to synthesize (mask_ratio of the
    window from its first quarter), 1 elsewhere."""
    keep = np.ones((1, 1, latent_len), np.float32)
    m0 = int(latent_len * 0.25)
    keep[:, :, m0:m0 + int(latent_len * mask_ratio)] = 0.0
    return keep


def windows(feat: np.ndarray, truncate_frame: int):
    """The feature windows of one clip, the last one zero-padded."""
    n = max(1, math.ceil(feat.shape[0] / truncate_frame))
    for w in range(n):
        seg = feat[w * truncate_frame:(w + 1) * truncate_frame]
        if seg.shape[0] < truncate_frame:
            seg = np.concatenate([seg, np.zeros((truncate_frame - seg.shape[0],
                                                 seg.shape[1]), np.float32)])
        yield seg


class WindowSampler:
    """The per-window sampler: video2audio's ODE, inpainting and renorm."""

    def __init__(self, system, opt):
        self.system, self.opt = system, opt
        self.truncate_frame = int(opt.fps * opt.duration)
        self.spec_len = int(opt.sample_rate * opt.duration / opt.hop_len)
        self.latent_len = self.spec_len // system.spec.vae.downsample_rate
        self.gen = torch.Generator(device=system.device).manual_seed(opt.seed)
        self.uc = system.get_learned_conditioning(
            np.zeros((1, self.truncate_frame, 512), np.float32))
        if opt.clap_text:
            from maa3_tpu_torch.models.clap import ClapFusion, clap_flan_init_
            with torch.device(system.device):
                self.fusion = ClapFusion()
            clap_flan_init_(self.fusion, torch.Generator(device=system.device)
                            .manual_seed(opt.seed + 1))
            self.text_emb = torch.as_tensor(text_embedding(opt.clap_text),
                                            device=system.device)
            print(f"clap fusion: caption {opt.clap_text!r} fused into the video "
                  f"conditioning (dim {self.text_emb.shape[-1]})")

    def conditioning(self, seg: np.ndarray) -> torch.Tensor:
        from maa3_tpu_torch.models.clap import clap_fusion_apply
        x = torch.as_tensor(seg[None], device=self.system.device)
        if self.opt.clap_text:
            x = clap_fusion_apply(self.fusion, x, self.text_emb)
        return self.system.get_learned_conditioning(x)

    @torch.no_grad()
    def latent(self, seg: np.ndarray, w: int, gt_mel) -> torch.Tensor:
        """The (1, C, latent_len) latent of window w."""
        from maa3_tpu_torch.diffusion import cfm
        s, opt = self.system, self.opt
        c = self.conditioning(seg)
        shape = (1, s.spec.mel_dim, self.latent_len)
        if opt.inpaint and gt_mel is not None:
            g = gt_mel[:, w * self.spec_len:(w + 1) * self.spec_len]
            if g.shape[1] < self.spec_len:
                g = np.pad(g, ((0, 0), (0, self.spec_len - g.shape[1])))
            known = s.encode_first_stage(torch.as_tensor(g[None], device=s.device),
                                         self.gen)
            x0 = torch.randn(shape, generator=self.gen, device=s.device)
            keep = torch.as_tensor(keep_mask(self.latent_len, opt.mask_ratio),
                                   device=s.device)
            return cfm.sample_cfg_inpaint(s.velocity_fn(s.dit), x0, c, self.uc,
                                          opt.scale, known, keep,
                                          steps=opt.ddim_steps)
        return s.sample_cfg(c, opt.scale, self.uc, self.gen, shape=shape,
                            timesteps=opt.ddim_steps)

    def mel(self, seg: np.ndarray, w: int, gt_mel) -> np.ndarray:
        mel = self.system.decode_first_stage(self.latent(seg, w, gt_mel))[0]
        mel = mel.float().cpu().numpy()
        if self.opt.renorm and gt_mel is not None:
            std = mel.std()
            if std > 1e-5:
                mel = (mel - mel.mean()) / std * gt_mel.std() + gt_mel.mean()
        return mel


def main(argv=None):
    opt = parse_args(argv)
    from maa3_tpu_torch.system import MAA3System
    from maa3_tpu_torch.txt2audio import write_wav
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_paths = [c for c in opt.base.split(",") if c] or [
        os.path.join(root, "configs", "video2audio-cfm-cfg-moe.yaml")]
    system = MAA3System.from_config(
        cfg_paths, seed=opt.seed, device=opt.device,
        compute_dtype=torch.float32 if opt.fp32 else torch.bfloat16,
        tokenizer_dir=opt.tokenizer_dir or None, ckpt_path=opt.resume or None,
        vocoder_dir=opt.vocoder_ckpt or None)
    if not opt.resume:
        print("WARNING: no checkpoint given (-r); generating with random weights")
    os.makedirs(opt.outdir, exist_ok=True)
    feat_files = sorted(glob.glob(os.path.join(opt.feat_dir, "*.npz")))
    if not feat_files:
        raise SystemExit(f"no .npz features in {opt.feat_dir}")
    gen = WindowSampler(system, opt)
    for fpath in feat_files:
        name = os.path.splitext(os.path.basename(fpath))[0]
        if name == "empty_vid":
            continue
        t0 = time.perf_counter()
        with np.load(fpath) as f:
            feat = f["feat"].astype(np.float32)
        gt_mel = None
        if opt.mel_gt_dir:
            gp = os.path.join(opt.mel_gt_dir, name + "_mel.npy")
            if os.path.exists(gp):
                gt_mel = np.load(gp).astype(np.float32)
        chunks = [gen.mel(seg, w, gt_mel)
                  for w, seg in enumerate(windows(feat, gen.truncate_frame))]
        full_mel = np.concatenate(chunks, axis=1)
        wav = system.vocode(torch.as_tensor(full_mel[None], device=system.device))[0]
        out = os.path.join(opt.outdir, name + ".wav")
        write_wav(out, wav, opt.sample_rate)
        print(f"{name}: {len(chunks)} windows -> mel {full_mel.shape} -> {out} "
              f"({time.perf_counter() - t0:.3f} s)")
    print(f"done -> {opt.outdir}")


if __name__ == "__main__":
    main()

"""Frechet distance and KL over a mel classifier's embeddings, on the port
(the flags of scripts/cal_fd_score.py, plus --device):

    python -m maa3_tpu_torch.cal_fd_score --gen_dir genmels/ --ref_dir gtmels/ \\
        [--backbone vggishish|melception] [--clf_ckpt clf.pt] [--small] \\
        [--norm_stats train_means_stds.txt] [--device cuda]

The *.npy mels of each directory (sorted) are read by the native loader
in tile mode to --mel_len frames, z-normalised with the cached training
statistics of --norm_stats when given, and embedded in batches of --batch
on --device in fp32 without TF32: the VGGishish's 4096-d embedding or the
Melception's 2048-d pool. FD (numpy float64, scipy's sqrtm) compares the
two sets; KL(ref || gen) of the posteriors is added when both hold as many
mels. --clf_ckpt takes a reference state dict or a train_melclf file
(eval/classifier.py); without it the classifier is random (seed 0). A
classifier without running BN statistics (every train_melclf file) is
evaluated with batch statistics, so its numbers depend on --batch, as in
JAX.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gen_dir", required=True)
    p.add_argument("--ref_dir", required=True)
    p.add_argument("--clf_ckpt", default="")
    p.add_argument("--mel_len", type=int, default=624)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--num_classes", type=int, default=309)
    p.add_argument("--small", action="store_true")
    p.add_argument("--backbone", default="vggishish", choices=["vggishish", "melception"])
    p.add_argument("--norm_stats", default="",
                   help="cached train_means_stds txt (StandardNormalizeAudio)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    from maa3_tpu_torch.eval import classifier
    from maa3_tpu_torch.models import melclf
    from maa3_tpu_torch.native.io import NativeLoader
    from maa3_tpu_torch.pipeline import full_fp32

    if opt.clf_ckpt:
        model = classifier.load_classifier(opt.clf_ckpt, opt.backbone, opt.num_classes,
                                              opt.small)
    else:
        print("WARNING: random classifier (relative numbers only)")
        model = classifier.new_classifier(opt.backbone, opt.num_classes, opt.small)
    device = torch.device(opt.device)
    model = model.to(device).eval()
    loader = NativeLoader(rows=80)
    norm = None
    if opt.norm_stats:
        from maa3_tpu_torch.data.transforms import StandardNormalizeAudio
        norm = StandardNormalizeAudio.from_stats_file(opt.norm_stats)

    def embed_dir(d):
        paths = sorted(glob.glob(os.path.join(d, "*.npy")))
        if not paths:
            raise SystemExit(f"no npy mels in {d}")
        logits_all, emb_all = [], []
        for i in range(0, len(paths), opt.batch):
            mel = loader.load_batch(paths[i: i + opt.batch], opt.mel_len, mode="tile")
            if norm is not None:
                mel = norm(mel).astype(np.float32)
            with torch.no_grad(), full_fp32():
                logits, emb = classifier.embed(model, torch.from_numpy(mel).to(device))
            logits_all.append(logits.cpu().numpy())
            emb_all.append(emb.cpu().numpy())
        return np.concatenate(logits_all), np.concatenate(emb_all), paths

    t0 = time.perf_counter()
    g_logits, g_emb, g_paths = embed_dir(opt.gen_dir)
    r_logits, r_emb, r_paths = embed_dir(opt.ref_dir)
    t1 = time.perf_counter()
    fd = melclf.frechet_distance(g_emb, r_emb)
    t2 = time.perf_counter()
    out = {"fd": round(fd, 4), "n_gen": len(g_paths), "n_ref": len(r_paths)}
    if len(g_logits) == len(r_logits):
        out["kl"] = round(melclf.kl_divergence_softmax(g_logits, r_logits), 4)
    print(out)
    print(f"{opt.backbone}: {len(g_paths) + len(r_paths)} mels embedded in "
          f"{t1 - t0:.3f} s, FD over {g_emb.shape[1]} dims in {t2 - t1:.3f} s", flush=True)
    return dict(out, embed_s=t1 - t0, fd_s=t2 - t1)


if __name__ == "__main__":
    main()

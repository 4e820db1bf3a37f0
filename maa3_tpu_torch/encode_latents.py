"""Offline VAE latent caching on the port (the flags of
scripts/encode_latents.py): mel .npy -> posterior-moments .npy + manifest.

    python -m maa3_tpu_torch.encode_latents --tsv_path data/train.tsv \\
        --save_path data/latents -b configs/txt2audio-cfm-cfg.yaml \\
        [-r ckpt] [--batch 32] [--crop_len 624] [--num_shards 1 --shard 0] \\
        [--device cuda]

Encodes every mel of the manifest (this shard's rows: rows[shard::num_shards])
with the config's VAE (random weights from seed 0 without -r; -r reads a
Lightning .ckpt or a .pt of the port's Trainer) in fp32 without TF32, each
mel tiled or cropped to --crop_len and the ragged tail batch padded with
its last mel, so every batch has one shape. Writes <save_path>/<name>.npy
with the posterior moments (mean ++ logvar, (2 * embed_dim, len / 2), cut
to the mel's own length) and <tsv>.latents.tsv (<tsv>.latents.shard<k>.tsv
with several shards) with a `moments_path` column, which TextSpecDataset
reads in place of the mel: training still samples the posterior every step.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tsv_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("-b", "--base", type=str, default="",
                   help="config yamls, comma-separated (default: the base "
                        "text-to-audio config)")
    p.add_argument("-r", "--resume", type=str, default="",
                   help="checkpoint with the trained VAE (random weights if "
                        "omitted: only useful for smoke tests)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--crop_len", type=int, default=624,
                   help="tile / crop each mel to this length before encoding")
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("overrides", nargs="*", default=[], help="key.sub=value")
    return p.parse_args(argv)


def encode_manifest(system, tsv_path: str, save_path: str, batch: int = 32,
                    crop_len: int = 624, num_shards: int = 1, shard: int = 0,
                    log=print) -> str:
    """Encode this shard's mels with system.vae; returns the written manifest."""
    from maa3_tpu_torch.data.datasets import _crop_or_tile, _load, read_tsv
    from maa3_tpu_torch.models.vae1d import vae_encode_moments
    from maa3_tpu_torch.pipeline import full_fp32

    mel_num = system.spec.vae.in_channels
    rows: List[dict] = read_tsv(tsv_path)[shard::num_shards]
    os.makedirs(save_path, exist_ok=True)
    done = 0
    for i in range(0, len(rows), batch):
        chunk = rows[i:i + batch]
        mels, lens = [], []
        for r in chunk:
            m = _load(r["mel_path"], (mel_num, crop_len), 0.0)
            lens.append(min(m.shape[1], crop_len))
            mels.append(_crop_or_tile(m, crop_len))
        mels += [mels[-1]] * (batch - len(mels))  # the ragged tail: one shape
        with torch.no_grad(), full_fp32():
            x = torch.as_tensor(np.stack(mels), device=system.device)
            moments = vae_encode_moments(system.vae, x).float().cpu().numpy()
        ds = crop_len // moments.shape[-1]
        for r, mom, ln in zip(chunk, moments, lens):
            name = os.path.splitext(os.path.basename(r["mel_path"]))[0]
            out = os.path.join(save_path, name + ".npy")
            np.save(out, mom[:, : max(1, ln // ds)])
            r["moments_path"] = out
        done += len(chunk)
        log(f"[{done}/{len(rows)}]")
    out_tsv = tsv_path + (".latents.tsv" if num_shards == 1
                          else f".latents.shard{shard}.tsv")
    with open(out_tsv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()), delimiter="\t",
                           lineterminator="\n", quoting=csv.QUOTE_NONE)
        w.writeheader()
        w.writerows(rows)
    log(f"wrote {out_tsv}")
    return out_tsv


def main(argv=None, **system_kw) -> str:
    """system_kw: extra MAA3System.from_config arguments (tests)."""
    opt = parse_args(argv)
    from maa3_tpu_torch.system import MAA3System

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_paths = [c for c in opt.base.split(",") if c] or [
        os.path.join(root, "configs", "txt2audio-cfm-cfg.yaml")]
    system = MAA3System.from_config(cfg_paths, opt.overrides, device=opt.device,
                                    ckpt_path=opt.resume or None, init_cond=False,
                                    **system_kw)
    return encode_manifest(system, opt.tsv_path, opt.save_path, opt.batch,
                           opt.crop_len, opt.num_shards, opt.shard,
                           log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()

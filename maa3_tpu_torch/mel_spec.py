"""Offline mel extraction on the port (the flags of scripts/mel_spec.py, plus
--device; preprocess/mel_spec.py's job):

    python -m maa3_tpu_torch.mel_spec --tsv_path audio.tsv --save_path mels/ \\
        [--out_tsv audio_mel.tsv] [--batch_size 16] [--device cuda]

Each row's audio_path is read with scipy, scaled to [-1, 1] (integers by
their type's maximum, uint8 about 128), averaged to mono and resampled to
--audio_sample_rate with scipy.signal.resample_poly; in 'pad' mode padded
or cut to (duration * sr / hop + 1) * hop samples, in 'none' mode cut to a
whole number of hops plus one and padded or cut to the same length. Batches
of --batch_size go through the port's mel frontend (ops/stft.py) on
--device, and each mel is saved as <save_path>/<name>_mel.npy, name from the
row's `name` (item_<i> without one). --out_tsv writes the manifest with
mel_path filled in. --num_shards / --shard take every num_shards-th row.
A file that cannot be read is skipped.
"""

from __future__ import annotations

import argparse
import csv
import math
import os

import numpy as np
import torch


def load_audio(path: str, target_sr: int) -> np.ndarray:
    """A wav file as float32 mono at target_sr (scripts/mel_spec.py:31)."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly
    sr, wav = wavfile.read(path)
    if wav.dtype.kind == "i":
        wav = wav.astype(np.float32) / np.iinfo(wav.dtype).max
    elif wav.dtype.kind == "u":
        wav = (wav.astype(np.float32) - 128.0) / 128.0
    else:
        wav = wav.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if sr != target_sr:
        g = math.gcd(int(sr), target_sr)
        wav = resample_poly(wav, target_sr // g, sr // g).astype(np.float32)
    return wav


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tsv_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--audio_sample_rate", type=int, default=16000)
    p.add_argument("--hop_size", type=int, default=256)
    p.add_argument("--fft_size", type=int, default=1024)
    p.add_argument("--win_size", type=int, default=1024)
    p.add_argument("--num_mels", type=int, default=80)
    p.add_argument("--duration", type=float, default=10.0,
                   help="pad/crop target in seconds ('pad' mode)")
    p.add_argument("--mode", choices=["pad", "none"], default="pad")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--out_tsv", default="",
                   help="write a manifest copy with mel_path filled")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def fit_length(wav: np.ndarray, seg: int, hop: int, mode: str) -> np.ndarray:
    """The clip padded with zeros or cut to seg samples ('none' first cuts it
    to a whole number of hops plus one hop)."""
    if mode == "none":
        wav = wav[:(len(wav) // hop) * hop + hop]
    return np.pad(wav, (0, max(0, seg - len(wav))))[:seg]


def main(argv=None):
    opt = parse_args(argv)
    from maa3_tpu_torch.data.datasets import read_tsv
    from maa3_tpu_torch.ops.stft import MelConfig, mel_spectrogram

    cfg = MelConfig(sample_rate=opt.audio_sample_rate, n_fft=opt.fft_size,
                    win_size=opt.win_size, hop_size=opt.hop_size, num_mels=opt.num_mels)
    device = torch.device(opt.device)
    os.makedirs(opt.save_path, exist_ok=True)
    rows = read_tsv(opt.tsv_path)[opt.shard::opt.num_shards]
    target_mel_len = int(opt.duration * opt.audio_sample_rate / opt.hop_size)
    seg = (target_mel_len + 1) * opt.hop_size  # (T + 1) * hop (mel_spec.py:55)

    done, batch, names, out_rows = 0, [], [], []

    def flush():
        nonlocal done
        if not batch:
            return
        with torch.no_grad():
            mels = mel_spectrogram(torch.from_numpy(np.stack(batch)).to(device), cfg)
        for name, mel in zip(names, mels.cpu().numpy()):
            np.save(os.path.join(opt.save_path, f"{name}_mel.npy"), mel)
        done += len(batch)
        print(f"[{done}/{len(rows)}]", flush=True)
        batch.clear()
        names.clear()

    for i, row in enumerate(rows):
        name = row.get("name", f"item_{i}")
        try:
            wav = load_audio(row["audio_path"], opt.audio_sample_rate)
        except (OSError, ValueError) as e:
            print(f"skip {name}: {e}", flush=True)
            continue
        batch.append(fit_length(wav, seg, opt.hop_size, opt.mode))
        names.append(name)
        out_rows.append(dict(row, mel_path=os.path.join(opt.save_path, f"{name}_mel.npy")))
        if len(batch) == opt.batch_size:
            flush()
    flush()

    if opt.out_tsv and out_rows:
        with open(opt.out_tsv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(out_rows[0]), delimiter="\t")
            w.writeheader()
            w.writerows(out_rows)
        print(f"manifest -> {opt.out_tsv}", flush=True)
    return done


if __name__ == "__main__":
    main()

"""CLAP-score CLI on the port (the flags of scripts/cal_clap_score.py, plus
--device; wav_evaluation/cal_clap_score.py's job):

    python -m maa3_tpu_torch.cal_clap_score --wav_dir OUT --tsv test.tsv \\
        [--clap_weights CLAP_weights_2022.pth] [--tokenizer_dir DIR] [--device cuda]

Each TSV row's `name` (sample_<i> without one) is matched to
<name>_0.wav, <name>.wav or <name>_0_0.wav in --wav_dir, first found wins;
integer PCM is divided by its type's maximum. Batches of --batch pairs
(one sample rate each) are scored by CLAPScorer (eval/clap_score.py) on
--device, and the mean cosine is printed (AudioCaps ground truth about
0.479). Without --clap_weights the towers are random (seed 0): relative
numbers only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--wav_dir", required=True)
    p.add_argument("--tsv", required=True)
    p.add_argument("--clap_weights", default="")
    p.add_argument("--tokenizer_dir", default="")
    p.add_argument("--batch", type=int, default=20)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def match_wavs(wav_dir: str, rows) -> list:
    """(wav path, ori_cap) for each row with a generated wav."""
    pairs = []
    for i, r in enumerate(rows):
        name = r.get("name", f"sample_{i}")
        for cand in (f"{name}_0.wav", f"{name}.wav", f"{name}_0_0.wav"):
            path = os.path.join(wav_dir, cand)
            if os.path.exists(path):
                pairs.append((path, r["ori_cap"]))
                break
    return pairs


def main(argv=None):
    opt = parse_args(argv)
    from scipy.io import wavfile
    from maa3_tpu_torch.data.datasets import read_tsv
    from maa3_tpu_torch.eval.clap_score import CLAPScorer

    if opt.clap_weights:
        scorer = CLAPScorer.from_torch_ckpt(opt.clap_weights, opt.tokenizer_dir or None,
                                            device=opt.device)
    else:
        print("WARNING: no CLAP weights; scoring with random towers "
              "(relative numbers only)")
        scorer = CLAPScorer.random_init(tokenizer_dir=opt.tokenizer_dir or None,
                                        device=opt.device)

    pairs = match_wavs(opt.wav_dir, read_tsv(opt.tsv))
    if not pairs:
        raise SystemExit(f"no wavs in {opt.wav_dir} matching {opt.tsv} names")

    scores = []
    for i in range(0, len(pairs), opt.batch):
        wavs, caps, srs = [], [], set()
        for path, cap in pairs[i: i + opt.batch]:
            sr, wav = wavfile.read(path)
            if wav.dtype.kind == "i":
                wav = wav.astype(np.float32) / np.iinfo(wav.dtype).max
            wavs.append(wav.astype(np.float32))
            caps.append(cap)
            srs.add(sr)
        if len(srs) != 1:
            raise ValueError(f"one sample rate per batch, got {sorted(srs)}")
        scores.extend(scorer.score(wavs, caps, sr=srs.pop()).tolist())
        print(f"[{min(i + opt.batch, len(pairs))}/{len(pairs)}] "
              f"running mean = {np.mean(scores):.4f}", flush=True)

    print(f"\nCLAP score over {len(scores)} pairs: {np.mean(scores):.4f} "
          f"(audiocaps GT reference ~ 0.479)")
    return scores


if __name__ == "__main__":
    main()

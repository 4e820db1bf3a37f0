"""Batch prediction of a mel classifier on the port (the flags of
scripts/predict_melclf.py, plus --device; vggishish/predict.py's job):

    python -m maa3_tpu_torch.predict_melclf --tsv test.tsv --clf_ckpt clf.pt \\
        [--backbone melception] [--norm_stats train_means_stds.txt] [--device cuda]

--clf_ckpt is a train_melclf file or a reference state dict
(eval/classifier.py). The manifest's mels (mel_path, label) go through
the classifier in batches of --batch_size (native loader, tile mode,
optional z-norm) in fp32 without TF32; one JSON line holds accuracy@k,
mAP, mROCAUC, d-prime, the mean over batches of the batch's mean
cross-entropy (avg_loss) and the parameter count (param_num). Labels that
are names are indexed in sorted order, as in JAX.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tsv", required=True, help="TSV with mel_path, label")
    p.add_argument("--clf_ckpt", required=True,
                   help="a train_melclf .pt or a reference state dict")
    p.add_argument("--backbone", default="vggishish", choices=["vggishish", "melception"])
    p.add_argument("--mel_len", type=int, default=624)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_classes", type=int, default=0, help="0 = infer from labels")
    p.add_argument("--small", action="store_true")
    p.add_argument("--norm_stats", default="",
                   help="cached train_means_stds txt (StandardNormalizeAudio)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    from maa3_tpu_torch.data.datasets import read_tsv
    from maa3_tpu_torch.data.transforms import StandardNormalizeAudio
    from maa3_tpu_torch.eval.classifier import embed, load_classifier
    from maa3_tpu_torch.eval.metrics import metrics as eval_metrics
    from maa3_tpu_torch.native.io import NativeLoader
    from maa3_tpu_torch.pipeline import full_fp32
    from maa3_tpu_torch.train_melclf import labels_of

    rows = read_tsv(opt.tsv)
    y_all, _, num_classes = labels_of(rows, opt.num_classes)
    paths = [r["mel_path"] for r in rows]
    model = load_classifier(opt.clf_ckpt, opt.backbone, num_classes, opt.small)
    device = torch.device(opt.device)
    model = model.to(device).eval()

    norm = (StandardNormalizeAudio.from_stats_file(opt.norm_stats)
            if opt.norm_stats else None)
    loader = NativeLoader(rows=80)
    logits_all, running_loss, n_batches = [], 0.0, 0
    for i in range(0, len(paths), opt.batch_size):
        mel = loader.load_batch(paths[i: i + opt.batch_size], opt.mel_len, mode="tile")
        if norm is not None:
            mel = norm(mel).astype(np.float32)
        with torch.no_grad(), full_fp32():
            logits = embed(model, torch.from_numpy(mel).to(device))[0].cpu()
        y = torch.from_numpy(y_all[i: i + opt.batch_size])
        running_loss += float(F.cross_entropy(logits, y))
        n_batches += 1
        logits_all.append(logits.numpy())
    out = eval_metrics(y_all, np.concatenate(logits_all), topk=(1, min(5, num_classes)))
    out["avg_loss"] = running_loss / max(n_batches, 1)
    out["param_num"] = int(sum(v.numel() for v in model.state_dict().values()))
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in out.items()}))
    return out


if __name__ == "__main__":
    main()

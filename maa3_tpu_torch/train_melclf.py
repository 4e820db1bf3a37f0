"""Mel-classifier trainer on the port (the flags of scripts/train_melclf.py,
plus --device; vggishish/train_vggishish.py and train_melception.py's job):
trains the FD / KL eval backbone on (mel_path, label) manifests.

    python -m maa3_tpu_torch.train_melclf --tsv train.tsv [--val_tsv val.tsv] \\
        [--backbone vggishish|melception] [--small] [--cls_weights] [--norm] \\
        [--ckpt_dir logs/melclf] [--device cuda]

Labels are integers, or class names indexed in sorted order when
--num_classes is 0. Each step draws --batch_size rows with
np.random.RandomState(0), reads them with the native loader in tile mode,
optionally z-normalises them (--norm: statistics of this manifest's mels,
cached under --norm_cache), and takes one step of optax.adamw(lr) as
torch.optim.AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4, no
clipping) on mean(ce * w[y]): w = 1 / class counts with --cls_weights,
else ones (F.cross_entropy(weight=) would divide by the weights' sum).
The Melception trains with its aux head's logits, added at --aux_weight
(0 by default, as the reference ships it; its parameters then take
optax's zero gradient, so weight decay still shrinks them). Steps run in fp32 without TF32
from torch.Generator seed 0. Validation (--val_tsv) prints accuracy@k,
mAP, mROCAUC and d-prime. The result is <ckpt_dir>/final.pt
(eval/classifier.checkpoint), which cal_fd_score and predict_melclf read;
its BatchNorms keep no running statistics, as JAX's do not.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tsv", required=True)
    p.add_argument("--mel_len", type=int, default=624)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--num_classes", type=int, default=0, help="0 = infer from labels")
    p.add_argument("--small", action="store_true", help="small conv stack")
    p.add_argument("--ckpt_dir", default="logs/melclf")
    p.add_argument("--backbone", default="vggishish", choices=["vggishish", "melception"])
    p.add_argument("--aux_weight", type=float, default=0.0)
    p.add_argument("--cls_weights", action="store_true",
                   help="weight CE by 1/class_counts")
    p.add_argument("--val_tsv", default="")
    p.add_argument("--val_every", type=int, default=0, help="0 = only at the end")
    p.add_argument("--norm", action="store_true",
                   help="frequency-wise z-norm from training-set stats")
    p.add_argument("--norm_cache", default="./data/", help="stats cache dir")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def labels_of(rows, num_classes: int, lut=None):
    """(class ids, class-name table or None, num_classes) as the JAX CLI
    reads them; a given lut maps names (the validation manifest)."""
    labels = [r["label"] for r in rows]
    if lut is not None:
        return np.array([lut[lab] for lab in labels], np.int64), lut, len(lut)
    if num_classes == 0:
        classes = sorted(set(labels))
        lut = {c: i for i, c in enumerate(classes)}
        return np.array([lut[lab] for lab in labels], np.int64), lut, len(classes)
    return np.array([int(lab) for lab in labels], np.int64), None, num_classes


def make_optimizer(params, lr: float) -> torch.optim.Optimizer:
    """optax.adamw(lr): b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def weighted_ce(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """mean(ce * w[y]) (scripts/train_melclf.py:135-138)."""
    return (F.cross_entropy(logits, y, reduction="none") * w[y]).mean()


def init_model(backbone: str, num_classes: int, small: bool):
    """The classifier training starts from (torch.Generator seed 0)."""
    from maa3_tpu_torch.eval.classifier import new_classifier
    return new_classifier(backbone, num_classes, small)


def main(argv=None):
    opt = parse_args(argv)
    from maa3_tpu_torch.data.datasets import read_tsv
    from maa3_tpu_torch.eval.classifier import checkpoint, embed, train_forward
    from maa3_tpu_torch.eval.metrics import metrics as eval_metrics
    from maa3_tpu_torch.native.io import NativeLoader
    from maa3_tpu_torch.pipeline import full_fp32

    device = torch.device(opt.device)
    rows = read_tsv(opt.tsv)
    y_all, lut, num_classes = labels_of(rows, opt.num_classes)
    paths = [r["mel_path"] for r in rows]
    print(f"{len(rows)} samples, {num_classes} classes")

    norm = None
    if opt.norm:
        from maa3_tpu_torch.data.transforms import StandardNormalizeAudio
        norm = StandardNormalizeAudio(os.path.dirname(paths[0]) or ".",
                                      cache_path=opt.norm_cache, train_paths=paths)
        print(f"norm stats cached -> {norm.cache_path}")

    model = init_model(opt.backbone, num_classes, opt.small).to(device).train()
    if opt.cls_weights:
        counts = np.bincount(y_all, minlength=num_classes).astype(np.float32)
        w_cls = torch.from_numpy(1.0 / np.maximum(counts, 1.0))
    else:
        w_cls = torch.ones(num_classes)
    w_cls = w_cls.to(device)
    optimizer = make_optimizer(model.parameters(), opt.lr)
    loader = NativeLoader(rows=80)

    def load(batch_paths):
        mel = loader.load_batch(batch_paths, opt.mel_len, mode="tile")
        if norm is not None:
            mel = norm(mel).astype(np.float32)
        return torch.from_numpy(mel).to(device)

    val_paths, val_y = [], None
    if opt.val_tsv:
        vrows = read_tsv(opt.val_tsv)
        val_paths = [r["mel_path"] for r in vrows]
        val_y = labels_of(vrows, num_classes, lut)[0]

    def run_val(it):
        logits_all = []
        with torch.no_grad(), full_fp32():
            for i in range(0, len(val_paths), opt.batch_size):
                logits_all.append(embed(
                    model, load(val_paths[i: i + opt.batch_size]))[0].cpu().numpy())
        m = eval_metrics(val_y, np.concatenate(logits_all),
                         topk=(1, min(5, num_classes)))
        print(f"val@{it} " + json.dumps({k: round(v, 4) for k, v in m.items()}),
              flush=True)
        return m

    rng = np.random.RandomState(0)
    os.makedirs(opt.ckpt_dir, exist_ok=True)
    losses, step_s, val = [], [], None
    t0 = time.time()
    for it in range(opt.steps):
        ts = time.perf_counter()
        idx = rng.randint(0, len(rows), opt.batch_size)
        mel = load([paths[i] for i in idx])
        y = torch.from_numpy(y_all[idx]).to(device)
        with full_fp32():
            logits, aux = train_forward(model, mel)
            loss = weighted_ce(logits, y, w_cls)
            if aux is not None and opt.aux_weight > 0:
                loss = loss + opt.aux_weight * weighted_ce(aux, y, w_cls)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            for p in model.parameters():  # optax decays the unused aux head too
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            optimizer.step()
        losses.append(loss.detach())
        step_s.append(time.perf_counter() - ts)
        if it % 50 == 0 or it == opt.steps - 1:
            acc = (logits.argmax(-1) == y).float().mean()
            print(f"step {it}  loss {float(loss.detach()):.4f}  acc {float(acc):.3f}  "
                  f"({it / max(time.time() - t0, 1e-9):.2f} it/s)", flush=True)
        if val_paths and opt.val_every and it % opt.val_every == opt.val_every - 1:
            val = run_val(it)
    if val_paths:
        val = run_val(opt.steps - 1)

    path = os.path.join(os.path.abspath(opt.ckpt_dir), "final.pt")
    classes = sorted(lut, key=lut.get) if lut is not None else None
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(checkpoint(model, opt.backbone, num_classes, classes), tmp)
    os.replace(tmp, path)
    print(f"saved -> {path}")
    return {"ckpt": path, "losses": [float(x) for x in losses], "step_s": step_s,
            "val": val}


if __name__ == "__main__":
    main()

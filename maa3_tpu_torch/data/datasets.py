"""Host-side training data: TSV manifests -> numpy batches (counterpart of
maa3_tpu/data/datasets.py, the parts the text-to-audio trainer uses).

- `TextSpecDataset` (txt_spec_dataset.py:13-107): each mel cropped or tiled
  to spec_crop_len, captions dropped to "" with probability `drop` (for
  classifier-free guidance), the valid/test split the first 100 rows; rows
  with a `moments_path` give cached VAE posterior moments instead, on the
  latent grid; an unreadable file becomes a constant stand-in (pad value for
  mels, zeros for moments) so one bad file does not stop training.
- `BucketBatchSampler` (DDPIndexBatchSampler :240-318, one device):
  batches of consecutive indices and an epoch-seeded shuffle of the batches.

Files are read with numpy in the calling thread.
"""

from __future__ import annotations

import csv
import math
from typing import Iterator, List, Sequence

import numpy as np


def read_tsv(path: str) -> List[dict]:
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t", quotechar=None,
                                doublequote=False, lineterminator="\n",
                                quoting=csv.QUOTE_NONE)
        return [dict(r) for r in reader]


def _load(path: str, fallback_shape, fallback_value: float) -> np.ndarray:
    try:
        return np.load(path).astype(np.float32)
    except (OSError, ValueError) as e:
        print(f"unreadable {path}: {e}", flush=True)
        return np.full(fallback_shape, fallback_value, np.float32)


def _crop_or_tile(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[1] < n:
        a = np.tile(a, math.ceil(n / a.shape[1]))
    return a[:, :n]


class TextSpecDataset:
    """Fixed-length text-to-spectrogram dataset."""

    def __init__(self, split: str, dataset_name: str, spec_crop_len: int = 624,
                 drop: float = 0.0, mel_num: int = 80, seed: int = 0,
                 latent_downsample: int = 2, moments_dim: int = 40):
        self.samples = read_tsv(dataset_name)
        if split in ("valid", "test"):
            self.samples = self.samples[:100]
        self.crop_len = spec_crop_len
        self.drop = drop
        self.mel_num = mel_num
        self.rng = np.random.RandomState(seed)
        self.latent_downsample = latent_downsample
        self.moments_dim = moments_dim  # 2 * embed_dim, for unreadable files

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        data = self.samples[idx]
        if self.rng.uniform() > self.drop:
            caption = {"ori_caption": data["ori_cap"],
                       "struct_caption": data.get("caption", data["ori_cap"])}
        else:
            caption = {"ori_caption": "", "struct_caption": ""}
        if data.get("moments_path"):
            tgt = self.crop_len // self.latent_downsample
            m = _load(data["moments_path"], (self.moments_dim, tgt), 0.0)
            return {"caption": caption, "moments": _crop_or_tile(m, tgt)}
        spec = _load(data["mel_path"], (self.mel_num, self.crop_len), 0.0)
        return {"caption": caption, "image": _crop_or_tile(spec, self.crop_len)}

    def collater(self, items: List[dict]) -> dict:
        caption = {
            "ori_caption": [it["caption"]["ori_caption"] for it in items],
            "struct_caption": [it["caption"]["struct_caption"] for it in items],
        }
        key = "moments" if "moments" in items[0] else "image"
        return {key: np.stack([it[key] for it in items]), "caption": caption}


class BucketBatchSampler:
    """Batches of consecutive indices (duration-sorted when the caller sorts
    them), shuffled per epoch."""

    def __init__(self, indices: Sequence[int], batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.indices = list(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.batches = self._build()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.batches = self._build()

    def _build(self) -> List[List[int]]:
        batches = [self.indices[i:i + self.batch_size]
                   for i in range(0, len(self.indices), self.batch_size)]
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            batches = [batches[i] for i in rng.permutation(len(batches))]
        return batches

    def __iter__(self) -> Iterator[List[int]]:
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)

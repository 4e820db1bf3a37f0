"""Mel transforms for the eval-classifier protocol (vggishish): the port's
own copy of maa3_tpu/data/transforms.py (numpy only).

Capability parity with ldm/modules/losses_audio/vggishish/transforms.py:13-94:
the upstream FID/KL/mel-classifier numbers are computed over *frequency-wise
z-normalized* mels, with the normalization statistics derived from the
TRAINING split and cached to a text file. Without this transform our
melception/vggishish features are parity-correct but protocol-incomplete.

TPU-native notes: these are host-side numpy transforms applied by the data
loader before mels reach the device (the stats are 2x80 floats — folding
them on-device would gain nothing). Semantics match the reference exactly:

- per-file mean/std over the TIME axis of each (F, T) training mel
  (transforms.py:54-56), then the mean over files of each — NOT a pooled
  global mean/std;
- cache file `train_means_stds_<specs_dir stem>.txt`, two columns
  (mean, std) written with %0.8f (transforms.py:20,62);
- apply: (x - means) / stds with means/stds shaped (F, 1) so it broadcasts
  over (F, T) items and (B, F, T) batches alike (transforms.py:33-39).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


class StandardNormalizeAudio:
    """Frequency-wise z-normalization from training-set statistics.

    Parity: vggishish/transforms.py:13-66 (StandardNormalizeAudio), including
    the stats-caching behaviour: the first construction scans the training
    mels and writes `<cache_dir>/train_means_stds_<stem>.txt`; later
    constructions load the cached file.

    train_ids_path: text file of ids, one per line; each id's mel is
    `<specs_dir>/<id>_mel.npy` (transforms.py:51). Alternatively pass
    `train_paths` with explicit npy paths (our TSV manifests carry full
    mel paths, so id-mangling is optional here).
    """

    def __init__(self, specs_dir: str,
                 train_ids_path: str = "./data/vggsound_train.txt",
                 cache_path: str = "./data/",
                 train_paths: Optional[Sequence[str]] = None):
        self.specs_dir = specs_dir
        self.train_ids_path = train_ids_path
        self.train_paths = train_paths
        self.cache_path = os.path.join(
            cache_path, f"train_means_stds_{Path(specs_dir).stem}.txt")
        stats = self._calculate_or_load_stats()
        self.means = stats["means"]            # (F, 1) float64
        self.stds = stats["stds"]

    def _iter_train_paths(self):
        if self.train_paths is not None:
            return list(self.train_paths)
        with open(self.train_ids_path) as f:
            return [os.path.join(self.specs_dir, f"{line.rstrip()}_mel.npy")
                    for line in f]

    def _calculate_or_load_stats(self) -> dict:
        try:
            train_stats = np.loadtxt(self.cache_path)   # (F, 2)
            means, stds = train_stats.T
        except OSError:
            paths = self._iter_train_paths()
            means_l, stds_l = [], []
            for path in paths:
                spec = np.load(path)
                means_l.append(spec.mean(axis=1))
                stds_l.append(spec.std(axis=1))
            # (F,) <- mean over files of the per-file stats
            means = np.array(means_l).mean(axis=0)
            stds = np.array(stds_l).mean(axis=0)
            os.makedirs(os.path.dirname(self.cache_path) or ".", exist_ok=True)
            np.savetxt(self.cache_path, np.vstack([means, stds]).T,
                       fmt="%0.8f")
        return {"means": means.reshape(-1, 1), "stds": stds.reshape(-1, 1)}

    @classmethod
    def from_stats_file(cls, stats_path: str) -> "StandardNormalizeAudio":
        """Load a previously cached stats txt directly (the eval protocol
        normalizes gen/ref mels with TRAIN-split stats, so eval CLIs point
        here instead of re-deriving from a specs dir)."""
        obj = cls.__new__(cls)
        obj.specs_dir = obj.train_ids_path = None
        obj.train_paths = None
        obj.cache_path = stats_path
        means, stds = np.loadtxt(stats_path).T
        obj.means = means.reshape(-1, 1)
        obj.stds = stds.reshape(-1, 1)
        return obj

    def __call__(self, item):
        """dict with 'input'/'image' (F, T), or an array (..., F, T)."""
        if isinstance(item, dict):
            if "input" in item:
                key = "input"
            elif "image" in item:
                key = "image"
            else:
                raise NotImplementedError(
                    "dict items need an 'input' or 'image' key")
            item[key] = (item[key] - self.means) / self.stds
            return item
        if isinstance(item, np.ndarray):
            # (F, 1) broadcasts over both (F, T) and (B, F, T)
            return (item - self.means) / self.stds
        raise NotImplementedError(f"unsupported item type {type(item)!r}")


class Crop:
    """Center/random crop of an (F, T) mel to cropped_shape = (mel_num, len).

    Parity: vggishish/transforms.py:76-94 (albumentations Center/RandomCrop
    on the trailing two axes); cropped_shape=None is the identity.
    """

    def __init__(self, cropped_shape=None, random_crop: bool = False,
                 rng: Optional[np.random.RandomState] = None):
        self.cropped_shape = tuple(cropped_shape) if cropped_shape else None
        self.random_crop = random_crop
        self.rng = rng or np.random.RandomState()

    def _crop(self, x: np.ndarray) -> np.ndarray:
        f, t = self.cropped_shape
        if x.shape[-2] < f or x.shape[-1] < t:
            raise ValueError(f"mel {x.shape} smaller than crop {(f, t)}")
        if self.random_crop:
            f0 = self.rng.randint(0, x.shape[-2] - f + 1)
            t0 = self.rng.randint(0, x.shape[-1] - t + 1)
        else:  # center crop (albumentations CenterCrop semantics)
            f0 = (x.shape[-2] - f) // 2
            t0 = (x.shape[-1] - t) // 2
        return x[..., f0:f0 + f, t0:t0 + t]

    def __call__(self, item):
        if self.cropped_shape is None:
            return item
        if isinstance(item, dict):
            item["input"] = self._crop(item["input"])
            return item
        return self._crop(item)

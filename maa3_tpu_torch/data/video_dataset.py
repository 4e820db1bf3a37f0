"""Video-to-audio datasets (counterpart of maa3_tpu/data/video_dataset.py,
the reference's ldm/data/video_spec_maa2_dataset.py:12-297): VGGSound split
txts -> mel .npy and CAVP .npz features.

- the mel tiled / truncated to sr * duration / hop frames, the features to
  fps * duration;
- a random window of `truncate` samples (mel and the aligned frames);
- the two-clip concat mix-up half of the time (:108-156);
- CFG dropout replaces the features with empty_vid.npz (zeros if absent);
- a file that fails to load reads as zeros;
- `VideoSpecInpaintDataset`: a random span of 16-frame multiples (at most
  half) masked on the mel and the frames (:240-275).

Every draw comes from one numpy RandomState(seed), in JAX's order, so both
packages give the same windows, mixes, drops and masks from the same seed
and files. Items are numpy arrays; `collater` stacks them.
"""

from __future__ import annotations

import math
import os
from typing import List

import numpy as np


class VideoSpecDataset:
    def __init__(self, split: str, data_dir: str, split_txt_path: str,
                 feat_type: str = "clip", sr: int = 16000, duration: int = 10,
                 truncate: int = 131072, fps: float = 4, drop: float = 0.0,
                 fix_frames: bool = False, hop_len: int = 256, seed: int = 0):
        self.split = "Train" if split == "train" else "Test"
        self.sr, self.duration, self.truncate = sr, duration, truncate
        self.fps, self.fix_frames, self.hop_len = fps, fix_frames, hop_len
        self.drop = drop
        self.min_duration = 2
        self.rng = np.random.RandomState(seed)

        spec_dir = os.path.join(data_dir, "mel_maa2", "npy")
        feat_dir = os.path.join(data_dir, "cavp")
        with open(os.path.join(split_txt_path, f"{self.split}.txt")) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        if self.split == "Test":
            names = names[:200]
        self.names = names
        self.spec_paths = [os.path.join(spec_dir, n + "_mel.npy") for n in names]
        self.feat_paths = [os.path.join(feat_dir, n + ".npz") for n in names]
        self.empty_feat_path = os.path.join(feat_dir, "empty_vid.npz")

    def __len__(self) -> int:
        return len(self.names)

    # -- loading -----------------------------------------------------------

    def _load_feat(self, path: str) -> np.ndarray:
        try:
            return np.load(path)["feat"].astype(np.float32)
        except Exception:
            try:
                return np.load(self.empty_feat_path)["feat"].astype(np.float32)
            except Exception:
                return np.zeros((int(self.fps * self.duration), 512), np.float32)

    def load_spec_and_feat(self, spec_path: str, feat_path: str):
        try:
            spec = np.load(spec_path).astype(np.float32)
        except Exception:
            print(f"corrupted mel: {spec_path}", flush=True)
            spec = np.zeros((80, 625), np.float32)
        if self.rng.uniform() > self.drop:
            feat = self._load_feat(feat_path)
        else:
            feat = self._load_feat(self.empty_feat_path)

        spec_len = int(self.sr * self.duration / self.hop_len)
        if spec.shape[1] < spec_len:
            spec = np.tile(spec, math.ceil(spec_len / spec.shape[1]))
        spec = spec[:, :spec_len]

        feat_len = int(self.fps * self.duration)
        if feat.shape[0] < feat_len:
            feat = np.tile(feat, (math.ceil(feat_len / feat.shape[0]), 1))
        feat = feat[:feat_len]
        return spec, feat

    # -- windows / mixing --------------------------------------------------

    def _single(self, spec, feat):
        if not self.fix_frames:
            start_idx = self.rng.randint(0, self.sr * self.duration - self.truncate)
        else:
            start_idx = 0
        start_frame = int(self.fps * start_idx / self.sr)
        truncate_frame = int(self.fps * self.truncate / self.sr)
        spec_start = int(start_idx / self.hop_len)
        spec_truncate = int(self.truncate / self.hop_len)
        return (spec[:, spec_start : spec_start + spec_truncate],
                feat[start_frame : start_frame + truncate_frame])

    def _concat_mix(self, spec1, spec2, feat1, feat2):
        total = int(self.truncate / self.hop_len)
        min_len = self.min_duration * self.sr // self.hop_len
        len1 = self.rng.randint(min_len, total - min_len)
        len2 = total - len1
        s1 = self.rng.randint(0, total - len1)
        s2 = self.rng.randint(0, total - len2)
        spec = np.concatenate([spec1[:, s1 : s1 + len1], spec2[:, s2 : s2 + len2]],
                              axis=1)
        f1s = int(self.fps * s1 * self.hop_len / self.sr)
        f1l = int(self.fps * len1 * self.hop_len / self.sr)
        f2s = int(self.fps * s2 * self.hop_len / self.sr)
        f2l = int(self.fps * self.truncate / self.sr) - f1l
        feat = np.concatenate([feat1[f1s : f1s + f1l], feat2[f2s : f2s + f2l]])
        return spec, feat

    def __getitem__(self, idx: int) -> dict:
        spec1, feat1 = self.load_spec_and_feat(self.spec_paths[idx],
                                               self.feat_paths[idx])
        if self.rng.uniform() < 0.5 and len(self.names) > 1:
            j = idx
            while j == idx:
                j = self.rng.randint(0, len(self.names))
            spec2, feat2 = self.load_spec_and_feat(self.spec_paths[j],
                                                   self.feat_paths[j])
            spec, feat = self._concat_mix(spec1, spec2, feat1, feat2)
        else:
            spec, feat = self._single(spec1, feat1)
        return {"mix_spec": spec, "mix_video_feat": feat,
                "image": spec, "video_feat": feat}

    def collater(self, items: List[dict]) -> dict:
        return {
            "image": np.stack([it["image"] for it in items]).astype(np.float32),
            "video_feat": np.stack([it["video_feat"] for it in items]).astype(np.float32),
        }


class VideoSpecInpaintDataset(VideoSpecDataset):
    """Adds a random-span mask (16-frame multiples, <=50%) on spec + frames."""

    def __getitem__(self, idx: int) -> dict:
        spec1, feat1 = self.load_spec_and_feat(self.spec_paths[idx],
                                               self.feat_paths[idx])
        spec, feat = self._single(spec1, feat1)
        spec_truncate = spec.shape[1]
        masked = self.rng.randint(1, max(int(spec_truncate * 0.5 // 16), 1) + 1) * 16
        masked_truncate = int(masked * self.hop_len)
        masked_frame = int(self.fps * masked_truncate / self.sr)
        start_idx = self.rng.randint(0, self.truncate - masked_truncate)
        start_frame = int(self.fps * start_idx / self.sr)
        start_spec = int(start_idx / self.hop_len)

        masked_spec = spec.copy()
        masked_spec[:, start_spec : start_spec + masked] = 0.0
        feat = feat.copy()
        feat[start_frame : start_frame + masked_frame] = 0.0
        mask = np.zeros((spec_truncate,), np.float32)
        mask[start_spec : start_spec + masked] = 1.0  # 1 = to inpaint
        return {"image": spec, "masked_spec": masked_spec, "video_feat": feat,
                "mask": mask}

    def collater(self, items: List[dict]) -> dict:
        out = super().collater(items)
        out["masked_spec"] = np.stack([it["masked_spec"] for it in items]).astype(np.float32)
        out["mask"] = np.stack([it["mask"] for it in items]).astype(np.float32)
        return out

"""Host-side training data: TSV manifests -> numpy batches (counterpart of
maa3_tpu/data/datasets.py).

- `TextSpecDataset` (txt_spec_dataset.py:13-107): each mel cropped or tiled
  to spec_crop_len, captions dropped to "" with probability `drop` (for
  classifier-free guidance), the valid/test split the first 100 rows; rows
  with a `moments_path` give cached VAE posterior moments instead, on the
  latent grid; an unreadable file becomes a constant stand-in so one bad
  file does not stop training. `lazy=True` defers the mel reads to
  `collater`, which reads the batch through the native loader
  (native/io.py; an unreadable file becomes pad_value -5, as in JAX).
- `AnyLenSpecDataset` + `collate_spec` (joinaudiodataset_struct_sample_anylen
  .py:14-134): variable-length mels, padded (pad_value -5) or tiled to the
  batch's longest rounded up to a multiple of 4 within [64, spec_crop_len];
  duration-ordered indices; train = rows[100:], valid = rows[:100], test =
  every row with `_add_name_num`'s per-name numbering. `TestManifestDataset`
  (:150-236): one eval TSV.
- `BucketBatchSampler` (DDPIndexBatchSampler :240-318, one device):
  batches of consecutive indices and an epoch-seeded shuffle of the batches.
- `PrefetchLoader` (the torch DataLoader's role): worker threads load the
  sampler's batches ahead, in order, at most `prefetch` at a time; a worker
  holds its prefetch permit before it takes a batch's sequence number (the
  JAX loader's race, ROADMAP §3, is not copied), and `close()` (or leaving
  a `with` block, or closing the pass's generator) stops and joins them.
"""

from __future__ import annotations

import csv
import glob
import math
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from maa3_tpu_torch.native.io import NativeLoader


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


def _round_len(t: int, min_len: int, max_len: int, factor: int) -> int:
    t = max(min_len, min(t, max_len))
    return factor * math.ceil(t / factor)


def collate_spec(specs: Sequence[np.ndarray], mode: str = "pad",
                 pad_value: float = -5.0, min_len: int = 64,
                 max_len: int = 1248, min_factor: int = 4) -> np.ndarray:
    """Batch (C, T_i) specs to (B, C, T*) with T* = the longest T_i clipped
    to [min_len, max_len] and rounded up to a multiple of min_factor; 'pad'
    fills pad_value after each spec, 'tile' repeats it (zeros past a spec
    that cannot be tiled)."""
    tgt = _round_len(max(s.shape[1] for s in specs), min_len, max_len, min_factor)
    out = np.full((len(specs), specs[0].shape[0], tgt),
                  pad_value if mode == "pad" else 0.0, np.float32)
    for i, s in enumerate(specs):
        s = s[:, :tgt]
        if mode == "tile" and s.shape[1] < tgt:
            s = np.tile(s, math.ceil(tgt / s.shape[1]))[:, :tgt]
        out[i, :, : s.shape[1]] = s
    return out


def _caption(data: dict, rng: np.random.RandomState, drop: float) -> dict:
    if rng.uniform() > drop:
        return {"ori_caption": data["ori_cap"],
                "struct_caption": data.get("caption", data["ori_cap"])}
    return {"ori_caption": "", "struct_caption": ""}


def _collate_captions(items: List[dict]) -> dict:
    return {"ori_caption": [it["caption"]["ori_caption"] for it in items],
            "struct_caption": [it["caption"]["struct_caption"] for it in items]}


class TextSpecDataset:
    """Fixed-length text-to-spectrogram dataset."""

    def __init__(self, split: str, dataset_name: str, spec_crop_len: int = 624,
                 drop: float = 0.0, mel_num: int = 80, seed: int = 0,
                 latent_downsample: int = 2, moments_dim: int = 40,
                 lazy: bool = False):
        self.samples = read_tsv(dataset_name)
        if split in ("valid", "test"):
            self.samples = self.samples[:100]
        self.crop_len = spec_crop_len
        self.drop = drop
        self.mel_num = mel_num
        self.rng = np.random.RandomState(seed)
        self.latent_downsample = latent_downsample
        self.moments_dim = moments_dim  # 2 * embed_dim, for unreadable files
        self.lazy = lazy
        self._native: Optional[NativeLoader] = None

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        data = self.samples[idx]
        caption = _caption(data, self.rng, self.drop)
        if data.get("moments_path"):
            tgt = self.crop_len // self.latent_downsample
            m = _load(data["moments_path"], (self.moments_dim, tgt), 0.0)
            return {"caption": caption, "moments": _crop_or_tile(m, tgt)}
        if self.lazy:
            return {"caption": caption, "mel_path": data["mel_path"]}
        spec = _load(data["mel_path"], (self.mel_num, self.crop_len), 0.0)
        return {"caption": caption, "image": _crop_or_tile(spec, self.crop_len)}

    def collater(self, items: List[dict]) -> dict:
        caption = _collate_captions(items)
        if "mel_path" in items[0]:
            if self._native is None:
                self._native = NativeLoader(rows=self.mel_num)
            image = self._native.load_batch([it["mel_path"] for it in items],
                                            self.crop_len, mode="tile")
            return {"image": image, "caption": caption}
        key = "moments" if "moments" in items[0] else "image"
        return {key: np.stack([it[key] for it in items]), "caption": caption}


class AnyLenSpecDataset:
    """Variable-length dataset of the manifests (*.tsv) in main_spec_dir_path
    (comma-separated directories), with duration-ordered indices."""

    def __init__(self, split: str, main_spec_dir_path: str, mel_num: int = 80,
                 mode: str = "pad", spec_crop_len: int = 1248,
                 pad_value: float = -5.0, drop: float = 0.0, seed: int = 0):
        rows: List[dict] = []
        for dir_path in main_spec_dir_path.split(","):
            for mf in sorted(glob.glob(f"{dir_path}/*.tsv")):
                rows += read_tsv(mf)
        if split == "train":
            samples = rows[100:]
        elif split in ("valid", "val"):
            samples = rows[:100]
        elif split == "test":
            samples = _add_name_num(rows)
        else:
            raise ValueError(f"unknown split {split}")
        self._setup(samples, split, mel_num, mode, spec_crop_len, pad_value, drop, seed)

    def _setup(self, samples, split, mel_num, mode, spec_crop_len, pad_value,
               drop, seed) -> None:
        if mode not in ("pad", "tile"):
            raise ValueError(f"mode {mode!r} is not pad or tile")
        self.samples = samples
        self.split = split
        self.mel_num = mel_num
        self.mode = mode
        self.max_batch_len = spec_crop_len
        self.min_batch_len = 64
        self.min_factor = 4
        self.pad_value = pad_value
        self.drop = drop
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.samples)

    def ordered_indices(self) -> List[int]:
        durs = [float(s.get("duration", 0.0)) for s in self.samples]
        return [int(i) for i in np.argsort(np.asarray(durs), kind="stable")]

    def __getitem__(self, idx: int) -> dict:
        data = self.samples[idx]
        caption = _caption(data, self.rng, self.drop)
        spec = _load(data["mel_path"], (self.mel_num, self.min_batch_len), self.pad_value)
        item = {"image": spec[:, : self.max_batch_len], "caption": caption}
        if self.split == "test":
            item["f_name"] = data["name"]
        return item

    def collater(self, items: List[dict]) -> dict:
        out = {"image": collate_spec([it["image"] for it in items], self.mode,
                                     self.pad_value, self.min_batch_len,
                                     self.max_batch_len, self.min_factor),
               "caption": _collate_captions(items)}
        if "f_name" in items[0]:
            out["f_name"] = [it["f_name"] for it in items]
        return out


def _add_name_num(rows: List[dict]) -> List[dict]:
    """Suffix each name with _N, its count so far, so every audio-caption
    pair is unique (joinaudiodataset_struct_sample_anylen.py:51-64)."""
    counts: Dict[str, int] = {}
    out = []
    for r in rows:
        name = str(r.get("name", ""))
        n = counts.get(name, 0)
        counts[name] = n + 1
        out.append(dict(r, name=f"{name}_{n}"))
    return out


class TestManifestDataset(AnyLenSpecDataset):
    """One eval TSV (TestManifest, :150-236): every row, numbered by name."""

    def __init__(self, manifest: str, mel_num: int = 80, mode: str = "pad",
                 spec_crop_len: int = 1248, pad_value: float = -5.0):
        self._setup(_add_name_num(read_tsv(manifest)), "test", mel_num, mode,
                    spec_crop_len, pad_value, 0.0, 0)


class BucketBatchSampler:
    """Batches of consecutive indices (duration-sorted when the caller sorts
    them), shuffled per epoch, split round-robin over `num_replicas`
    (maa3_tpu/data/datasets.py:279-318): replica `rank` takes
    batches[rank::num_replicas] of the same shuffled list, or batches[0]
    when there are fewer batches than replicas. drop_last drops the partial
    batch, and the batches past the last multiple of num_replicas."""

    def __init__(self, indices: Sequence[int], batch_size: int,
                 num_replicas: int = 1, rank: int = 0, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} of {num_replicas} replicas")
        self.indices = list(indices)
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.batches = self._build()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.batches = self._build()

    def _build(self) -> List[List[int]]:
        batches = [self.indices[i:i + self.batch_size]
                   for i in range(0, len(self.indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            batches = [batches[i] for i in rng.permutation(len(batches))]
        if self.drop_last:
            batches = batches[:len(batches) // self.num_replicas * self.num_replicas]
        if len(batches) >= self.num_replicas:
            return batches[self.rank::self.num_replicas]
        return batches[:1]

    def __iter__(self) -> Iterator[List[int]]:
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


class PrefetchLoader:
    """Batches of `dataset` in `sampler`'s order, loaded ahead by num_workers
    threads, at most `prefetch` loaded or loading at a time. An exception
    raised while loading a batch is raised in its place. Each iteration is
    one pass over the sampler; its workers stop when the pass ends, when the
    consumer closes the pass (its generator's close(), or this loader's
    close() / the end of a `with` block), and are joined before that
    returns."""

    def __init__(self, dataset, sampler, collate_fn=None, prefetch: int = 4,
                 num_workers: int = 1):
        self.dataset = dataset
        self.sampler = sampler
        self.collate = collate_fn or getattr(dataset, "collater", None)
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self._passes: List = []

    def __len__(self) -> int:
        return len(self.sampler)

    def _load(self, batch_idx):
        items = [self.dataset[i] for i in batch_idx]
        return self.collate(items) if self.collate else items

    def __iter__(self):
        gen = self._pass()
        self._passes = [g for g in self._passes if g.gi_frame is not None] + [gen]
        return gen

    def _pass(self):
        batches = list(self.sampler)
        permits = threading.Semaphore(self.prefetch)
        cond = threading.Condition()
        stop = threading.Event()
        done: dict = {}
        taken = [0]

        def worker():
            while True:
                # the permit first, then a sequence number: every permit
                # held belongs to a batch the consumer has not taken yet, so
                # the batch it waits for always gets a worker
                permits.acquire()
                with cond:
                    if stop.is_set() or taken[0] >= len(batches):
                        permits.release()
                        return
                    seq = taken[0]
                    taken[0] += 1
                try:
                    out = self._load(batches[seq])
                except BaseException as e:  # raised in order by the consumer
                    out = e
                with cond:
                    done[seq] = out
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"PrefetchLoader-{i}")
                   for i in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for seq in range(len(batches)):
                with cond:
                    cond.wait_for(lambda: seq in done)
                    out = done.pop(seq)
                permits.release()
                if isinstance(out, BaseException):
                    raise out
                yield out
        finally:
            with cond:
                stop.set()
            for _ in threads:
                permits.release()
            for t in threads:
                t.join()

    def close(self) -> None:
        """Stop and join the workers of every pass still open."""
        for g in self._passes:
            g.close()
        self._passes = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

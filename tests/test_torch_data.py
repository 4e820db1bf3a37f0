"""The port's data layer against the JAX package on the CPU: collate_spec,
AnyLenSpecDataset (order, splits, batches), TestManifestDataset numbering,
the lazy TextSpecDataset, the data section's split and dataset choice, the
native loader (against JAX's NativeLoader and against its own numpy
version, and its refusal to fall back when the compiler fails), and
PrefetchLoader (order, errors in order, a slow first batch, close). Every
wait on a loader thread is bounded by a join with a timeout."""

import os
import threading
import time

import numpy as np
import pytest

from maa3_tpu.data import datasets as jdata
from maa3_tpu.native.io import NativeLoader as JNativeLoader
from maa3_tpu_torch import config as tconfig
from maa3_tpu_torch.data import datasets as tdata
from maa3_tpu_torch.native import io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL = os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XL.yaml")
HEADER = "name\tmel_path\tori_cap\tcaption\tduration"


def _write_rows(path, rows):
    with open(path, "w") as f:
        f.write(HEADER + "\n")
        for r in rows:
            f.write("\t".join(str(r[k]) for k in HEADER.split("\t")) + "\n")


@pytest.fixture(scope="module")
def spec_dir(tmp_path_factory):
    """Two manifests of 105 rows together: mels (8, T) of varied length, some
    names repeated, one missing file."""
    d = tmp_path_factory.mktemp("anylen")
    rng = np.random.RandomState(0)
    rows = []
    for i in range(105):
        p = d / f"m{i}.npy"
        if i != 7:
            np.save(p, rng.randn(8, 30 + (i * 37) % 90).astype(np.float32))
        rows.append({"name": f"clip{i % 40}", "mel_path": p, "ori_cap": f"sound {i}",
                     "caption": f"<sound {i}& all>", "duration": (i * 13) % 29 / 3})
    _write_rows(d / "a.tsv", rows[:60])
    _write_rows(d / "b.tsv", rows[60:])
    return str(d)


@pytest.mark.parametrize("mode", ["pad", "tile"])
def test_collate_spec_matches_jax(mode):
    rng = np.random.RandomState(1)
    for lens in ([10, 37, 5], [70, 3], [2000, 100]):
        specs = [rng.randn(6, n).astype(np.float32) for n in lens]
        got = tdata.collate_spec(specs, mode)
        np.testing.assert_array_equal(got, jdata.collate_spec(specs, mode))
        assert got.shape[2] % 4 == 0 and 64 <= got.shape[2] <= 1248


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_any_len_dataset_matches_jax(spec_dir, split):
    kw = dict(mel_num=8, spec_crop_len=96, drop=0.3, seed=4)
    a = tdata.AnyLenSpecDataset(split, spec_dir, **kw)
    b = jdata.AnyLenSpecDataset(split, spec_dir, **kw)
    assert len(a) == len(b) == {"train": 5, "valid": 100, "test": 105}[split]
    assert a.samples == b.samples
    idx = a.ordered_indices()
    assert idx == [int(i) for i in b.ordered_indices()]
    for batch in (idx[:3], idx[3:5], [7, 8] if split != "train" else idx[:2]):
        ta = a.collater([a[i] for i in batch])
        tb = b.collater([b[i] for i in batch])
        np.testing.assert_array_equal(ta["image"], tb["image"])
        assert ta["caption"] == tb["caption"]
        assert ta.get("f_name") == tb.get("f_name")


def test_test_manifest_numbering_matches_jax(spec_dir):
    path = os.path.join(spec_dir, "a.tsv")
    a = tdata.TestManifestDataset(path, mel_num=8, mode="tile", spec_crop_len=64)
    b = jdata.TestManifestDataset(path, mel_num=8, mode="tile", spec_crop_len=64)
    assert a.samples == b.samples
    assert [s["name"] for s in a.samples[:3]] == ["clip0_0", "clip1_0", "clip2_0"]
    assert a.samples[40]["name"] == "clip0_1"
    ta, tb = a.collater([a[i] for i in range(5)]), b.collater([b[i] for i in range(5)])
    np.testing.assert_array_equal(ta["image"], tb["image"])
    assert ta["f_name"] == tb["f_name"]


def test_lazy_text_spec_dataset_matches_jax(spec_dir):
    """lazy=True: the batch read by the native loader, tiled to the crop, a
    missing file filled with -5, as JAX's lazy collater; the same captions."""
    path = os.path.join(spec_dir, "a.tsv")
    a = tdata.TextSpecDataset("train", path, 64, drop=0.5, mel_num=8, seed=2, lazy=True)
    b = jdata.TextSpecDataset("train", path, 64, drop=0.5, mel_num=8, seed=2, lazy=True)
    for batch in ([0, 1, 2], [5, 6, 7, 8]):
        ta, tb = a.collater([a[i] for i in batch]), b.collater([b[i] for i in batch])
        np.testing.assert_array_equal(ta["image"], tb["image"])
        assert ta["caption"] == tb["caption"]
    assert (ta["image"][2] == -5.0).all()  # row 7's file is missing


def test_data_config_split_and_dataset_choice(spec_dir):
    """The train entry's manifest; a missing validation entry falls back to the
    train entry's valid split without caption drop; a dataset_cfg with
    main_spec_dir_path chooses AnyLenSpecDataset (scripts/train.py
    build_loader)."""
    cfg = tconfig.load_config([XL])
    train = tconfig.parse_data_config(cfg)
    val = tconfig.parse_data_config(cfg, "validation")
    assert (train.split, train.drop, train.any_len) == ("train", 0.2, False)
    assert (val.split, val.drop, val.dataset_name) == ("valid", 0.0, train.dataset_name)
    dp = "data.params.train.params.dataset_cfg."
    cfg = tconfig.load_config([XL], ["data.params.train.target=x.AnyLen",
                                     dp + "dataset_name=null",
                                     dp + f"main_spec_dir_path={spec_dir}"])
    del cfg["data"]["params"]["train"]["params"]["dataset_cfg"]["dataset_name"]
    spec = tconfig.parse_data_config(cfg)
    assert (spec.any_len, spec.dataset_name, spec.spec_crop_len) == (True, spec_dir, 624)
    cfg["data"]["params"]["validation"] = {
        "target": "ldm.data.txt_spec_dataset.spec_join_Dataset_Valid",
        "params": {"dataset_cfg": {"dataset_name": "val.tsv", "spec_crop_len": 312}}}
    val = tconfig.parse_data_config(cfg, "validation")
    assert (val.any_len, val.dataset_name, val.spec_crop_len, val.split) == (
        False, "val.tsv", 312, "valid")


# -- the native loader ---------------------------------------------------------

@pytest.fixture(scope="module")
def npys(tmp_path_factory):
    d = tmp_path_factory.mktemp("npys")
    rng = np.random.RandomState(3)
    paths = []
    for i, n in enumerate((50, 130, 200, 7)):
        p = str(d / f"a{i}.npy")
        np.save(p, rng.randn(80, n).astype(np.float32))
        paths.append(p)
    p64 = str(d / "f64.npy")
    np.save(p64, rng.randn(80, 90))
    rows3 = str(d / "rows3.npy")
    np.save(rows3, rng.randn(3, 90).astype(np.float32))
    return paths + [p64, rows3, str(d / "missing.npy")]


@pytest.mark.parametrize("mode", ["pad", "tile"])
def test_native_loader_matches_jax_and_numpy(npys, mode):
    """pad and tile at a target shorter and longer than the files, a float64
    file, a file of another row count and a missing file (both all -5)."""
    t, j = tio.NativeLoader(rows=80), JNativeLoader(rows=80)
    for target in (64, 150):
        got = t.load_batch(npys, target, mode=mode)
        np.testing.assert_array_equal(got, j.load_batch(npys, target, mode=mode))
        np.testing.assert_array_equal(
            got, tio.load_batch_numpy(npys, 80, target, mode=mode))
        assert (got[-2:] == -5.0).all() and not (got[4] == -5.0).all()
    assert t.npy_shape(npys[1]) == (80, 130) == tuple(j.npy_shape(npys[1]))
    with pytest.raises(IOError, match="bad npy"):
        t.npy_shape(npys[-1])


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A compiler that fails makes NativeLoader raise; nothing falls back."""
    monkeypatch.setattr(tio, "CXX", "false")
    monkeypatch.setattr(tio, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(tio, "_LIB", None)
    with pytest.raises(RuntimeError, match="native loader build failed"):
        tio.NativeLoader(rows=80)
    assert not list(tmp_path.rglob("*.so"))


# -- PrefetchLoader -------------------------------------------------------------

def _consume(loader, out, limit=None):
    """Iterate loader into out in a thread; returns the thread and a list
    that receives the exception the loader raised, if any."""
    err = []

    def run():
        try:
            for i, b in enumerate(loader):
                out.append(b)
                if limit is not None and i + 1 >= limit:
                    break
        except Exception as e:
            err.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, err


class _Slow:
    """Items whose load time falls with the index (out-of-order completion);
    item 0 sleeps `first` seconds."""

    def __init__(self, first=0.0, bad=None):
        self.first, self.bad = first, bad

    def __getitem__(self, i):
        time.sleep(self.first if i == 0 else 0.002 * (7 - i % 8))
        if i == self.bad:
            raise RuntimeError(f"corrupt item {i}")
        return i


def _bounded(fn, timeout=60):
    th = threading.Thread(target=fn, daemon=True)
    th.start()
    th.join(timeout=timeout)
    assert not th.is_alive(), f"{fn} still running after {timeout} s"


def _workers():
    return [t for t in threading.enumerate() if t.name.startswith("PrefetchLoader")]


@pytest.mark.parametrize("first", [0.0, 0.5])
def test_prefetch_keeps_order(first):
    """3 workers, prefetch 1: the sampler's order, also when the first batch
    is slow (the other workers must not hold every permit meanwhile); no
    worker is left once the pass ends."""
    sampler = [[i, i + 1] for i in range(0, 24, 2)]
    out = []
    th, err = _consume(tdata.PrefetchLoader(_Slow(first), sampler, collate_fn=list,
                                            prefetch=1, num_workers=3), out)
    th.join(timeout=60)
    assert not th.is_alive() and not err
    assert out == sampler and not _workers()


def test_prefetch_raises_in_order_and_closes():
    """An item that raises ends the pass at its batch, after every earlier
    batch; close() in the middle of a pass stops and joins its workers."""
    sampler = [[i, i + 1] for i in range(0, 16, 2)]
    out = []
    th, err = _consume(tdata.PrefetchLoader(_Slow(bad=5), sampler, collate_fn=list,
                                            prefetch=2, num_workers=3), out)
    th.join(timeout=60)
    assert not th.is_alive()
    assert out == sampler[:2] and len(err) == 1 and "corrupt item 5" in str(err[0])
    assert not _workers()

    loader = tdata.PrefetchLoader(_Slow(), sampler * 4, collate_fn=list, prefetch=2,
                                  num_workers=3)
    first, passes = [], []

    def start():
        passes.append(iter(loader))
        first.append(next(passes[0]))

    _bounded(start)
    assert first == [sampler[0]] and len(_workers()) == 3
    _bounded(loader.close)
    assert not _workers()

    def again():  # a new pass after close, closed by the with block
        with loader as lo:
            first.append(next(iter(lo)))

    _bounded(again)
    assert first == [sampler[0]] * 2 and not _workers()

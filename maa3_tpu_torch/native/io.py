"""ctypes bindings of the native batch loader (loader.cpp).

The library is built at the first `NativeLoader` with
`g++ -O3 -shared -fPIC -std=c++17 -pthread` into build/native-<hash>/ at the
repository root, where <hash> covers the source and the command, so a
changed source rebuilds and an unchanged one is reused; it is written under
a temporary name and renamed into place. A failed build raises: there is no
silent fallback. `load_batch_numpy` is the plain numpy version of
`NativeLoader.load_batch`, the same batch from the same files (tests, and
TextSpecDataset(lazy=False) reads with numpy per item).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build"
CXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LOCK = threading.Lock()
_LIB = None


def build() -> Path:
    """Compile loader.cpp into build/native-<hash>/ unless already built
    there; raises RuntimeError with the compiler's output if it fails."""
    h = hashlib.sha256(" ".join((CXX,) + FLAGS).encode())
    h.update(SRC.read_bytes())
    out_dir = BUILD_ROOT / f"native-{h.hexdigest()[:16]}"
    lib = out_dir / "libmaa3io.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libmaa3io.{os.getpid()}.tmp"
    cmd = [CXX, *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"native loader build failed ({r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        os.replace(tmp, lib)
    except OSError as e:
        raise RuntimeError(f"native loader build failed: {' '.join(cmd)}: {e}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def load() -> ctypes.CDLL:
    """The library, built on first use, with its C signatures set."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.maa3_load_batch.restype = ctypes.c_int
            lib.maa3_load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            lib.maa3_npy_shape.restype = ctypes.c_int
            lib.maa3_npy_shape.argtypes = [ctypes.c_char_p,
                                           ctypes.POINTER(ctypes.c_int64),
                                           ctypes.POINTER(ctypes.c_int64)]
            _LIB = lib
        return _LIB


def _read_one(path: str, rows: int):
    """The (rows, T) float32 array of a .npy the native loader accepts
    (little-endian float32 / float64, C order, 1-D or 2-D, `rows` rows),
    else None."""
    try:
        a = np.load(path)
    except (OSError, ValueError):
        return None
    if (a.dtype not in (np.dtype("<f4"), np.dtype("<f8")) or a.ndim not in (1, 2)
            or (a.ndim == 2 and not a.flags.c_contiguous and a.shape[0] > 1)):
        return None
    a = a.reshape(1, -1) if a.ndim == 1 else a
    return a.astype(np.float32) if a.shape[0] == rows else None


def load_batch_numpy(paths: Sequence[str], rows: int, target_len: int,
                     mode: str = "pad", pad_value: float = -5.0) -> np.ndarray:
    """The plain version of NativeLoader.load_batch: (B, rows, target_len)
    float32, each file cropped to target_len, then tiled ('tile') or padded
    with pad_value ('pad'); a file it cannot read is all pad_value."""
    batch = np.full((len(paths), rows, target_len), pad_value, np.float32)
    for i, p in enumerate(paths):
        a = _read_one(p, rows)
        if a is None or a.shape[1] == 0:
            continue
        a = a[:, :target_len]
        if mode == "tile" and a.shape[1] < target_len:
            a = np.tile(a, math.ceil(target_len / a.shape[1]))[:, :target_len]
        batch[i, :, : a.shape[1]] = a
    return batch


class NativeLoader:
    """Parallel .npy batch loader: paths -> (B, rows, target_len) float32 with
    the crop / tile / pad collate, read by C++ threads (joined before
    load_batch returns)."""

    def __init__(self, rows: int = 80, num_threads: int = 0):
        self.rows = rows
        self.num_threads = num_threads
        self.lib = load()

    def load_batch(self, paths: Sequence[str], target_len: int,
                   mode: str = "pad", pad_value: float = -5.0) -> np.ndarray:
        n = len(paths)
        batch = np.empty((n, self.rows, target_len), np.float32)
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        statuses = (ctypes.c_int * n)()
        self.lib.maa3_load_batch(
            c_paths, n, batch.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.rows, target_len, 1 if mode == "tile" else 0, pad_value,
            self.num_threads, statuses)
        for p, rc in zip(paths, statuses):
            if rc != 0:
                print(f"unreadable {p} (native loader code {rc})", flush=True)
        return batch

    def npy_shape(self, path: str) -> Tuple[int, int]:
        """(rows, cols) from the file's header; a 1-D array is one row."""
        r, c = ctypes.c_int64(), ctypes.c_int64()
        rc = self.lib.maa3_npy_shape(os.fsencode(path), ctypes.byref(r), ctypes.byref(c))
        if rc != 0:
            raise IOError(f"bad npy: {path} ({rc})")
        return int(r.value), int(c.value)

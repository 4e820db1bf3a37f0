"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source is compiled by its own plain `nvcc -c` for sm_90a (no PyTorch
headers, no ninja), all of them started together; one more nvcc call links
the objects into a shared library with a C interface, which is loaded with
ctypes. The library lands in build/kernels-<hash>/ at the repository root,
where <hash> covers the sources and the flags, so a changed source rebuilds
and an unchanged one is reused. The build happens at the first kernel launch
(or an explicit `load()`), never at import; objects and the library are
written under temporary names and the library is renamed into place, so an
interrupted build leaves nothing that a later one would wait on or trust.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "--ptxas-options=-v")
LIB_NAME = "libmaa3_kernels.so"

_lib = None
build_info: dict = {}  # path, seconds (0 when reused), compiler log


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine that runs them")
    return found


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def _run_all(cmds):
    """Run the commands concurrently; raise with the log of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = []
    try:
        for c, p in zip(cmds, procs):
            out, _ = p.communicate(timeout=900)
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{out}")
            logs.append(out.strip())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def build() -> Path:
    """Compile csrc/ into build/kernels-<hash>/ unless already built there."""
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"
    lib = out_dir / LIB_NAME
    if lib.is_file():
        log = out_dir / "nvcc.log"
        build_info.update(path=str(lib), seconds=0.0,
                          log=log.read_text() if log.is_file() else "(reused)")
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = nvcc_path(), os.getpid()
    objs = [out_dir / f"{cu.stem}.{pid}.o" for cu in cus]  # nvcc reads the suffix
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    t0 = time.perf_counter()
    try:
        logs = _run_all([[nvcc, *COMPILE_FLAGS, "-I", str(SRC_DIR), "-c", str(cu),
                          "-o", str(o)] for cu, o in zip(cus, objs)])
        logs += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "\n".join(x for x in logs if x)
    (out_dir / "nvcc.log").write_text(log + "\n")
    build_info.update(path=str(lib), seconds=seconds, log=log)
    return lib


# The C signature of every extern "C" function in csrc/*.cu, as (return
# type, argument types): c_void_p for each pointer and the stream, c_int,
# c_float, c_longlong. tests/test_torch_hygiene.py holds it to the sources.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "maa3_aa_snake": (_I, (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    "maa3_conv_snake": (_I, (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P)),
    "maa3_conv_snake_smem": (ctypes.c_longlong, (_I, _I, _I, _I, _I)),
    "maa3_flash_fwd": (_I, (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P)),
    "maa3_flash_bwd": (_I, (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _F, _F, _I, _P)),
    "maa3_flash_bwd_dkv": (_I, (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _F, _I, _P)),
    "maa3_flash_bwd_dq": (_I, (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                               _F, _I, _P)),
    "maa3_residual_norm_modulate": (_I, (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                          _P)),
    "maa3_rope_qkv_heads": (_I, (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "maa3_swiglu": (_I, (_P, _P, ctypes.c_longlong, _I, _P)),
    "maa3_gated_merge_heads": (_I, (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
}


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, list(argtypes)
        _lib = lib
    return _lib


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream

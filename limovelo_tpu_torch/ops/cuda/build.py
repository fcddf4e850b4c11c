"""Build and load the port's CUDA kernels (`limovelo_tpu_torch/csrc/*.cu`),
and check the tensors their wrappers hand them.

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface, at first use, into `build/kernels/` at the
root of the checkout (listed in `.gitignore`).  The library's file name
carries a hash of its source, so an edited kernel is rebuilt and a stale one
is never loaded.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: nvcc's output of the builds this process ran (ptxas: registers, shared
#: memory and spills of each kernel), by source name
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA kernels "
                           "are built on the machine that has the card")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for `csrc/<name>.cu` into a temporary file; returns
    (process, temp path, final path), or None when the library exists."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log.decode(errors="replace")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{build_logs[name]}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file


def build(names: Iterable[str]) -> None:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together."""
    names = list(names)
    started = [(n, _start(n)) for n in names]
    for n, s in started:
        _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`:
    a kernel takes its arguments as raw pointers."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

"""ctypes bindings of the native host-ingest library (`ingest.cpp`, a copy of
`limovelo_tpu/native/ingest.cpp`).

The shared object is compiled with g++ at first use into `build/native/` at
the root of the checkout (listed in `.gitignore`); its file name carries a
hash of the source and the flags, so an edited source is rebuilt and a stale
library is never loaded.  It is built without `-march=native`: a build
directory copied to another host must still load there.  A failed build
raises: there is no silent fallback.  The `*_plain` functions are the numpy
versions of the same semantics, which the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

#: sensor_msgs/PointField datatype codes → numpy dtypes
PF_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}
#: the datatypes that the library's field extractors decode (f32, f64 out)
_NATIVE_FIELD_TYPES = {False: (4, 5, 6, 7, 8), True: (6, 7, 8)}

_lib = None
_lock = threading.Lock()

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libingest-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    r = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp], capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {SRC.name}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, out_p in (("pc2_extract_field", _f32p), ("pc2_extract_field_f64", _f64p)):
                fn = getattr(lib, name)
                fn.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_int32, out_p]
                fn.restype = ctypes.c_int
            lib.process_scan.argtypes = [_f32p, _f64p, ctypes.c_int64, ctypes.c_int32,
                                         ctypes.c_double, _f32p, _f64p]
            lib.process_scan.restype = ctypes.c_int64
            lib.process_scan_idx.argtypes = [_f32p, _f64p, ctypes.c_int64, ctypes.c_int32,
                                             ctypes.c_double, _f32p, _f64p, _i64p]
            lib.process_scan_idx.restype = ctypes.c_int64
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def process_scan(xyz: np.ndarray, t: np.ndarray, downsample_rate: int, min_dist: float,
                 intensity: np.ndarray | None = None):
    """Fused temporal downsample (every `downsample_rate`-th point by a
    running counter) + min-range filter (|p| > min_dist, finite) + stable
    time sort → (xyz, t), or (xyz, t, intensity) when `intensity` (N,) is
    given (the channel rides along through the survivors' indices)."""
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    t = np.ascontiguousarray(t, np.float64)
    n = len(xyz)
    if len(t) != n or (intensity is not None and len(intensity) != n):
        raise ValueError(f"process_scan: {n} points, {len(t)} times, "
                         f"{None if intensity is None else len(intensity)} intensities")
    lib = get_lib()
    xyz_out = np.empty_like(xyz)
    t_out = np.empty_like(t)
    args = (_ptr(xyz, ctypes.c_float), _ptr(t, ctypes.c_double), n, int(downsample_rate),
            float(min_dist), _ptr(xyz_out, ctypes.c_float), _ptr(t_out, ctypes.c_double))
    if intensity is None:
        m = lib.process_scan(*args)
        return xyz_out[:m].copy(), t_out[:m].copy()
    idx_out = np.empty(n, np.int64)
    m = lib.process_scan_idx(*args, _ptr(idx_out, ctypes.c_int64))
    inten = np.ascontiguousarray(intensity, np.float32)[idx_out[:m]]
    return xyz_out[:m].copy(), t_out[:m].copy(), inten


def process_scan_plain(xyz: np.ndarray, t: np.ndarray, downsample_rate: int, min_dist: float,
                       intensity: np.ndarray | None = None):
    """`process_scan` in numpy (the same semantics)."""
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    t = np.ascontiguousarray(t, np.float64)
    n = len(xyz)
    counter = np.arange(1, n + 1)
    keep = np.ones(n, bool) if downsample_rate <= 1 else (counter % downsample_rate) == 0
    keep &= np.isfinite(xyz).all(axis=1)
    keep &= (xyz.astype(np.float64) ** 2).sum(1) > min_dist * min_dist
    idx = np.nonzero(keep)[0]
    order = idx[np.argsort(t[idx], kind="stable")]
    if intensity is None:
        return xyz[order], t[order]
    return xyz[order], t[order], np.asarray(intensity, np.float32)[order]


def extract_field(data: bytes, n: int, point_step: int, offset: int, datatype: int,
                  f64: bool = False) -> np.ndarray:
    """Decode one PointCloud2 field of `n` points from the raw byte blob into
    float32 (float64 with `f64`).  The library decodes the datatypes in
    `_NATIVE_FIELD_TYPES`; the others go through the numpy version."""
    if datatype not in _NATIVE_FIELD_TYPES[f64]:
        return extract_field_plain(data, n, point_step, offset, datatype, f64)
    buf = np.frombuffer(data, np.uint8)
    if len(buf) < n * point_step or offset + np.dtype(PF_DTYPES[datatype]).itemsize > point_step:
        raise ValueError(f"extract_field: {len(buf)} bytes for {n} points of {point_step}, "
                         f"field at {offset}")
    out = np.empty(n, np.float64 if f64 else np.float32)
    fn = get_lib().pc2_extract_field_f64 if f64 else get_lib().pc2_extract_field
    rc = fn(_ptr(buf, ctypes.c_uint8), n, point_step, offset, datatype,
            _ptr(out, ctypes.c_double if f64 else ctypes.c_float))
    if rc != 0:
        raise RuntimeError(f"pc2_extract_field returned {rc} for datatype {datatype}")
    return out


def extract_field_plain(data: bytes, n: int, point_step: int, offset: int, datatype: int,
                        f64: bool = False) -> np.ndarray:
    """`extract_field` in numpy (the same semantics, every datatype)."""
    buf = np.frombuffer(data, np.uint8)
    dt = PF_DTYPES[datatype]
    nbytes = np.dtype(dt).itemsize
    col = buf[: n * point_step].reshape(n, point_step)[:, offset: offset + nbytes]
    return col.copy().view(dt).reshape(n).astype(np.float64 if f64 else np.float32)

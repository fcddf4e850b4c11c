#!/usr/bin/env python3
"""Time the grouped-KNN kernel of this checkout against the same kernel
built from another source file that exports the same C entry point
(`knn_grouped_launch`, same arguments), for example an earlier commit's:

    mkdir -p build/other
    git show <commit>:limovelo_tpu_torch/csrc/knn_grouped.cu > build/other/knn_grouped.cu
    python3 compare_knn_kernel.py build/other/knn_grouped.cu

Both kernels run on `chip_smoke.py`'s kernel-phase inputs (the same map,
queries and six shapes) and are timed with its timer (`chip_smoke.time_ms`),
in the order other, this, this, other for each shape, so that drift over
the run shows.  Both are launched through the same ctypes call into
preallocated outputs, and each one's raw outputs are held to the output
contract against the plain version first.  Prints one JSON line per shape,
then nvidia-smi's name and power limit; needs one card.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke


def build_other(src: Path) -> ctypes.CDLL:
    """`src` built with the flags of the port's own kernels, into build/kernels."""
    from limovelo_tpu_torch.ops.cuda import build

    digest = hashlib.sha1(src.read_bytes() + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:12]
    out = build.BUILD_DIR / f"libother-{digest}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def launcher(lib: ctypes.CDLL, args, out):
    """One launch of `lib`'s kernel on `args` into `out` = (sq, idx)."""
    bucket_ids, order_q, centers, map_pts, k = args
    fn = lib.knn_grouped_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    G, NB = bucket_ids.shape
    ptrs = [t.data_ptr() for t in (bucket_ids, order_q, centers, map_pts, *out)]

    def launch():
        err = fn(*ptrs, G, NB, k, map_pts.shape[1], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"kernel launch failed: cudaError {err}")
        return out
    return launch


def contract(launch, grp, map_pts, want) -> str:
    from limovelo_tpu_torch.ops.cuda import knn

    try:
        knn.check_topk_contract(grp.order_q, grp.bucket_ids, map_pts.shape[1], launch(), want)
    except AssertionError as e:
        return str(e)
    return "ok"


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_knn_kernel: no CUDA device", file=sys.stderr)
        return 2
    from limovelo_tpu_torch.ops.cuda import build, knn

    dev = torch.device("cuda")
    libs = {"other": build_other(Path(sys.argv[1])), "this": build.load("knn_grouped")}
    world, sim = chip_smoke.make_sim()
    world_pts, scan_w, sensor = chip_smoke.kernel_views(world, sim)
    params, m = chip_smoke.kernel_map(world_pts, dev)
    k = chip_smoke.K
    for n, _, q, rings, mb in chip_smoke.kernel_shapes(scan_w, sensor, dev):
        grp = knn.group_queries(m, q, params, max(n // 4, 64), rings=rings, max_buckets=mb)
        args = (grp.bucket_ids, grp.order_q, grp.centers, m.pts, k)
        want = knn.group_topk_plain(*args)
        G = grp.bucket_ids.shape[0]
        launch = {name: launcher(lib, args, (
            torch.empty((G, knn.GROUP_CAP, k), dtype=torch.float32, device=dev),
            torch.empty((G, knn.GROUP_CAP, k), dtype=torch.int32, device=dev)))
            for name, lib in libs.items()}
        line = {"n": n, "rings": rings, "nb": int(grp.bucket_ids.shape[1])}
        for name in libs:
            line[f"{name}_contract"] = contract(launch[name], grp, m.pts, want)
        for name in libs:
            line[f"{name}_ms"] = []
        for name in ("other", "this", "this", "other"):
            line[f"{name}_ms"].append(chip_smoke.time_ms(launch[name]))
        chip_smoke.emit(line)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

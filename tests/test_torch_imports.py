"""The port stands alone: no module of `limovelo_tpu_torch`, and neither
chip_smoke.py nor compare_knn_kernel.py, imports JAX or the JAX package, and
its entry points run on
the card unless the caller asks for the CPU."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import limovelo_tpu_torch
from limovelo_tpu_torch import DEFAULT
from limovelo_tpu_torch.runtime.pipeline import LioPipeline

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "limovelo_tpu_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "limovelo_tpu_torch."))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "limovelo_tpu") or top.startswith("jax")


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "limovelo_tpu_torch.ops.cuda.knn" in mods and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'limovelo_tpu')\n"
        "             or k.startswith('jax'))\n"
        "print(len(bad), bad[:5])\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_jax_import_in_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "compare_knn_kernel.py"]
    found = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(f.name, n) for n in names if _forbidden(n)]
    assert not found


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LioPipeline(DEFAULT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        limovelo_tpu_torch.resolve_device()
    # the CPU only when asked for
    assert LioPipeline(DEFAULT, device="cpu").device.type == "cpu"


def test_lifecycle_and_slam_entry_points_default_to_the_card(tmp_path):
    """The lifecycle and SLAM entry points take `device` too, default
    "cuda", and raise without a card; the CLI takes `--device` (default
    "cuda"), its multi-device flags included."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    import numpy as np

    from limovelo_tpu_torch.graph import PoseGraph, optimize_pose_graph, register_scan_to_map
    from limovelo_tpu_torch.mapping.hashgrid import GridParams
    from limovelo_tpu_torch.runtime.checkpoint import load_map
    from limovelo_tpu_torch.runtime.slam import SlamPipeline

    hd = tmp_path / "map.npz"
    np.savez(hd, points=np.zeros((1, 3), np.float32))
    g = PoseGraph()
    g.add_odometry_chain(np.stack([np.eye(3)] * 2), np.zeros((2, 3)))
    calls = (lambda: SlamPipeline(DEFAULT),
             lambda: LioPipeline.from_hd_map(DEFAULT, str(hd)),
             lambda: load_map(str(hd), GridParams()),
             lambda: register_scan_to_map(np.zeros((4, 3)), np.zeros((4, 3)), np.eye(3),
                                          np.zeros(3)),
             lambda: optimize_pose_graph(g, np.stack([np.eye(3)] * 2), np.zeros((2, 3))))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert SlamPipeline(DEFAULT, device="cpu").device.type == "cpu"
    assert LioPipeline.from_hd_map(DEFAULT, str(hd), device="cpu").config.mapping_mode == "none"
    from limovelo_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sim", "--world", "room", "--duration", "0.1"])
    for flag in (["--devices", "2"], ["--devices", "2", "--shard", "map"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["sim", "--world", "room", "--duration", "0.1", *flag])


def test_parallel_entry_points_default_to_the_card(tmp_path):
    """`parallel/` imports no JAX (the tests above walk it); its entry
    points take the card unless asked for the CPU: the spawn helper and
    `make_mesh` raise without one, a mesh on the CPU carries
    `LioPipeline(mesh=...)` there, and nccl refuses the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    import torch.distributed as dist

    from limovelo_tpu_torch.parallel import multihost as mh
    from limovelo_tpu_torch.parallel.sharding import Mesh, make_mesh

    assert "limovelo_tpu_torch.parallel.map_sharding" in _modules()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mh.spawn(print, 2)
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        Mesh(0, 1, "cpu", "nccl")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        mesh = make_mesh("cpu")
        assert (mesh.rank, mesh.size, mesh.backend, mesh.host_staging) == (0, 1, "gloo", False)
        assert LioPipeline(DEFAULT, mesh=mesh).device.type == "cpu"
        assert mh.global_mesh("cpu").device.type == "cpu"
    finally:
        dist.destroy_process_group()

"""Multi-process bring-up: run the sharded LIO step across ranks (port of
`limovelo_tpu/parallel/multihost.py`).

One process per rank; `torch.distributed` carries the collectives.

- `init_distributed()` joins the process group from explicit arguments,
  else from `COORDINATOR_ADDRESS` / `NUM_PROCESSES` / `PROCESS_ID` (the JAX
  package's variables), else from torchrun's `MASTER_ADDR` / `WORLD_SIZE` /
  `RANK`; with none of them set it does nothing.
- `global_mesh()` is the mesh over every rank of the world.
- `window_from_local(...)`: each rank feeds only its own rows of the
  window, placed on its device; every rank must pass the same row count.
- `replicate(...)`: the state every rank holds alike, on the rank's device.
- `spawn(fn, D, ...)` starts D ranks on this machine (a file rendezvous in
  a temporary directory, `torch.multiprocessing` with the spawn method, a
  timeout on the process group and on the join) and returns each rank's
  result.  The CLI's `--devices`, the tests and `chip_smoke.py` use it.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import uuid
from datetime import timedelta
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .sharding import AXIS, Mesh, make_mesh, rank_device

__all__ = ["AXIS", "init_distributed", "global_mesh", "window_from_local", "replicate",
           "local_point_budget", "default_backend", "spawn"]

#: seconds a collective, the rendezvous and a spawned world's join may take
DEFAULT_TIMEOUT_S = 600.0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group (idempotent); returns whether one is set up.

    Each of address, world size and rank resolves from its argument, then
    `COORDINATOR_ADDRESS` ("host:port") / `NUM_PROCESSES` / `PROCESS_ID`,
    then torchrun's `MASTER_ADDR`:`MASTER_PORT` / `WORLD_SIZE` / `RANK`.
    With none of them set, there is nothing to join: a no-op.  `backend`
    defaults to `default_backend(world size, device)`."""
    if dist.is_initialized():
        return True
    env = os.environ
    torchrun = "WORLD_SIZE" in env and "RANK" in env and "MASTER_ADDR" in env
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        n = env.get("NUM_PROCESSES", env.get("WORLD_SIZE"))
        num_processes = None if n is None else int(n)
    if process_id is None:
        r = env.get("PROCESS_ID", env.get("RANK"))
        process_id = None if r is None else int(r)
    if addr is None and num_processes is None and process_id is None:
        return False
    if addr is not None:
        init_method = f"tcp://{addr}"
    elif torchrun:
        # torchrun's own store, which its agent may already host
        init_method = "env://"
    else:
        raise ValueError(f"incomplete rendezvous: world size {num_processes!r}, rank "
                         f"{process_id!r}, no address")
    if num_processes is None or process_id is None:
        raise ValueError(f"incomplete rendezvous: address {addr!r}, world size "
                         f"{num_processes!r}, rank {process_id!r}")
    dist.init_process_group(backend or default_backend(num_processes, device),
                            init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))
    return True


def global_mesh(device="cuda") -> Mesh:
    """The 1-D mesh over every rank of the world, in rank order (a rank's
    shard of the window is the rows it fed)."""
    return make_mesh(device)


def window_from_local(mesh: Mesh, pts_local, pts_t_local, mask_local):
    """The rank's rows of the point-sharded window, on its device.  Every
    rank must pass the same row count (pad to the bucket first): checked
    with an all-gather of the counts."""
    n = len(pts_local)
    counts = mesh.all_gather(torch.tensor([n], dtype=torch.int64, device=mesh.device))
    if not bool((counts == n).all()):
        raise ValueError(f"ranks pass different row counts: {counts.tolist()}")
    put = lambda a: torch.as_tensor(np.asarray(a)).to(mesh.device)
    return put(pts_local), put(pts_t_local), put(mask_local)


def replicate(mesh: Mesh, tree):
    """Place `tree` (tensors or arrays in NamedTuples, tuples, lists, dicts)
    on the rank's device.  Every rank passes the same values: the filter
    state, the IMU windows, a map."""
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        return torch.as_tensor(tree).to(mesh.device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(mesh, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(mesh, v) for v in tree)
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    return tree


def local_point_budget(mesh: Mesh, global_bucket: int) -> int:
    """Rows of a point-sharded (global_bucket, ...) window that each rank
    holds; the bucket must divide by the world size."""
    if global_bucket % mesh.size:
        raise ValueError(f"point bucket {global_bucket} must divide by the world size "
                         f"{mesh.size}")
    return global_bucket // mesh.size


def default_backend(world_size: int, device="cuda") -> str:
    """nccl where every rank owns a card; gloo otherwise (the CPU, or ranks
    sharing a card: NCCL refuses two ranks on one device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available() and (
            dev.index is None and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def _rank_main(rank: int, fn, world_size: int, backend: str, device, init_file: str,
               out_dir: str, timeout_s: float, args: tuple) -> None:
    """One spawned rank: join the group, run fn(mesh, *args), save the
    result for the parent."""
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh(rank_device(device, rank))
        result = fn(mesh, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], world_size: int, args: tuple = (), device="cuda",
          backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
          workdir: Optional[str] = None) -> List[Any]:
    """Run `fn(mesh, *args)` on `world_size` new ranks of this machine and
    return their results in rank order.

    `fn` and `args` are pickled (a module-level function).  Rank r runs on
    cuda:(r % cards) for `device="cuda"`, or on `device` as given.  The
    backend defaults to `default_backend`.  The ranks meet at a rendezvous
    file in `workdir` (a new temporary directory when None).  A rank that
    raises or exits fails the call (the others are stopped); a world that
    has not finished within `timeout_s` seconds is stopped and raises
    TimeoutError."""
    import torch.multiprocessing as mp

    from ..device import resolve_device

    resolve_device(device)
    backend = backend or default_backend(world_size, device)
    tmp = None
    if workdir is None:
        tmp = tempfile.TemporaryDirectory(prefix="limovelo_ranks_")
        workdir = tmp.name
    run_dir = os.path.join(workdir, f"world-{uuid.uuid4().hex[:12]}")
    os.makedirs(run_dir)
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, backend, str(device), os.path.join(run_dir, "rendezvous"),
                  run_dir, timeout_s, tuple(args)))
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(1.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world_size} ranks did not finish within {timeout_s} s")
        results = []
        for r in range(world_size):
            with open(os.path.join(run_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        if tmp is not None:
            tmp.cleanup()

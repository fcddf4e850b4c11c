"""CUDA-graph replay of the iterated update's sync-free stretches.

Between its blocking reads (the "auto" refresh decision, `sync.refresh`,
and each eigensolve, `sync.eigh`) the iterated update
(`filter/update.py`) is a fixed chain of a few hundred small kernels on
fixed shapes, and the host's launches of them, not the card, set its
time.  Each such stretch is recorded once with `torch.cuda.graph` and
replayed afterwards: the same kernels on the same inputs, so a replay
gives what the eager run gives, bit for bit.

A stretch is a function `stretch(v, *args)` of a namespace `v` of named
values (tensors, or NamedTuples of tensors) that returns a dict of new
values for some of the names.  Two runners run it:

- `Eager` calls it and rebinds the names: plain PyTorch, no copies.  The
  update runs so wherever no `UpdateGraphs` is given (the CPU, the
  sharded steps).
- `Graphed` keeps every name in a static buffer.  A stretch's first call
  runs it eagerly (its results are that call's values, written into the
  buffers) and records it; later calls replay the recording, which reads
  the buffers and writes its results into the same buffers.  Values from
  outside the stretches (a window's inputs, a search's results, an
  eigensolve's) enter through `put`, a copy into the buffer.

A recording bakes in the shapes and the Python constants its stretch
reads, so `UpdateGraphs` keeps one `Graphed` per `graph_key`; all
recordings of one key share one memory pool.  Only temporaries live in
the pool (every value that crosses a stretch's end is a buffer allocated
outside it), so the recordings may replay in any order.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict

import torch

from ..runtime import profiling


def graph_key(n_points: int, static_cfg, dyn) -> tuple:
    """Everything a recorded stretch bakes in: the point bucket, the
    neighbour count (the searches' shapes), the `StaticConfig` fields that
    choose which code runs and in which precision, and the `DynParams`
    (thresholds enter as constants)."""
    return (int(n_points), static_cfg.NUM_MATCH_POINTS, static_cfg.match_mode,
            static_cfg.estimate_extrinsics, static_cfg.compute_degeneracy,
            static_cfg.solve_dtype, dyn)


def _tree_map(fn, *trees):
    """`fn` over the tensors of a tensor or a (nested) tuple or NamedTuple
    of tensors."""
    t = trees[0]
    if isinstance(t, tuple):
        parts = [_tree_map(fn, *p) for p in zip(*trees)]
        return type(t)(*parts) if hasattr(t, "_fields") else tuple(parts)
    return fn(*trees)


def _copy(buf: torch.Tensor, value: torch.Tensor) -> None:
    if value is buf:
        return
    if buf.shape != value.shape or buf.dtype != value.dtype:
        # copy_ would broadcast or cast; a recording read the old layout
        raise ValueError(f"a graph buffer of {tuple(buf.shape)} {buf.dtype} "
                         f"given {tuple(value.shape)} {value.dtype}")
    buf.copy_(value)


class Eager:
    """Runs each stretch as plain PyTorch; the namespace `v` holds what it
    returned."""

    def __init__(self):
        self.v = SimpleNamespace()

    def put(self, **values) -> None:
        vars(self.v).update(values)

    def __call__(self, name: str, stretch: Callable, *args) -> None:
        vars(self.v).update(stretch(self.v, *args))

    def out(self, value):
        return value


class Graphed:
    """The static buffers and the recorded stretches of one key."""

    def __init__(self, side_stream: Callable[[], "torch.cuda.Stream"]):
        self.v = SimpleNamespace()
        self._side_stream = side_stream
        self._pool = None
        self._replays: Dict[str, Callable[[], None]] = {}

    def put(self, **values) -> None:
        """Copy `values` into their buffers (a new name gets a buffer of
        its own, a clone)."""
        for name, value in values.items():
            buf = getattr(self.v, name, None)
            if buf is None:
                setattr(self.v, name, _tree_map(torch.clone, value))
            else:
                _tree_map(_copy, buf, value)

    def __call__(self, name: str, stretch: Callable, *args) -> None:
        replay = self._replays.get(name)
        if replay is not None:
            replay()
            profiling.count("update.graph_replays")
            return
        self.put(**stretch(self.v, *args))
        self._replays[name] = self._record(stretch, args)
        profiling.count("update.graph_captures")

    def _write(self, stretch: Callable, args) -> None:
        for name, value in stretch(self.v, *args).items():
            _tree_map(_copy, getattr(self.v, name), value)

    def _record(self, stretch: Callable, args) -> Callable[[], None]:
        """Record `stretch` writing into the buffers; returns its replay."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._side_stream(),
                              capture_error_mode="thread_local"):
            self._write(stretch, args)
        return graph.replay

    def out(self, value):
        """Fresh tensors of `value`: the buffers are overwritten by the next
        update of this key."""
        return _tree_map(torch.clone, value)


class UpdateGraphs:
    """One pipeline's recorded update stretches, one `runner` per
    `graph_key`, all recorded on one side stream of `device`."""

    runner = Graphed

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = None
        self.by_key: Dict[tuple, Graphed] = {}

    def _side_stream(self) -> "torch.cuda.Stream":
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def stretches(self, key: tuple) -> Graphed:
        g = self.by_key.get(key)
        if g is None:
            g = self.by_key[key] = self.runner(self._side_stream)
        return g

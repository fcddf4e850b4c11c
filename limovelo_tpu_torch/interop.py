"""Carry state from the JAX package into the port, and back to numpy.

The inputs are the JAX package's values already converted to numpy arrays
or plain Python (its `NavState` fields, `P`, the `HashGridMap` fields and
the `Config` fields), so this module imports neither package's JAX side.
The tests use it to hand the same state to both implementations.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import Config, InitializationParams
from .geometry.state import NavState
from .mapping.hashgrid import HashGridMap

#: the JAX package's knn_backend names → the port's
_BACKENDS = {"xla": "dense", "pallas": "grouped"}

_MAP_FIELDS = ("keys", "pts", "cell_d2", "num_points", "num_buckets", "dropped")


def _tensor(v, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(v, copy=True), dtype=dtype).to(device)


def state_from_numpy(fields: Mapping[str, np.ndarray], device) -> NavState:
    """NavState from a mapping of its field names (R, p, v, bg, ba, g, R_LI,
    t_LI) to arrays; float32 on `device`."""
    return NavState(**{k: _tensor(fields[k], device, torch.float32)
                       for k in NavState._fields})


def map_from_numpy(fields: Mapping[str, np.ndarray], device) -> HashGridMap:
    """HashGridMap from its six fields (keys, pts, cell_d2, num_points,
    num_buckets, dropped); int32 keys and counters, float32 tables."""
    dtypes = {"keys": torch.int32, "pts": torch.float32, "cell_d2": torch.float32,
              "num_points": torch.int32, "num_buckets": torch.int32, "dropped": torch.int32}
    return HashGridMap(**{k: _tensor(fields[k], device, dtypes[k]) for k in _MAP_FIELDS})


def config_from_kwargs(kwargs: Mapping[str, object]) -> Config:
    """The port's Config from the JAX package's Config fields.  Translates
    the KNN backend names and rebuilds the warm-up schedule (given as an
    object with `times`/`deltas`, or a dict)."""
    kw = dict(kwargs)
    if "knn_backend" in kw:
        kw["knn_backend"] = _BACKENDS.get(kw["knn_backend"], kw["knn_backend"])
    init = kw.get("Initialization")
    if init is not None and not isinstance(init, InitializationParams):
        get = init.get if isinstance(init, Mapping) else lambda k: getattr(init, k)
        kw["Initialization"] = InitializationParams(times=tuple(get("times")),
                                                    deltas=tuple(get("deltas")))
    return Config(**kw)


def to_numpy(obj):
    """Tensors (or NamedTuples / tuples / lists of them) → numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj

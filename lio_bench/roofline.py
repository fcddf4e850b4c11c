"""The grouped KNN kernel's least time on its inputs, against the card's
published peaks (`peaks.json`): a frozen copy of `chip_smoke.py::topk_bound`.

Each input byte is read once (only the map buckets the groups name), each
output written once, and 8 float32 operations (3 subtractions, 3 products,
2 additions) are counted for every real query and every slot of a bucket
present in its group: what these inputs need, not the most they could."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import torch

#: coordinate of a vacant query slot (limovelo_tpu_torch/mapping/hashgrid.FAR)
FAR = 1.0e9
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> Optional[dict]:
    """The peaks of the card named `kind`, or None when the table lacks it."""
    with open(PEAKS) as f:
        return json.load(f)["devices"].get(kind)


def topk_bound(bucket_ids: torch.Tensor, order_q: torch.Tensor, slots: int, k: int,
               peak: dict) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations") of one launch on these inputs."""
    G, NB = bucket_ids.shape
    present = bucket_ids >= 0
    real_q = (order_q[..., 0] != FAR).sum(-1)
    flops = 8.0 * float((real_q * present.sum(-1)).sum()) * slots
    n_buckets = int(torch.unique(bucket_ids[present]).numel())
    nbytes = (G * NB * 4 + order_q.numel() * 4 + G * 3 * 4
              + n_buckets * slots * 3 * 4 + G * 64 * k * 8)
    t_bytes, t_ops = nbytes / peak["bytes_per_s"], flops / peak["f32_flop_per_s"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

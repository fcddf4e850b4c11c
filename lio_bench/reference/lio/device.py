"""Device selection: explicit, defaulting to the card, never silently the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises if a CUDA device is asked for and
    none is present (pass device="cpu" to run the plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the port on the CPU"
        )
    return dev

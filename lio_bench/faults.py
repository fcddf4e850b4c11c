"""Faults planted under the program's timed path, for the check that the
comparison catches them (tests/test_lio_bench_faults.py and calibrate.py):

- "unchanged": the step returns the state it was given (and reports it);
- "half": half of each window's points are left out of the step;
- "altered": each step's reported position is moved by 5 cm where the step
  produces it (the state the step carries on with is left right).

`planted(kind)` replaces `lio_step` in the program's pipeline module for the
duration of the block; the reference has its own copy and is not touched.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

KINDS = ("unchanged", "half", "altered")
ALTER_M = 0.05


@contextmanager
def planted(kind: str):
    import limovelo_tpu_torch.runtime.pipeline as pl
    from limovelo_tpu_torch.step import TEL_P, TEL_R, TEL_V

    real = pl.lio_step

    def broken(inp, m, static_cfg, grid):
        if kind == "half":
            keep = torch.arange(inp.pts_mask.shape[0], device=inp.pts_mask.device) % 2 == 0
            return real(inp._replace(pts_mask=inp.pts_mask & keep), m, static_cfg, grid)
        out = real(inp, m, static_cfg, grid)
        tele = out.telemetry.clone()
        if kind == "unchanged":
            x = inp.x
            tele[TEL_R] = x.R.reshape(-1).to(tele.dtype)
            tele[TEL_P] = x.p.to(tele.dtype)
            tele[TEL_V] = x.v.to(tele.dtype)
            return out._replace(x=x, P=inp.P, telemetry=tele)
        if kind == "altered":
            tele[TEL_P] = tele[TEL_P] + ALTER_M
            return out._replace(telemetry=tele)
        raise ValueError(f"fault {kind!r}: one of {KINDS}")

    pl.lio_step = broken
    try:
        yield
    finally:
        pl.lio_step = real

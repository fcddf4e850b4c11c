"""Cells by name: `BENCHMARK.json` names a cell's configuration and traffic
mix; each lives in a file of its own under this directory, found by name:

- `configs/<config>.json`: the profile, the sensor, the scene and the course;
- `mixes/<traffic>.json`: the mapping mode;
- `limits/<cell>.json`: the limit of each number the correctness check
  compares;
- `metrics/<metric>.py`: the reader of each per-layer metric.

Adding a cell, a configuration, a mix or a metric adds files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str) -> Cell:
    """The cell `name` of `BENCHMARK.json` with its files."""
    bench = load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
    cell = load(entry["config"], entry["traffic"])
    cell.chips = int(entry["chips"])
    cell.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    cell.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return cell


def load(config: str, traffic: str) -> Cell:
    """The files of the cell `<config>.<traffic>`, without its metrics."""
    name = f"{config}.{traffic}"
    return Cell(name=name, config_name=config, traffic=traffic, chips=1,
                config=_read_json(BENCH_DIR / "configs" / f"{config}.json"),
                mix=_read_json(BENCH_DIR / "mixes" / f"{traffic}.json"),
                limits=_read_json(BENCH_DIR / "limits" / f"{name}.json"))


def metric_reader(name: str):
    """The `read(ctx)` function of `metrics/<name>.py`."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("lio_bench_metric_" + name.replace(".", "_"),
                                                  path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path} for the per-layer metric {name!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def build_config(config_module, spec: dict, mix: dict):
    """The run's configuration: the profile `spec["profile"]` of
    `config_module` (the program's or the reference's own copy) with the
    configuration file's overrides and the mix's mapping mode."""
    kw = {}
    for k, v in spec.get("profile_overrides", {}).items():
        if k == "Initialization":
            v = config_module.InitializationParams(times=tuple(v["times"]),
                                                   deltas=tuple(v["deltas"]))
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    kw["mapping"] = mix["mapping"]
    return config_module.PROFILES[spec["profile"]].replace(**kw)


def sensor_frame(cfg):
    """What the renderer takes from a configuration (the reference's)."""
    from .traffic.stream import SensorFrame

    return SensorFrame(
        rotation_s=cfg.full_rotation_time,
        imu_rate=cfg.imu_rate,
        gravity=tuple(cfg.gravity_vec),
        R_LI=np.asarray(cfg.I_Rotation_L, np.float64).reshape(3, 3),
        t_LI=np.asarray(cfg.I_Translation_L, np.float64),
        offset_beginning=bool(cfg.offset_beginning),
        stamp_beginning=bool(cfg.stamp_beginning),
    )


def make_stream(cell: Cell, seed: int, device):
    """Render the cell's stream from the seed (the reference's configuration
    gives the sensor's clocks, extrinsics and gravity)."""
    from .reference.lio import config as ref_config
    from .traffic.stream import render

    cfg = build_config(ref_config, cell.config, cell.mix)
    c = cell.config
    return render(c["sensor"], c["scene"], c["course"], sensor_frame(cfg), seed, device)

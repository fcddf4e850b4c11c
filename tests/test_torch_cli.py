"""Port parity of the CLI (`python -m limovelo_tpu_torch`): the `kitti` and
`run` commands against the JAX package's `main` on the same files, the
per-command profile, the multi-device flags' refusals, the viz subcommands, `--profile`,
and the evaluation writers.

The fixtures are small (a 12 × 200 LiDAR, 2 s of a 12 m room on a 2.5 m
circle) and the configuration, handed to both CLIs as one YAML file, has one
point bucket and one IMU bucket, so the JAX step compiles once per command.
Both run the "rematch" match cadence: with "auto" the neighbour sets frozen
at the predicted pose carry one point of the two packages' f32 rounding on to
later windows, and over two seconds the estimates drift centimetres apart;
re-searching each iteration keeps them within a few millimetres.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from limovelo_tpu.__main__ import main as jax_main
from limovelo_tpu.config import DEFAULT as J_DEFAULT
from limovelo_tpu.config import KITTI as J_KITTI
from limovelo_tpu.config import InitializationParams as JInit
from limovelo_tpu.runtime.evalsuite import EvalRow as JEvalRow
from limovelo_tpu.runtime.evalsuite import write_eval_md as j_write_eval_md
from limovelo_tpu.viz import make_profile as j_make_profile
from limovelo_tpu.viz import write_ply as j_write_ply
from limovelo_tpu_torch import interop
from limovelo_tpu_torch.__main__ import main
from limovelo_tpu_torch.config import KITTI
from limovelo_tpu_torch.io.fixtures import write_kitti_drive, write_rosbag
from limovelo_tpu_torch.io.simulate import circle_trajectory, room_world, simulate
from limovelo_tpu_torch.runtime.evalsuite import EvalRow, run_real_eval, write_eval_md
from limovelo_tpu_torch.runtime.evaluate import ate_rmse
from limovelo_tpu_torch.viz import PROFILES as VIZ_PROFILES
from limovelo_tpu_torch.viz import make_profile, write_ply

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POS_TOL = 0.005

#: the fixtures' configuration, shared by both packages (JAX names)
_SMALL = dict(min_dist=0.5, downsample_prec=0.3, downsample_rate=1, imu_rate=200.0,
              real_time_delay=0.1, empty_lidar_time=0.5, degeneracy_threshold=0.0,
              covariance_acceleration=1e-2, covariance_gyroscope=1e-3, point_buckets=(2048,),
              ds_buckets=(2048,), imu_buckets=(64,), map_table_size=1 << 12, knn_rings=1,
              match_mode="rematch", Initialization=JInit(times=(), deltas=(0.1,)))
_BAG = dict(real_time=False, LiDAR_type="velodyne", stamp_beginning=False, offset_beginning=True,
            full_rotation_time=0.1, points_topic="/velodyne_points", imus_topic="/vectornav/IMU")


def _port_config(jcfg):
    return interop.config_from_kwargs({f.name: getattr(jcfg, f.name)
                                       for f in dataclasses.fields(jcfg)})


def _write_yaml(jcfg, path) -> str:
    """A configuration as a YAML file both CLIs read."""
    d = {k: (list(v) if isinstance(v, tuple) else v)
         for k, v in jcfg.__dict__.items() if not k.startswith("_")}
    d["Initialization"] = {"times": list(jcfg.Initialization.times),
                           "deltas": list(jcfg.Initialization.deltas)}
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return str(path)


def _read_tum(path):
    d = np.atleast_2d(np.loadtxt(path))
    return d[:, 0], d[:, 1:4]


def _scene():
    return room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5)


@pytest.fixture(scope="module")
def kitti_drive(tmp_path_factory):
    d = tmp_path_factory.mktemp("kitti")
    jcfg = J_KITTI.replace(**_SMALL)
    drive = d / "2011_09_26_drive_9999_sync"
    sim = write_kitti_drive(str(drive), *_scene(), _port_config(jcfg), duration=2.0,
                            lidar_lines=12, pts_per_line=200, seed=5)
    return d, str(drive), _write_yaml(jcfg, d / "kitti.yaml"), sim


def _assert_same_run(jax_tum, port_tum, sim):
    (tj, pj), (tt, pt) = _read_tum(jax_tum), _read_tum(port_tum)
    assert len(tt) == len(tj) >= 12
    np.testing.assert_array_equal(tt, tj)
    d = np.linalg.norm(pt - pj, axis=1)
    assert d.max() < POS_TOL, d
    ate, _ = ate_rmse(tt, pt, sim.gt_t, sim.gt_R, sim.gt_p)
    assert ate < 0.05


def test_cli_kitti_matches_jax(kitti_drive):
    d, drive, cfg, sim = kitti_drive
    jax_main(["kitti", "--drive", drive, "--config", cfg, "--out", str(d / "jax.tum")])
    main(["kitti", "--drive", drive, "--config", cfg, "--out", str(d / "port.tum"),
          "--device", "cpu"])
    _assert_same_run(d / "jax.tum", d / "port.tum", sim)


def test_cli_run_matches_jax(tmp_path):
    jcfg = J_DEFAULT.replace(**_SMALL, **_BAG)
    tcfg = _port_config(jcfg)
    sim = simulate(*_scene(), tcfg, duration=2.0, lidar_lines=12, pts_per_line=200,
                   imu_rate=200.0, seed=9)
    bag = str(tmp_path / "fixture.bag")
    write_rosbag(bag, sim, tcfg)
    cfg = _write_yaml(jcfg, tmp_path / "bag.yaml")
    jax_main(["run", "--bag", bag, "--config", cfg, "--out", str(tmp_path / "jax.tum")])
    main(["run", "--bag", bag, "--config", cfg, "--out", str(tmp_path / "port.tum"),
          "--device", "cpu"])
    _assert_same_run(tmp_path / "jax.tum", tmp_path / "port.tum", sim)


class _Stop(Exception):
    pass


def test_kitti_command_defaults_to_the_kitti_profile(monkeypatch, kitti_drive):
    """Without --config the kitti command builds its pipeline from the
    KITTI profile (gravity sign, extrinsics); the CLI overrides apply."""
    import limovelo_tpu_torch.runtime.pipeline as pipeline

    seen = []

    def fake(cfg, device="cuda", **kw):
        seen.append((cfg, device))
        raise _Stop

    monkeypatch.setattr(pipeline, "LioPipeline", fake)
    _, drive, _, _ = kitti_drive
    with pytest.raises(_Stop):
        main(["kitti", "--drive", drive, "--device", "cpu"])
    with pytest.raises(_Stop):
        main(["kitti", "--drive", drive, "--device", "cpu", "--real-time", "true",
              "--mapping-online", "false"])
    assert seen[0] == (KITTI, "cpu")
    assert seen[1][0] == KITTI.replace(real_time=True, mapping_online=False)


@pytest.mark.parametrize("flag", [["--devices", "2"], ["--shard", "points"]])
def test_multi_device_flags_raise(kitti_drive, flag, monkeypatch):
    """The multi-device flags run (tests/test_torch_parallel.py), and keep
    the JAX package's refusals, raised in the spawned ranks: a mesh with
    offline mapping, and a point bucket that does not divide across the
    ranks (2048 over 3)."""
    _, drive, cfg, _ = kitti_drive
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["kitti", "--drive", drive, "--config", cfg, "--device", "cpu", "--max-scans", "6"]
    if flag[0] == "--devices":
        argv += [*flag, "--mapping-online", "false"]
        match = "mapping 'online' or 'none'"
    else:
        argv += [*flag, "--devices", "3"]
        match = "must divide across the 3-rank mesh"
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match=match):
        main(argv)


def test_viz_and_profile_outputs(kitti_drive, tmp_path):
    """`viz rviz` writes the JAX package's profile text; a replay with
    --profile, --render, --ply, --save-map and --checkpoint writes a Chrome
    trace, a figure, the JAX package's PLY bytes for the map, an HD map and a
    checkpoint; `viz render` draws the saved map and trajectory."""
    d, drive, cfg, sim = kitti_drive
    for name in VIZ_PROFILES:
        out = tmp_path / f"{name}.rviz"
        main(["viz", "rviz", "--profile", name, "--out", str(out)])
        assert out.read_text() == j_make_profile(name) == make_profile(name)
    run = dict(out=tmp_path / "t.tum", profile=tmp_path / "trace", render=tmp_path / "run.png",
               ply=tmp_path / "map.ply", save_map=tmp_path / "map.npz",
               checkpoint=tmp_path / "ck.npz")
    argv = ["kitti", "--drive", drive, "--config", cfg, "--device", "cpu", "--max-scans", "6"]
    for k, v in run.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    main(argv)
    trace = json.loads((run["profile"] / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 100
    assert run["render"].read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    pts = np.load(run["save_map"])["points"]
    assert len(pts) > 1000
    from limovelo_tpu_torch.viz.export import height_colors

    j_write_ply(str(tmp_path / "jax.ply"), pts, height_colors(pts))
    assert run["ply"].read_bytes() == (tmp_path / "jax.ply").read_bytes()
    assert "anchors_t" in np.load(run["checkpoint"])
    gt = tmp_path / "gt.tum"
    gt.write_text("".join(f"{t} {p[0]} {p[1]} {p[2]} 0 0 0 1\n"
                          for t, p in zip(sim.gt_t[::10], sim.gt_p[::10])))
    fig = tmp_path / "render.png"
    main(["viz", "render", "--map", str(run["save_map"]), "--traj", str(run["out"]),
          "--gt", str(gt), "--out", str(fig), "--ply", str(tmp_path / "again.ply")])
    assert fig.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "again.ply").read_bytes() == run["ply"].read_bytes()
    with pytest.raises(SystemExit, match="need --traj"):
        main(["viz", "render", "--out", str(fig)])


def test_write_eval_md_and_real_eval_on_a_drive(kitti_drive, tmp_path):
    """`run_real_eval` scores a drive against the ground truth derived from
    its own OXTS channel, which agrees with the fixture's ground truth; and
    `write_eval_md` writes the rows of both tables as the JAX writer does."""
    _, drive, cfg_path, sim = kitti_drive
    from limovelo_tpu_torch.config import Config
    from limovelo_tpu_torch.runtime.evaluate import write_tum

    cfg = Config.from_yaml(cfg_path).replace(match_mode="auto")
    rows = run_real_eval(kitti_root=drive, config=cfg, device="cpu")
    assert len(rows) == 1 and rows[0].note == "GT: OXTS mercator"
    r = rows[0]
    assert r.updates >= 12 and r.map_points > 0 and 9.0 < r.update_hz < 11.0
    gt_path = str(tmp_path / "gt.tum")
    write_tum(gt_path, sim.gt_t, sim.gt_R, sim.gt_p)
    (fixture,) = run_real_eval(kitti_root=drive, gt_tum=gt_path, config=cfg, device="cpu")
    assert fixture.note == "GT: " + gt_path and fixture.updates == r.updates
    assert abs(r.ate_m - fixture.ate_m) < 0.01 and r.ate_m < 0.05

    with pytest.raises(SystemExit, match="--gt"):
        run_real_eval(bag=str(tmp_path / "none.bag"), device="cpu")
    vals = [("room circle · mapping online", 0.0123, 40, 10.0, 12345, 3.2, ""),
            ("KITTI raw drive (fixture)", float("nan"), 0, 0.0, 0, 1.0, "NO UPDATES — run failed")]
    got = write_eval_md([EvalRow(*v) for v in vals], str(tmp_path / "EVAL.md"), real_rows=rows,
                        device="cpu")
    want = j_write_eval_md([JEvalRow(*v) for v in vals], str(tmp_path / "JEVAL.md"),
                           real_rows=[JEvalRow(**dataclasses.asdict(x)) for x in rows])
    assert (tmp_path / "EVAL.md").read_text() == got

    def table(text):
        return [ln for ln in text.splitlines() if ln.startswith("| ")]

    assert table(got) == table(want) and len(table(got)) == 5
    assert "| nan |" in got and "Device: cpu." in got


def test_help_and_imports_need_no_yaml_or_matplotlib():
    """`python -m limovelo_tpu_torch --help` and every subcommand's help
    run, and every module of the port imports, with PyYAML and matplotlib
    missing (the card machine has neither)."""
    import pkgutil

    mods = sorted(m.name for m in pkgutil.walk_packages([str(ROOT / "limovelo_tpu_torch")],
                                                         "limovelo_tpu_torch."))
    code = (
        "import importlib, sys\n"
        "for m in ('yaml', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import runpy\n"
        "for argv in ([], ['kitti'], ['run'], ['sim'], ['eval'], ['viz', 'render']):\n"
        "    sys.argv = ['limovelo_tpu_torch', *argv, '--help']\n"
        "    try:\n"
        "        runpy.run_module('limovelo_tpu_torch', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (argv, e.code)\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.rstrip().endswith("ok"), r.stdout + r.stderr
    assert "--device" in r.stdout and "--skip-battery" in r.stdout

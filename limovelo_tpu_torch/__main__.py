"""Command-line runner (port of `limovelo_tpu/__main__.py`) — the analog of
the reference's roslaunch files (`launch/*.launch`, SURVEY.md §2.13).

    python -m limovelo_tpu_torch run --bag xaloc.bag --config xaloc --out traj.tum
    python -m limovelo_tpu_torch kitti --drive 2011_09_26_drive_0001_sync --out traj.kitti
    python -m limovelo_tpu_torch sim --world corridor --duration 10 --out traj.tum
    python -m limovelo_tpu_torch sim --save-map map.npz          # build an HD map
    python -m limovelo_tpu_torch sim --hd-map map.npz            # prelocalization
    python -m limovelo_tpu_torch eval --fast                     # the accuracy battery
    python -m limovelo_tpu_torch viz rviz --profile kitti --out kitti.rviz
    python -m limovelo_tpu_torch viz render --map map.npz --traj traj.tum --out run.png

The subcommands and flags are the JAX package's, plus `--device` (default
`cuda`; `cpu` runs the plain versions).  `--devices N` runs the step on N
ranks, one process each (`--shard points` replicates the map, `map`
partitions it): under torchrun (`WORLD_SIZE` set) the process joins the
existing group, else it spawns N ranks on this machine, rank r on
cuda:(r % cards) (gloo when ranks share a card, nccl when each owns one) or
on the CPU with `--device cpu`.  Every rank replays the same feed; rank 0
alone prints and writes the outputs.  A `--config` that names no profile of
`config.PROFILES` is read as a YAML file (PyYAML); `viz render` and
`--render` need matplotlib.  Both are imported only when used.
"""

from __future__ import annotations

import argparse
import json
import time


def _load_config(args, default_profile="default"):
    """Resolve the config profile.  `default_profile` is the per-command
    fallback when no --config is given: the kitti command defaults to the
    KITTI profile (gravity sign, extrinsics — config/kitti.yaml) rather than
    DEFAULT, as `launch/kitti.launch` loads its own YAML."""
    from .config import PROFILES, Config

    name = args.config if args.config is not None else default_profile
    cfg = PROFILES[name] if name in PROFILES else Config.from_yaml(name)
    overrides = {}
    if args.real_time is not None:
        overrides["real_time"] = args.real_time
    if args.mapping_online is not None:
        overrides["mapping_online"] = args.mapping_online
    return cfg.replace(**overrides) if overrides else cfg


def _write_outputs(pipe, args, writer: bool = True):
    """The run's outputs.  With a mesh every rank calls this (gathering a
    map-sharded map and saving a checkpoint are collectives) and only the
    `writer` rank writes."""
    import numpy as np

    from .runtime.checkpoint import compact_map_points, save_checkpoint
    from .runtime.evaluate import write_kitti, write_tum
    from .runtime.slam import SlamPipeline

    m = pipe.full_map() if (args.render or args.ply or args.save_map) else None
    if not writer:
        if args.checkpoint and pipe.mesh is not None:
            save_checkpoint(args.checkpoint, pipe)    # a collective; rank 0 writes
        return
    res = pipe.result
    print(f"processed {len(res.records)} state updates")
    if args.render and res.records:
        from .viz import render_run

        render_run(args.render, res.positions, times=res.times,
                   map_pts=compact_map_points(m), title=f"limovelo_tpu_torch — {args.cmd}")
        print(f"figure → {args.render}")
    if args.ply:
        from .viz import write_ply
        from .viz.export import height_colors

        mp = compact_map_points(m)
        write_ply(args.ply, mp, height_colors(mp) if len(mp) else None)
        print(f"map cloud → {args.ply}")
    if args.out:
        if args.out.endswith(".kitti") or args.out.endswith(".txt"):
            write_kitti(args.out, res.rotations, res.positions)
        else:
            write_tum(args.out, res.times, res.rotations, res.positions)
        print(f"trajectory → {args.out}")
    if isinstance(pipe, SlamPipeline):
        # SLAM backend results: optimized keyframe trajectory + loop stats
        Rs_opt, ps_opt = pipe.optimized_trajectory()
        kf_t = np.array([f.t for f in pipe.keyframes.frames])
        n_att = len(pipe.loop_stats)
        n_acc = sum(1 for s in pipe.loop_stats if s["accepted"])
        print(f"SLAM backend: {len(kf_t)} keyframes, {n_att} loop "
              f"candidates, {n_acc} closures accepted")
        if args.out and len(kf_t) >= 2:
            base, dot, ext = args.out.rpartition(".")
            opt_path = (base or args.out) + ".opt." + (ext or "tum")
            write_tum(opt_path, kf_t, Rs_opt, ps_opt)
            print(f"optimized keyframe trajectory → {opt_path}")
    if args.save_map:
        from .runtime.checkpoint import save_map

        save_map(args.save_map, m, pipe.grid)
        print(f"HD map → {args.save_map}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, pipe)
        print(f"checkpoint → {args.checkpoint}")
    if res.records:
        wall = [r.wall_ms for r in res.records]
        print(json.dumps({
            "updates": len(res.records),
            "wall_ms_p50": round(float(np.percentile(wall, 50)), 3),
            "mean_matches": round(float(np.mean([r.num_matches for r in res.records])), 1),
        }))


def _make_pipe(cfg, args, mesh=None):
    """The JAX CLI's choice of pipeline: `--loop-closure` takes the mesh
    (point-sharded), `--hd-map` runs without it, the rest with `--shard`."""
    from .runtime.pipeline import LioPipeline

    if args.loop_closure:
        from .runtime.slam import SlamPipeline

        if args.hd_map:
            raise SystemExit("--loop-closure with --hd-map is not supported "
                             "(prelocalization runs against a frozen map)")
        return SlamPipeline(
            cfg, device=args.device, mesh=mesh,
            kf_min_translation=args.kf_min_translation,
            loop_min_index_gap=args.loop_min_gap,
            loop_max_distance=args.loop_max_distance,
            loop_max_rms=args.loop_max_rms,
        )
    if args.hd_map:
        return LioPipeline.from_hd_map(cfg, args.hd_map, device=args.device)
    return LioPipeline(cfg, device=args.device, mesh=mesh, shard=args.shard)


def _run(mesh, cfg, args):
    """Build the pipeline, replay the feed and write the outputs; with a
    `mesh`, one rank of a `--devices` run (rank 0 prints and writes)."""
    import contextlib
    import io

    writer = mesh is None or mesh.rank == 0
    quiet = contextlib.nullcontext() if writer else contextlib.redirect_stdout(io.StringIO())
    with quiet:
        pipe = _make_pipe(cfg, args, mesh)
        if args.resume:
            from .runtime.checkpoint import load_checkpoint

            load_checkpoint(args.resume, pipe)

        t0 = time.time()
        if args.profile and writer:
            from .runtime.profiling import trace

            with trace(args.profile):
                _replay(pipe, cfg, args)
            print(f"profiler trace → {args.profile}")
        else:
            _replay(pipe, cfg, args)
        print(f"wall time: {time.time() - t0:.1f} s")
        _write_outputs(pipe, args, writer)


def _run_devices(cfg, args):
    """`--devices N`: join the torchrun group when one is set up, else
    spawn N ranks on this machine."""
    from .parallel import multihost as mh

    if mh.init_distributed(device=args.device):
        mesh = mh.global_mesh(args.device)
        if mesh.size != args.devices:
            raise SystemExit(f"--devices {args.devices}: the process group has {mesh.size} ranks")
        return _run(mesh, cfg, args)
    mh.spawn(_run, args.devices, args=(cfg, args), device=args.device)


def _read_tum(path):
    import numpy as np

    data = np.atleast_2d(np.loadtxt(path))
    return data[:, 0], data[:, 1:4]


def _viz_main(args):
    if args.viz_cmd == "rviz":
        from .viz import make_profile

        with open(args.out, "w") as f:
            f.write(make_profile(args.profile))
        print(f"rviz profile ({args.profile}) → {args.out}")
        return
    # render
    import numpy as np

    times = positions = gt = map_pts = None
    if args.traj:
        times, positions = _read_tum(args.traj)
    if args.gt:
        _, gt = _read_tum(args.gt)
    if args.map:
        map_pts = np.load(args.map)["points"]
    if positions is None and map_pts is None:
        raise SystemExit("viz render: need --traj and/or --map")
    from .viz import render_run

    render_run(args.out, positions, times=times, map_pts=map_pts,
               gt_positions=gt, title="limovelo_tpu_torch")
    print(f"figure → {args.out}")
    if args.ply and map_pts is not None:
        from .viz import write_ply
        from .viz.export import height_colors

        write_ply(args.ply, map_pts, height_colors(map_pts) if len(map_pts) else None)
        print(f"map cloud → {args.ply}")


def _bool(s: str) -> bool:
    return s == "true"


def main(argv=None):
    p = argparse.ArgumentParser(prog="limovelo_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="where the pipeline runs: 'cuda' (default; raises without a "
                             "card) or 'cpu' (the plain versions)")

    def common(sp):
        sp.add_argument("--config", default=None,
                        help="profile name (kitti, xaloc, ouster, default) or a YAML file")
        sp.add_argument("--out", default=None, help="trajectory output (.tum/.kitti)")
        sp.add_argument("--save-map", default=None)
        sp.add_argument("--hd-map", default=None, help="prelocalize against this map")
        sp.add_argument("--checkpoint", default=None)
        sp.add_argument("--resume", default=None)
        sp.add_argument("--real-time", type=_bool, default=None)
        sp.add_argument("--mapping-online", type=_bool, default=None)
        sp.add_argument("--render", default=None, help="write a PNG/SVG figure of the run")
        sp.add_argument("--ply", default=None, help="write the map cloud as PLY")
        sp.add_argument("--profile", default=None,
                        help="capture a torch.profiler trace of the replay into this dir")
        sp.add_argument("--devices", type=int, default=None,
                        help="run the step on N ranks, one process each (point-sharded "
                             "window, all-reduced normal equations)")
        sp.add_argument("--shard", default="points", choices=["points", "map"],
                        help="with --devices: 'points' replicates the map, "
                             "'map' also partitions map table rows (D× capacity)")
        sp.add_argument("--loop-closure", action="store_true",
                        help="SLAM mode: keyframes + loop closure + pose-graph "
                             "backend; exports raw AND optimized trajectories")
        sp.add_argument("--kf-min-translation", type=float, default=2.0,
                        help="keyframe spacing (m) in SLAM mode")
        sp.add_argument("--loop-min-gap", type=int, default=20,
                        help="min keyframe index gap for loop candidates")
        sp.add_argument("--loop-max-distance", type=float, default=5.0,
                        help="max revisit distance (m) for loop candidates")
        sp.add_argument("--loop-max-rms", type=float, default=0.15,
                        help="max registration RMS (m) to accept a closure")
        device_arg(sp)

    sp = sub.add_parser("run", help="replay a ROS1 bag")
    common(sp)
    sp.add_argument("--bag", required=True)
    sp.add_argument("--max-msgs", type=int, default=None)

    sp = sub.add_parser("kitti", help="replay a KITTI raw drive")
    common(sp)
    sp.add_argument("--drive", required=True, help="path to *_sync drive dir")
    sp.add_argument("--max-scans", type=int, default=None)

    sp = sub.add_parser("sim", help="synthetic world replay (no data needed)")
    common(sp)
    sp.add_argument("--world", default="corridor", choices=["corridor", "room"])
    sp.add_argument("--duration", type=float, default=10.0)
    sp.add_argument("--speed", type=float, default=5.0)
    sp.add_argument("--omega", type=float, default=0.5,
                    help="room world: circle angular rate (rad/s)")

    sp = sub.add_parser("eval", help="regenerate EVAL.md (accuracy battery)")
    sp.add_argument("--out", default="EVAL.md")
    sp.add_argument("--fast", action="store_true", help="shorter durations")
    sp.add_argument("--kitti-root", default=None,
                    help="KITTI raw *_sync drive: run the real-data protocol "
                         "(GT from OXTS unless --gt)")
    sp.add_argument("--bag", default=None,
                    help="ROS1 bag: real-data protocol (needs --gt)")
    sp.add_argument("--gt", default=None, help="TUM ground-truth file")
    sp.add_argument("--max-scans", type=int, default=None)
    sp.add_argument("--skip-battery", action="store_true",
                    help="only run the real-data rows (no synthetic battery)")
    device_arg(sp)

    sp = sub.add_parser("viz", help="visualization tools (no device needed)")
    viz_sub = sp.add_subparsers(dest="viz_cmd", required=True)
    vp = viz_sub.add_parser("rviz", help="generate an rviz profile")
    vp.add_argument("--profile", default="default")
    vp.add_argument("--out", required=True)
    vp = viz_sub.add_parser("render", help="render saved artifacts to a figure")
    vp.add_argument("--map", default=None, help="HD map .npz (from --save-map)")
    vp.add_argument("--traj", default=None, help="TUM trajectory file")
    vp.add_argument("--gt", default=None, help="TUM ground-truth file")
    vp.add_argument("--out", required=True, help="output PNG/SVG")
    vp.add_argument("--ply", default=None, help="also export map cloud as PLY")

    args = p.parse_args(argv)
    if args.cmd == "viz":
        return _viz_main(args)
    if args.cmd == "eval":
        return _eval_main(args)
    # resolve the full config (per-command default profile + CLI overrides +
    # sim-mode tweaks) before the pipeline is built: it freezes extrinsics,
    # gravity and buckets at construction
    cfg = _load_config(args, "kitti" if args.cmd == "kitti" else "default")
    if args.cmd == "sim":
        cfg = cfg.replace(real_time=False, min_dist=0.5, downsample_prec=0.3)
    if args.devices is not None:
        return _run_devices(cfg, args)
    _run(None, cfg, args)


def _replay(pipe, cfg, args):
    if args.cmd == "run":
        from .io.rosbag import feed_pipeline

        feed_pipeline(pipe, args.bag, cfg, max_msgs=args.max_msgs)
    elif args.cmd == "kitti":
        from .io.kitti import KittiRawReader, feed_pipeline

        feed_pipeline(pipe, KittiRawReader(args.drive), cfg, max_scans=args.max_scans)
    else:
        from .io.simulate import (circle_trajectory, corridor_trajectory, corridor_world,
                                  replay_into, room_world, simulate)
        from .runtime.evaluate import ate_rmse

        if args.world == "corridor":
            world, traj = corridor_world(length=200.0), corridor_trajectory(speed=args.speed)
        else:
            world, traj = room_world(), circle_trajectory(omega=args.omega)
        sim = simulate(world, traj, cfg, duration=args.duration)
        replay_into(pipe, sim)
        res = pipe.result
        if res.records:
            rmse, _ = ate_rmse(res.times, res.positions, sim.gt_t, sim.gt_R, sim.gt_p)
            print(f"ATE RMSE vs ground truth: {rmse:.4f} m")


def _eval_main(args):
    from .device import resolve_device
    from .runtime.evalsuite import run_eval, run_real_eval, write_eval_md

    dev = resolve_device(args.device)
    real_rows = None
    if args.kitti_root or args.bag:
        real_rows = run_real_eval(kitti_root=args.kitti_root, bag=args.bag, gt_tum=args.gt,
                                  max_scans=args.max_scans, device=dev)
        for r in real_rows:
            print(f"[real] {r.scenario}: ATE {r.ate_m:.4f} m, "
                  f"{r.updates} updates, {r.update_hz:.1f} Hz  ({r.note})")
    if args.skip_battery:
        if not real_rows:
            raise SystemExit("--skip-battery without --kitti-root/--bag: nothing to do")
        return
    rows = run_eval(fast=args.fast, device=dev)
    import torch

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(write_eval_md(rows, args.out, real_rows=real_rows, device=name))
    print(f"table → {args.out}")
    return rows


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`limovelo_tpu_torch`) on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:

  env      the card: torch's name for it, nvidia-smi's name and power limit
  build    nvcc builds every kernel of the main path from limovelo_tpu_torch/csrc
  sim      a VLP-16-like stream (16 lines x 1800 columns at 10 Hz, IMU at
           400 Hz, 3 s of a 24 m room with ten boxes, 4 m circle)
  kernel   each kernel against its plain PyTorch version on the card, at the
           main path's shapes (queries from a scan, map at the default table
           size; N=4096 is a rank's shard of the 8192 bucket on two ranks):
           the function's outputs, and the kernel's raw outputs held
           to its output contract (ops/cuda/knn.py); the kernel's time, the
           plain version's, the bound, the work the data needs, and the
           early-exit floor (the same groups with every bucket absent)
  main     LioPipeline(DEFAULT with the 1-ring grouped KNN, device="cuda")
           replays the stream; every launch count is set to 0 just before
           and read just after, and each window must have launched the kernel
  cpu      the first 0.5 s replayed on the CPU (plain versions) must give the
           same records, positions within 5 mm of the card's
  offline  mapping="offline" on the same stream: ATE below max(3 x main ATE,
           0.15 m), one map growth event per rotation (at least half as many,
           at most as many plus 2), and its own first 1.0 s on the CPU
           (offline_cpu) within 5 mm; that span must hold two map updates of
           mapping_step and, after the first, records that match against it
  hd_map   save_map of the main run's map into build/, then from_hd_map over
           the stream with the map frozen: keys, pts and cell_d2 equal before
           and after, ATE < 0.30 m
  checkpoint  feed to 1.55 s, save_checkpoint, load_checkpoint into a fresh
           card pipeline, feed the rest: the main run's record times,
           positions within 2 mm; the npz size and the save and load seconds
  prune    map_prune_radius=25, map_prune_every=0.5 on a 10 s corridor run
           (sensor range 40 m), against the same run unpruned: the bucket
           count falls at the prunes, its peaks between two prunes plateau
           over the second half (the later peaks at most 10 % above the
           earlier), and the unpruned map ends over 1.5 times the pruned one;
           a prune call's device time
  slam     SlamPipeline on a 9 s run of a 4 m circle at 0.8 rad/s, with
           full-rotation (10 Hz) windows, so that a keyframe holds a whole
           scan: at least
           15 keyframes, optimized keyframes within 1 m of the odometry; with
           1 deg and 1 cm of drift injected per keyframe edge, at least one
           loop closes and the optimized keyframe ATE is below half the
           drifted one
  kitti    a KITTI raw drive at HDL-64 width (64 lines x 2048 columns at
           10 Hz, IMU at the KITTI profile's 1000 Hz, 5 s of a 120 m street
           with pillars at 8 m/s) written by io/fixtures, replayed through
           the CLI in process (`kitti --config smoke_kitti --save-map`, the
           KITTI profile with the 1-ring grouped KNN): one TUM line per
           record, ATE below 0.30 m against the fixture's ground truth and
           within 1 cm of the ATE against the drive's own OXTS ground truth
           (io/kitti.oxts_trajectory); the point and ds sizes reached
  bag      a ROS1 bag of a VLP-16 stream (16 x 1800) with the XALOC profile
           (400 Hz IMU, real-time windows warming up to 50 Hz, stamp at the
           end and offsets from the beginning, online extrinsics), 4 s of
           the room from a standing start, through the CLI (`run --config
           smoke_xaloc`): updates above 40 Hz of data time after the
           warm-up, ATE below 0.30 m
  publish  the main stream through LioPipeline(publisher=Publisher(metrics,
           trajectory)) with every sink attached: the main phase's records
           (times, positions within 2 mm), one JSONL row and one TUM line
           per record, one unit normal per match in each planes packet, the
           states packet as long as the anchor history, over 99 % of the
           published intensities input intensities; step p50/p95 beside
           the main phase's (the difference is the publisher's readbacks)
  eval     the accuracy battery through the CLI (`eval --fast --device
           cuda`, build/smoke/EVAL.md): every row has updates and a finite
           ATE below 0.10 m; each row printed beside EVAL.md's.  Its
           configurations are the JAX battery's, which use the dense KNN:
           the phase reports its launches but is exempt from the
           per-window kernel rule.  It is the only phase that drives the
           racing envelope and the 100 Hz windows on the card
  shard_points  two ranks on the one card (gloo: NCCL refuses two ranks on
           one device, so every collective is staged through the host),
           spawned by parallel.multihost.spawn, each running
           LioPipeline(main_config(), mesh=..., shard="points") over the main
           stream: every window on every rank must launch the grouped kernel
           (each rank counts its own and reports them); rank 0's records are
           main's record times, positions within 3 cm
           (tests/test_parallel.py's criterion), ATE below max(0.05 m, 1.5 x
           main's); per-rank step p50/p95 and the seconds per window spent in
           collectives; the ranks hold the same replicated estimate
  shard_map  the same world with shard="map" (the map's table rows split
           over the ranks, the ring KNN, which is dense: its launches are
           reported, and it is exempt from the per-window kernel rule): the
           same record checks; the ranks' bucket counts sum to the
           telemetry's, and each rank's table holds only buckets that
           owner_of gives it
  posegraph_sharded  the same world solves the slam phase's keyframe graph
           (after the drift re-check) edge-sharded: within 1e-4 of
           optimize_pose_graph on one device
  shard_nccl  a world of one rank on nccl, points mode: main's record
           times, positions within 2 mm
  shard_points_nccl  shard_points on nccl over two cards, where the machine
           has two; else the line says it was not run
  cli_devices  `sim --devices 2 --shard points` through the CLI in process
           (two spawned ranks on the card, rank 0 writes the TUM file): one
           line per record, finite, ATE below 0.10 m
  render   the seconds spent rendering each phase's stream

Every phase on the card counts its own kernel launches (set to 0 just
before it, read just after; in a spawned rank, that rank's) and, but for
eval and shard_map, fails if a window launched none; the kernels line sums
them over every phase and rank.  A rank that fails or outlasts its world's
time limit fails the script.  Files go under build/smoke/.  Then the
kernels line, nvidia-smi's line and, last, {"ok": true, "device": {...}}.  Any failed check raises: the script then
exits non-zero and prints no result.  It needs one card, builds into
build/ beside this file, and exits non-zero without a card or without the
package beside it.

    python3 chip_smoke.py --profile

runs only a torch.profiler capture of 20 main-path windows (device busy
and idle share, the top ops by host and by device time).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, and f32 outside the tensor
#: cores (the kernel's arithmetic), both at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

SIM = dict(lidar_lines=16, pts_per_line=1800, imu_rate=400.0, duration=3.0)
CPU_REPLAY_S = 0.5
#: offline mode maps once per rotation from the first advance on, and the
#: records of its first 0.5 s all precede the first map update: its CPU
#: replay runs on past two updates
OFFLINE_CPU_REPLAY_S = 1.0
POS_TOL_M = 0.005
CHECKPOINT_AT_S = 1.55       # the checkpoint phase's cut, into the stream
RESUME_TOL_M = 0.002
PRUNE_S = 10.0               # the prune phase's corridor run
PRUNE_RANGE_M = 40.0         # its sensor range, as in tests/test_mapping.py
#: the corridor ahead refills between two prunes, so the bucket count saws
#: between the map just after a prune (25 m each way) and just before the
#: next (the 4 m driven behind, the sensor's range ahead): the plateau check
#: compares the saw's peaks, which may differ this much with the pillars'
#: phase
PLATEAU_SHARE = 0.10
SLAM_S = 9.0                 # the slam phase's run: more than one revolution
SMOKE_DIR = ROOT / "build" / "smoke"
#: the kitti phase's drive: the HDL-64 of the KITTI raw drives
KITTI_SIM = dict(lidar_lines=64, pts_per_line=2048, duration=5.0)
#: the bag phase's stream: a VLP-16 on the Formula Student car
BAG_SIM = dict(lidar_lines=16, pts_per_line=1800, duration=4.0)
FIXTURE_ATE_M = 0.30         # tests/test_fixtures_e2e.py's limit
OXTS_ATE_TOL_M = 0.01
BAG_MIN_RATE_HZ = 40.0       # XALOC's 50 Hz windows after the warm-up
BAG_WARMUP_S = 1.5           # from the first record: past the last warm-up step
EVAL_ATE_M = 0.10            # tests/test_racing.py's and test_real_eval.py's bound
GENUINE_SHARE = 0.99
MIN_MATCH_FRAC = 0.15
D2_ATOL = 1e-5
K = 5
SPIN_CYCLES = 10_000_000     # ~5 ms at the H100's 1.98 GHz boost clock
SHARD_RANKS = 2
SHARD_POS_TOL_M = 0.03       # tests/test_parallel.py's sharded-vs-single bound
NCCL_POS_TOL_M = 0.002
POSEGRAPH_TOL = 1e-4
SHARD_TIMEOUT_S = 420.0      # a spawned world's limit: a hung rank fails the script
CLI_SIM_S = 2.0
DEVICE = "cuda"              # where the main path's phases run

_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def phase(name: str, **kw) -> None:
    emit({"phase": name, "elapsed_s": time.perf_counter() - _T0, **kw})


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, batch: int = 10, warmup: int = 3) -> float:
    """Device time of one fn() call: the median over `reps` of CUDA-event
    timings of `batch` back-to-back calls, divided by `batch`.  Before each
    rep, outside the timed span, a 64 MB buffer is rewritten (each batch
    starts with a cold L2) and a spin kernel holds the stream for about
    5 ms (`torch.cuda._sleep`), so the host has issued the whole batch
    before the device reaches it: the span is the device's time for the
    calls back to back, not the host's time to issue them."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# the kernel against its plain version
# ---------------------------------------------------------------------------


def topk_bound(grp, map_pts, k: int, far: float):
    """Least time for `group_topk` on these inputs: each input byte read
    once (only the map buckets the groups name), each output written once,
    against 8 f32 operations (3 subtractions, 3 products, 2 additions) for
    every real query and every slot of a bucket present in its group."""
    G, NB = grp.bucket_ids.shape
    S = map_pts.shape[1]
    present = grp.bucket_ids >= 0
    real_q = (grp.order_q[..., 0] != far).sum(-1)
    flops = 8.0 * float((real_q * present.sum(-1)).sum()) * S
    n_buckets = int(torch.unique(grp.bucket_ids[present]).numel())
    nbytes = (G * NB * 4 + grp.order_q.numel() * 4 + grp.centers.numel() * 4
              + n_buckets * S * 3 * 4 + G * 64 * k * 8)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), flops, nbytes


def compare_knn(got, want, what: str) -> float:
    nb_g, sq_g, v_g = got
    nb_w, sq_w, v_w = want
    if not torch.equal(v_g, v_w):
        raise AssertionError(f"{what}: valid masks differ in {int((v_g != v_w).sum())} entries")
    err = float((sq_g[v_w] - sq_w[v_w]).abs().max()) if bool(v_w.any()) else 0.0
    if err > D2_ATOL:
        raise AssertionError(f"{what}: d2 differs by {err} > {D2_ATOL}")
    if not torch.equal(nb_g[v_w], nb_w[v_w]):
        raise AssertionError(f"{what}: neighbour coordinates differ")
    if not bool(torch.isinf(sq_g[~v_w]).all()):
        raise AssertionError(f"{what}: invalid entries are not +inf")
    return err


def main_path_queries(scan_w: np.ndarray, sensor: np.ndarray, n: int, leaf: float):
    """Queries shaped as the main path hands them to the KNN: one scan,
    voxel-downsampled at the DEFAULT leaf, in the first rows of an `n`-row
    bucket; the padding rows are zero LiDAR points, i.e. the sensor origin."""
    from limovelo_tpu_torch.ops.voxel import voxel_downsample

    pts = torch.as_tensor(scan_w[:n])
    ds = voxel_downsample(pts, torch.ones(len(pts), dtype=torch.bool), leaf)
    q = np.tile(sensor.astype(np.float32), (n, 1))
    c = int(ds.count)
    q[:c] = ds.pts[:c].numpy()
    return q, c


def raw_contract(grp, map_pts, what: str) -> tuple:
    """The kernel's raw per-group outputs held to its output contract
    against the plain version; returns the raw arguments and the entries
    held bit for bit."""
    from limovelo_tpu_torch.ops.cuda import knn

    args = (grp.bucket_ids, grp.order_q, grp.centers, map_pts, K)
    try:
        n_exact = knn.check_topk_contract(grp.order_q, grp.bucket_ids, map_pts.shape[1],
                                          knn.group_topk(*args), knn.group_topk_plain(*args))
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None
    return args, n_exact


def kernel_views(world, sim):
    """The kernel phase's world: the map cloud (the sensor's views at 12
    poses over the run), and one scan with its sensor position."""
    return (cast_views(world, sim, np.linspace(0, 1, 12))[0],) + cast_views(world, sim, [0.52])


def kernel_map(world_pts: np.ndarray, dev):
    """The default 131072-bucket table holding `world_pts`."""
    from limovelo_tpu_torch.mapping import hashgrid as hg

    params = hg.GridParams()
    m = hg.insert(hg.make_map(params, device=dev), torch.as_tensor(world_pts, device=dev),
                  torch.ones(len(world_pts), dtype=torch.bool, device=dev), params)
    return params, m


def kernel_shapes(scan_w: np.ndarray, sensor: np.ndarray, dev):
    """The kernel phase's shapes: (N rows, downsampled count, queries,
    rings, max_buckets) for the main path's three point buckets, with the
    1-ring envelope and the tiered rings=3 NB=32 one; and a rank's shard of
    the 8192 bucket on two ranks (N=4096, 1-ring)."""
    leaf = main_config().downsample_prec
    for n in (4096, 8192, 16384, 32768):
        q_np, n_ds = main_path_queries(scan_w, sensor, n, leaf)
        q = torch.as_tensor(q_np, device=dev)
        for rings, mb in ((1, None), (3, 32))[:1 if n == 4096 else 2]:
            yield n, n_ds, q, rings, mb


def kernel_phase(world_pts: np.ndarray, scan_w: np.ndarray, sensor: np.ndarray, device="cuda"):
    from limovelo_tpu_torch.mapping import hashgrid as hg
    from limovelo_tpu_torch.ops.cuda import knn

    dev = torch.device(device)
    params, m = kernel_map(world_pts, dev)
    cases, max_err = [], 0.0
    for n, n_ds, q, rings, mb in kernel_shapes(scan_w, sensor, dev):
        g_max = max(n // 4, 64)
        what = f"N={n} rings={rings}"
        got = knn.knn_grouped(m, q, params, k=K, rings=rings, max_buckets=mb)
        want = knn.knn_grouped_plain(m, q, params, k=K, rings=rings, max_buckets=mb)
        max_err = max(max_err, compare_knn(got, want, what))
        grp = knn.group_queries(m, q, params, g_max, rings=rings, max_buckets=mb)
        args, n_exact = raw_contract(grp, m.pts, what)
        ms = time_ms(lambda: knn.group_topk(*args))
        # the floor that g_max sets: the same groups with every bucket
        # absent, so every CTA takes the early exit
        no_work = (torch.full_like(grp.bucket_ids, -1),) + args[1:]
        early_exit_ms = time_ms(lambda: knn.group_topk(*no_work))
        plain_ms = time_ms(lambda: knn.group_topk_plain(*args), reps=5, batch=1, warmup=1)
        bound_ms, bound_by, flops, nbytes = topk_bound(grp, m.pts, K, knn.FAR)
        present = (grp.bucket_ids >= 0).sum(-1)
        real = (grp.order_q[..., 0] != knn.FAR).sum(-1)
        work = (present > 0) & (real > 0)
        cases.append(dict(
            n=n, ds_queries=n_ds, g_max=g_max, nb=int(grp.bucket_ids.shape[1]), rings=rings,
            groups_used=int((present > 0).sum()), groups_with_work=int(work.sum()),
            full_groups_with_work=int((work & (real == knn.GROUP_CAP)).sum()),
            real_slots=int(real.sum()), real_slots_with_work=int(real[work].sum()),
            present_buckets=int(present.sum()),
            present_buckets_with_work=int(present[work].sum()),
            pairs=flops / 8, exact_entries=n_exact,
            valid_frac_ds=float(want[2][:n_ds].float().mean()), ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
            early_exit_ms=early_exit_ms, flop=flops, bytes=nbytes))
    # overflow (far fewer groups than voxels) and an empty map
    q = next(c for c in kernel_shapes(scan_w, sensor, dev) if c[0] == 8192)[2]
    for mm, g_max, what in ((m, 64, "overflow"), (hg.make_map(params, device=dev), 2048, "empty")):
        got = knn.knn_grouped(mm, q, params, k=K, g_max=g_max)
        want = knn.knn_grouped_plain(mm, q, params, k=K, g_max=g_max)
        max_err = max(max_err, compare_knn(got, want, what))
        raw_contract(knn.group_queries(mm, q, params, g_max), mm.pts, what)
        frac = float(want[2].float().mean())
        if (what == "empty" and frac != 0.0) or (what == "overflow" and not 0.0 < frac < 0.5):
            raise AssertionError(f"{what}: valid fraction {frac}")
    return cases, max_err


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def main_config():
    from limovelo_tpu_torch import DEFAULT

    # the reference's DEFAULT profile with the configuration the JAX package
    # documents for its grouped kernel: the 1-ring envelope
    return DEFAULT.replace(knn_rings=1, knn_backend="grouped", imu_rate=SIM["imu_rate"])


def make_sim():
    from limovelo_tpu_torch.io.simulate import circle_trajectory, room_world, simulate

    world = room_world(size=24, n_boxes=10)
    sim = simulate(world, circle_trajectory(radius=4, omega=0.5), main_config(),
                   duration=SIM["duration"], lidar_lines=SIM["lidar_lines"],
                   pts_per_line=SIM["pts_per_line"], imu_rate=SIM["imu_rate"])
    return world, sim


def cast_views(world, sim, fractions):
    """World-frame cloud of the sensor's rays cast from the ground-truth
    poses at `fractions` of the run (the kernel phase's map and scan), and
    the last of those poses' positions."""
    el = np.deg2rad(np.linspace(-15, 15, SIM["lidar_lines"]))
    az = np.linspace(0, 2 * np.pi, SIM["pts_per_line"], endpoint=False)
    dirs = np.stack([np.cos(el)[None, :] * np.cos(az)[:, None],
                     np.cos(el)[None, :] * np.sin(az)[:, None],
                     np.broadcast_to(np.sin(el)[None, :], (len(az), len(el)))], -1).reshape(-1, 3)
    clouds = []
    for f in fractions:
        i = int(round(f * (len(sim.gt_t) - 1)))
        d_w = dirs @ sim.gt_R[i].T
        r = world(np.tile(sim.gt_p[i], (len(d_w), 1)), d_w)
        ok = np.isfinite(r) & (r < 80.0)
        clouds.append(sim.gt_p[i] + d_w[ok] * r[ok, None])
    return np.concatenate(clouds).astype(np.float32), sim.gt_p[i]


class counted_windows:
    """Every LioPipeline window run inside the block, counted, whichever
    code built the pipeline (the CLI phases': the CLI): the launch count is
    set to 0 on entry and read on exit; per window (launches, accepted,
    seconds, raw points)."""

    def __enter__(self):
        from limovelo_tpu_torch.ops.cuda import knn
        from limovelo_tpu_torch.runtime.pipeline import LioPipeline

        self.windows, self._step = [], LioPipeline.step_window
        step, windows = self._step, self.windows

        def counted(pipe, t1, t2):
            n = len(pipe.accum.get_points(t1, t2)[0])
            before, t0 = knn.knn_grouped.launches, time.perf_counter()
            rec = step(pipe, t1, t2)
            windows.append((knn.knn_grouped.launches - before, rec is not None,
                            time.perf_counter() - t0, n))
            return rec

        LioPipeline.step_window = counted
        knn.knn_grouped.launches = 0
        return self

    def __exit__(self, *exc):
        from limovelo_tpu_torch.ops.cuda import knn
        from limovelo_tpu_torch.runtime.pipeline import LioPipeline

        LioPipeline.step_window = self._step
        self.launches = knn.knn_grouped.launches
        return False

    def check_every_window(self, what: str):
        per_win = np.array([w[0] for w in self.windows])
        if not self.windows or not np.all(per_win >= 1):
            raise AssertionError(f"{what}: windows without a kernel launch: "
                                 f"{int((per_win < 1).sum())}/{len(self.windows)}")


def drive(pipe, feed):
    """Run `feed(pipe)` with every window counted (`counted_windows`);
    returns (per window: launches, accepted, seconds, raw points; the
    launches).  On the card, every window must have launched the grouped
    kernel."""
    with counted_windows() as cw:
        feed(pipe)
    if pipe.device.type == "cuda":
        cw.check_every_window(type(pipe).__name__)
    return cw.windows, cw.launches


def window_stats(windows, launches) -> dict:
    step_s = np.array([w[2] for w in windows])
    return dict(windows=len(windows), kernel_launches=int(launches),
                launches_per_window=float(launches / len(windows)),
                step_p50_ms=float(np.percentile(step_s, 50) * 1e3),
                step_p95_ms=float(np.percentile(step_s, 95) * 1e3),
                windows_per_s=float(len(windows) / step_s.sum()))


def replay(sim, config, device=None):
    """The port's LioPipeline on `device` (DEVICE by default) over the whole
    stream, counted."""
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    pipe = LioPipeline(config, device=device or DEVICE)
    return (pipe,) + drive(pipe, whole(sim))


def whole(sim):
    from limovelo_tpu_torch.io.simulate import replay_into

    return lambda pipe: replay_into(pipe, sim)


def truncate(sim, t_end: float):
    """The stream's first `t_end` seconds of scans, with the IMU samples
    that let the pipeline process every window ending by then."""
    from limovelo_tpu_torch.io.simulate import SimData

    t0 = sim.imu_t[0]
    keep = sim.imu_t <= t0 + t_end + 0.1 + 1e-9
    return SimData(scans=[s for s in sim.scans if s.stamp < t0 + t_end - 1e-9],
                   imu_t=sim.imu_t[keep], imu_a=sim.imu_a[keep], imu_w=sim.imu_w[keep],
                   gt_t=sim.gt_t, gt_R=sim.gt_R, gt_p=sim.gt_p)


def checked_result(pipe, windows, sim):
    """The run's records, checked: one per accepted window, finite poses;
    returns (result, ATE)."""
    from limovelo_tpu_torch.runtime.evaluate import ate_rmse

    res = pipe.result
    accepted = sum(w[1] for w in windows)
    if accepted != len(res.records) or not res.records:
        raise AssertionError(f"accepted {accepted}, records {len(res.records)}")
    if not np.all(np.isfinite(res.positions)) or not np.all(np.isfinite(res.rotations)):
        raise AssertionError("non-finite pose")
    return res, ate_rmse(res.times, res.positions, sim.gt_t, sim.gt_R, sim.gt_p)[0]


def main_phase(sim):
    t0 = time.perf_counter()
    pipe, windows, launches = replay(sim, main_config())
    res, ate = checked_result(pipe, windows, sim)
    wall = time.perf_counter() - t0
    on_card = pipe.device.type == "cuda"
    if on_card and launches < len(res.records):
        raise AssertionError(f"launches {launches} < records {len(res.records)}")
    ds = np.array([r.ds_count for r in res.records], float)
    nm = np.array([r.num_matches for r in res.records], float)
    match_frac = float(nm[1:].sum() / ds[1:].sum())
    stats = dict(
        **window_stats(windows, launches), records=len(res.records), ate_m=ate,
        mean_ds_count=float(ds.mean()), mean_matches=float(nm.mean()), match_frac=match_frac,
        replay_wall_s=wall, collapsed_windows=pipe.collapsed_windows,
        stage_p50_ms={k: v["p50_ms"] for k, v in pipe.timers.summary().items()},
        peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20 if on_card else None)
    phase("main", **stats)
    if ate >= 0.10:
        raise AssertionError(f"ATE {ate} m >= 0.10 m")
    # the JAX package itself matches well under half the downsampled points
    # in this stream's first windows (the DEFAULT profile's plane gates
    # against a 16-line map); a broken match path gives 0, so the floor
    # sits well below the reference
    if match_frac < MIN_MATCH_FRAC or not np.all(nm[1:] > 0):
        raise AssertionError(f"matches are {match_frac:.3f} of the downsampled points")
    return pipe, res, stats


def cpu_phase(sim, res_card, config, name="cpu", span_s=CPU_REPLAY_S):
    """The stream's first `span_s` seconds on the CPU (plain versions): the
    card's first records, positions within POS_TOL_M; returns the CPU's
    records."""
    t0 = time.perf_counter()
    pipe, _, _ = replay(truncate(sim, span_s), config, "cpu")
    cpu = pipe.result
    n = len(cpu.records)
    if n < 3 or not np.array_equal(cpu.times, res_card.times[:n]):
        raise AssertionError(f"{name}: CPU records {cpu.times} are not the card's first {n}: "
                             f"{res_card.times[:n]}")
    d = np.linalg.norm(cpu.positions - res_card.positions[:n], axis=1)
    grew = growth_records(cpu.records)
    matches = [r.num_matches for r in cpu.records[grew[0]:]] if len(grew) else []
    phase(name, span_s=span_s, records=n, growth_events=len(grew),
          records_after_growth=len(matches), min_matches_after_growth=min(matches, default=0),
          max_pos_diff_m=float(d.max()), seconds=time.perf_counter() - t0)
    if d.max() >= POS_TOL_M:
        raise AssertionError(f"{name}: card vs CPU positions differ by {d.max()} m")
    return cpu.records


def growth_records(records) -> np.ndarray:
    """Indices of the records whose map holds more points than the one
    before (the telemetry shows the map after the previous map update)."""
    mp = np.array([r.map_points for r in records])
    return np.nonzero(np.diff(mp) > 0)[0] + 1


def offline_phase(sim, main_ate: float):
    """Offline mapping: the map updated once per rotation by re-deskewing
    it with the final states."""
    t0 = time.perf_counter()
    config = main_config().replace(mapping="offline")
    pipe, windows, launches = replay(sim, config)
    res, ate = checked_result(pipe, windows, sim)
    events = len(growth_records(res.records))
    rotations = (res.times[-1] - res.times[0]) / config.full_rotation_time
    stats = dict(**window_stats(windows, launches), records=len(res.records), ate_m=ate,
                 growth_events=events, rotations=rotations,
                 collapsed_windows=pipe.collapsed_windows,
                 offline_map_p50_ms=pipe.timers.summary()["offline_map"]["p50_ms"],
                 seconds=time.perf_counter() - t0)
    phase("offline", **stats)
    if ate >= max(3.0 * main_ate, 0.15):
        raise AssertionError(f"offline ATE {ate} m against online {main_ate} m")
    if not 0.5 * rotations <= events <= rotations + 2:
        raise AssertionError(f"{events} map growth events for {rotations:.1f} rotations")
    cpu = cpu_phase(sim, res, config, "offline_cpu", OFFLINE_CPU_REPLAY_S)
    grew = growth_records(cpu)
    if len(grew) < 2 or min(r.num_matches for r in cpu[grew[0]:]) == 0:
        raise AssertionError("offline_cpu: no records that localize against the maps that "
                             f"mapping_step built (growth at records {grew.tolist()})")
    return stats


def hd_map_phase(sim, main_pipe):
    """`save_map` of the main run's map, then `from_hd_map` over the same
    stream with the map frozen: the map's tables equal before and after."""
    from limovelo_tpu_torch.runtime.checkpoint import save_map
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    t0 = time.perf_counter()
    path = ROOT / "build" / "hd_map.npz"
    path.parent.mkdir(exist_ok=True)
    save_map(str(path), main_pipe.map, main_pipe.grid)
    pipe = LioPipeline.from_hd_map(main_config(), str(path), device=DEVICE)
    if pipe.config.mapping_mode != "none":
        raise AssertionError(f"mapping mode {pipe.config.mapping_mode}")
    before = {k: getattr(pipe._preloaded_map, k).clone() for k in ("keys", "pts", "cell_d2")}
    n_before = int(pipe._preloaded_map.num_points)
    windows, launches = drive(pipe, whole(sim))
    res, ate = checked_result(pipe, windows, sim)
    same = all(torch.equal(getattr(pipe.map, k), v) for k, v in before.items())
    stats = dict(**window_stats(windows, launches), records=len(res.records), ate_m=ate,
                 map_points=n_before, map_npz_bytes=path.stat().st_size, map_unchanged=same,
                 seconds=time.perf_counter() - t0)
    phase("hd_map", **stats)
    if not same or int(pipe.map.num_points) != n_before:
        raise AssertionError("the frozen HD map changed")
    if ate >= 0.30:
        raise AssertionError(f"frozen-map ATE {ate} m >= 0.30 m")
    return stats


def checkpoint_phase(sim, res_main):
    """Feed to CHECKPOINT_AT_S, save_checkpoint, load_checkpoint into a
    fresh card pipeline, feed the rest: the records and positions of the
    main run."""
    from limovelo_tpu_torch.io.simulate import replay_into
    from limovelo_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    t0 = time.perf_counter()
    cut = int(sum(s.t[-1] < sim.scans[0].stamp + CHECKPOINT_AT_S for s in sim.scans))
    path = ROOT / "build" / "checkpoint.npz"
    path.parent.mkdir(exist_ok=True)
    first = LioPipeline(main_config(), device=DEVICE)
    w1, l1 = drive(first, lambda p: replay_into(p, sim, 0, cut))
    ts = time.perf_counter()
    save_checkpoint(str(path), first)
    save_s = time.perf_counter() - ts
    second = LioPipeline(main_config(), device=DEVICE)
    ts = time.perf_counter()
    load_checkpoint(str(path), second)
    load_s = time.perf_counter() - ts
    w2, l2 = drive(second, lambda p: replay_into(p, sim, cut))
    times = np.concatenate([first.result.times, second.result.times])
    pos = np.concatenate([first.result.positions, second.result.positions])
    same_times = np.array_equal(times, res_main.times)
    d = np.linalg.norm(pos - res_main.positions, axis=1) if same_times else np.array([np.inf])
    stats = dict(**window_stats(w1 + w2, l1 + l2), cut_scans=cut,
                 records_before=len(first.result.records), records_after=len(second.result.records),
                 same_record_times=same_times, max_pos_diff_m=float(d.max()),
                 npz_bytes=os.path.getsize(path), save_s=save_s, load_s=load_s,
                 seconds=time.perf_counter() - t0)
    phase("checkpoint", **stats)
    if not same_times or not second.result.records:
        raise AssertionError("the resumed run's records are not the main run's")
    if d.max() >= RESUME_TOL_M:
        raise AssertionError(f"resumed positions differ by {d.max()} m")
    return stats


def tail_peaks(buckets: np.ndarray) -> list:
    """The bucket count's peak in each finished span between two prunes (a
    drop of the count) that starts in the run's second half."""
    cuts = np.nonzero(np.diff(buckets) < 0)[0] + 1
    starts = np.r_[0, cuts]
    spans = np.split(buckets, cuts)[:-1]        # the last span is unfinished
    return [int(s.max()) for s0, s in zip(starts, spans) if s0 >= len(buckets) // 2]


def prune_phase():
    """The prune policy on a long corridor, against the same run unpruned:
    the map's bucket count falls at the prunes, its peaks stop growing, and
    the unpruned map grows past it."""
    from limovelo_tpu_torch.io.simulate import corridor_trajectory, corridor_world, simulate
    from limovelo_tpu_torch.mapping import hashgrid as hg

    t0 = time.perf_counter()
    config = main_config().replace(map_prune_radius=25.0, map_prune_every=0.5)
    sim = simulate(corridor_world(length=120.0, width=8.0, pillar_every=6.0),
                   corridor_trajectory(speed=8.0), config, duration=PRUNE_S,
                   lidar_lines=SIM["lidar_lines"], pts_per_line=SIM["pts_per_line"],
                   imu_rate=SIM["imu_rate"], seed=13, max_range=PRUNE_RANGE_M)
    sim_s = time.perf_counter() - t0
    pipe, windows, launches = replay(sim, config)
    res, ate = checked_result(pipe, windows, sim)
    buckets = np.array([r.map_buckets for r in res.records])
    peaks = tail_peaks(buckets)
    early, late = peaks[:len(peaks) // 2], peaks[len(peaks) // 2:]
    m = hg.HashGridMap(*(t.clone() for t in pipe.map))
    center = torch.as_tensor(res.positions[-1], device=DEVICE)
    prune_ms = time_ms(lambda: hg.prune(m, center, config.map_prune_radius, pipe.grid))
    timers = pipe.timers.summary()
    u_pipe, u_windows, u_launches = replay(sim, config.replace(map_prune_radius=0.0))
    u_res, u_ate = checked_result(u_pipe, u_windows, sim)
    unbounded = np.array([r.map_buckets for r in u_res.records])
    stats = dict(**window_stats(windows, launches), records=len(res.records), ate_m=ate,
                 prunes=timers["prune"]["n"], prune_host_p50_ms=timers["prune"]["p50_ms"],
                 prune_device_ms=prune_ms, bucket_drops=int(np.sum(np.diff(buckets) < 0)),
                 buckets_max=int(buckets.max()), buckets_last=int(buckets[-1]),
                 tail_peaks=peaks,
                 unpruned=dict(**window_stats(u_windows, u_launches), ate_m=u_ate,
                               buckets_last=int(unbounded[-1])),
                 sim_s=sim_s, seconds=time.perf_counter() - t0)
    phase("prune", **stats)
    if stats["bucket_drops"] < 1:
        raise AssertionError("the map's bucket count never fell")
    if len(peaks) < 4 or max(late) > (1 + PLATEAU_SHARE) * max(early):
        raise AssertionError(f"the pruned map still grows: peaks {peaks}")
    if unbounded[-1] <= 1.5 * buckets[-1]:
        raise AssertionError(f"prune had no effect: {unbounded[-1]} vs {buckets[-1]} buckets")
    return stats


def inject_drift(frames, yaw_per_edge: float, z_per_edge: float = 0.0):
    """Re-chain the keyframe odometry with an extra yaw (and z) per edge:
    accumulated heading drift.  Scans are stored in the LiDAR frame, so
    loop registration then sees the drifted initial guess and the same
    geometry (tests/test_slam.py)."""
    from scipy.spatial.transform import Rotation as Rsc

    dRz = Rsc.from_euler("z", yaw_per_edge).as_matrix()
    R_prev, p_prev = frames[0].R.copy(), frames[0].p.copy()
    for k in range(1, len(frames)):
        rel_R = R_prev.T @ frames[k].R
        rel_p = R_prev.T @ (frames[k].p - p_prev)
        R_prev, p_prev = frames[k].R.copy(), frames[k].p.copy()
        frames[k].R = frames[k - 1].R @ (rel_R @ dRz)
        frames[k].p = frames[k - 1].p + frames[k - 1].R @ rel_p
        frames[k].p[2] += z_per_edge
        frames[k].R_opt, frames[k].p_opt = frames[k].R.copy(), frames[k].p.copy()


def slam_phase():
    """SlamPipeline over more than one revolution: keyframes, loop closure
    and the pose graph; then the keyframe odometry drifted by 1° and 1 cm
    per edge, loops re-detected, and the optimized keyframes."""
    from limovelo_tpu_torch.io.simulate import circle_trajectory, room_world, simulate
    from limovelo_tpu_torch.runtime.evaluate import ate_rmse
    from limovelo_tpu_torch.runtime.slam import SlamPipeline

    t0 = time.perf_counter()
    from limovelo_tpu_torch.config import InitializationParams

    # a keyframe stores its window's cloud: with the DEFAULT warm-up's 50 Hz
    # windows that is a fifth of a rotation, and two fifths seen from the
    # same place on two laps need not overlap; full-rotation windows, as in
    # tests/test_slam.py's configuration
    config = main_config().replace(Initialization=InitializationParams(times=(), deltas=(0.1,)))
    sim = simulate(room_world(size=24, n_boxes=10), circle_trajectory(radius=4, omega=0.8),
                   config, duration=SLAM_S, lidar_lines=SIM["lidar_lines"],
                   pts_per_line=SIM["pts_per_line"], imu_rate=SIM["imu_rate"])
    sim_s = time.perf_counter() - t0
    pipe = SlamPipeline(config, device=DEVICE, kf_min_translation=1.0, loop_check_every=2,
                        loop_min_index_gap=8, loop_max_distance=3.0)
    windows, launches = drive(pipe, whole(sim))
    res, ate = checked_result(pipe, windows, sim)
    frames = pipe.keyframes.frames
    attempts, closures = len(pipe.loop_stats), len(pipe.loop_edges)
    _, ps = pipe.optimized_trajectory()
    spread = float(np.linalg.norm(ps - pipe.keyframes.positions(optimized=False), axis=-1).max())
    kf_ate = lambda pos: ate_rmse(np.array([f.t for f in frames]), pos, sim.gt_t, sim.gt_R,
                                  sim.gt_p)[0]

    inject_drift(frames, yaw_per_edge=np.deg2rad(1.0), z_per_edge=0.01)
    for c in (pipe.loop_edges, pipe.loop_stats, pipe._graph_loops, pipe._closed_pairs):
        c.clear()
    ts = time.perf_counter()
    pipe._check_loops()
    check_s = time.perf_counter() - ts
    ate_drifted = kf_ate(pipe.keyframes.positions(optimized=False))
    ts = time.perf_counter()
    _, ps_opt = pipe.optimized_trajectory()
    opt_s = time.perf_counter() - ts
    graph = pipe.pose_graph()
    ate_opt = kf_ate(ps_opt)
    attempt = lambda a: (a["i"], a["j"], round(a["rms"], 4), a["matches"], bool(a["accepted"]))
    stats = dict(**window_stats(windows, launches), records=len(res.records), ate_m=ate,
                 keyframes=len(frames), loop_attempts=attempts, loop_closures=closures,
                 optimized_vs_odometry_max_m=spread,
                 drifted_loop_attempts=len(pipe.loop_stats),
                 drifted_loop_closures=len(pipe.loop_edges),
                 drifted_attempts=[attempt(a) for a in pipe.loop_stats],
                 consensus_rejected=pipe.consensus_rejected, kf_ate_drifted_m=ate_drifted,
                 kf_ate_optimized_m=ate_opt, drifted_check_loops_s=check_s,
                 optimize_s=opt_s, sim_s=sim_s, seconds=time.perf_counter() - t0)
    phase("slam", **stats)
    if len(frames) < 15:
        raise AssertionError(f"{len(frames)} keyframes < 15")
    if spread >= 1.0:
        raise AssertionError(f"the optimized keyframes moved {spread} m from the odometry")
    if ate_drifted <= 0.25 or not pipe.loop_edges or ate_opt >= 0.5 * ate_drifted:
        raise AssertionError(f"loop closure under drift: {len(pipe.loop_edges)} closures, "
                             f"keyframe ATE {ate_opt} m against {ate_drifted} m drifted")
    return stats, graph


# ---------------------------------------------------------------------------
# multi-device: ranks spawned on this machine
# ---------------------------------------------------------------------------


def shard_rank(mesh, sim, runs):
    """One spawned rank of the shard phases.  `runs`: (name, what, arg);
    what "points"/"map" replays the main stream through
    LioPipeline(main_config(), mesh=mesh, shard=what), counting this rank's
    grouped-kernel launches, seconds and collective seconds per window;
    "posegraph" solves arg = (graph, Rs, ps) edge-sharded."""
    from limovelo_tpu_torch.graph import optimize_pose_graph_sharded
    from limovelo_tpu_torch.io.simulate import replay_into
    from limovelo_tpu_torch.mapping.hashgrid import EMPTY_KEY, TOMBSTONE_KEY
    from limovelo_tpu_torch.ops.cuda import knn
    from limovelo_tpu_torch.parallel.map_sharding import owner_of
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    if mesh.device.type != "cuda":
        raise AssertionError(f"rank {mesh.rank} is on {mesh.device}, not the card")
    out = {"mesh": mesh.describe()}
    for name, what, arg in runs:
        t0 = time.perf_counter()
        if what == "posegraph":
            Rs, ps, costs = optimize_pose_graph_sharded(*arg, mesh, iters=10)
            out[name] = dict(Rs=Rs, ps=ps, costs=costs, seconds=time.perf_counter() - t0)
            continue
        pipe = LioPipeline(main_config(), mesh=mesh, shard=what)
        step, windows = pipe.step_window, []

        def counted(t1, t2, pipe=pipe, step=step, windows=windows):
            n = len(pipe.accum.get_points(t1, t2)[0])
            real = np.clip(n - mesh.rank * pipe.config.bucket_for(
                max(n, 1), pipe.config.point_buckets) // mesh.size, 0, None)
            before, c0, ts = knn.knn_grouped.launches, mesh.stats["seconds"], time.perf_counter()
            rec = step(t1, t2)
            windows.append((knn.knn_grouped.launches - before, rec is not None,
                            time.perf_counter() - ts, mesh.stats["seconds"] - c0, n, real))
            return rec

        pipe.step_window = counted
        replay_into(pipe, sim)
        keys = pipe.map.keys
        live = ~(torch.all(keys == EMPTY_KEY, -1) | torch.all(keys == TOMBSTONE_KEY, -1))
        owners = owner_of(keys[live], mesh.size)
        res = pipe.result
        out[name] = dict(times=res.times, positions=res.positions, windows=windows,
                         local_buckets=int(pipe.map.num_buckets),
                         table_rows=int(keys.shape[0]),
                         telemetry_buckets=res.records[-1].map_buckets if res.records else None,
                         owners_ok=bool((owners == mesh.rank).all()),
                         on_card=all(t.device.type == "cuda" for t in (*pipe.x, *pipe.map)),
                         seconds=time.perf_counter() - t0)
    return out


def rank_stats(r: dict, size: int) -> dict:
    """One rank's windows: launches, step p50/p95, collective seconds, and
    the share of its rows that hold real points (its contiguous block of
    the padded window)."""
    w = r["windows"]
    step_s = np.array([x[2] for x in w])
    coll_s = np.array([x[3] for x in w])
    launches = np.array([x[0] for x in w])
    n, ahead = np.array([x[4] for x in w]), np.array([x[5] for x in w])
    bucket = np.array([main_config().bucket_for(max(int(k), 1), main_config().point_buckets)
                       for k in n])
    rows = bucket // size
    return dict(windows=len(w), kernel_launches=int(launches.sum()),
                real_row_share=float(np.mean(np.minimum(ahead, rows) / rows)),
                windows_without_launch=int((launches < 1).sum()),
                step_p50_ms=float(np.percentile(step_s, 50) * 1e3),
                step_p95_ms=float(np.percentile(step_s, 95) * 1e3),
                collective_s_per_window=float(coll_s.mean()),
                collective_share=float(coll_s.sum() / step_s.sum()),
                on_card=r["on_card"], seconds=r["seconds"])


def check_shard_run(name: str, ranks: list, sim, res_main, main_ate: float, pos_tol: float,
                    every_window: bool = True) -> dict:
    """Rank 0's records against the main phase's (the same record times,
    positions within `pos_tol`, ATE below max(0.05 m, 1.5 x main's)); every
    rank on the card and, with `every_window`, each window's grouped-kernel
    launch on each rank; the ranks' estimates identical."""
    from limovelo_tpu_torch.runtime.evaluate import ate_rmse

    runs = [r[name] for r in ranks]
    r0 = runs[0]
    same_times = np.array_equal(r0["times"], res_main.times)
    d = (np.linalg.norm(r0["positions"] - res_main.positions, axis=1) if same_times
         else np.array([np.inf]))
    ate = ate_rmse(r0["times"], r0["positions"], sim.gt_t, sim.gt_R, sim.gt_p)[0]
    per_rank = [rank_stats(r, len(ranks)) for r in runs]
    stats = dict(mesh=ranks[0]["mesh"], ranks=per_rank, records=len(r0["times"]), ate_m=ate,
                 main_ate_m=main_ate, same_record_times=same_times,
                 max_pos_diff_m=float(d.max()),
                 kernel_launches=int(sum(p["kernel_launches"] for p in per_rank)))
    if not all(p["on_card"] for p in per_rank):
        raise AssertionError(f"{name}: a rank's state or map left the card")
    if every_window and any(p["windows_without_launch"] for p in per_rank):
        raise AssertionError(f"{name}: windows without a kernel launch: "
                             f"{[p['windows_without_launch'] for p in per_rank]}")
    if not same_times or d.max() >= pos_tol:
        raise AssertionError(f"{name}: records differ from the main run's by {d.max()} m "
                             f"(same times: {same_times})")
    if not ate < max(0.05, 1.5 * main_ate):
        raise AssertionError(f"{name}: ATE {ate} m against main's {main_ate} m")
    for r in runs[1:]:
        if not np.array_equal(r["positions"], r0["positions"]):
            raise AssertionError(f"{name}: the ranks' estimates differ")
    return stats


def shard_phases(sim, res_main, main_stats, slam_graph):
    """The multi-device phases: the points- and map-sharded main stream and
    the edge-sharded pose graph on two gloo ranks sharing the card, a
    one-rank nccl world, and two nccl ranks where there are two cards.
    Returns the launches counted on all ranks."""
    from limovelo_tpu_torch.graph import optimize_pose_graph
    from limovelo_tpu_torch.parallel import multihost as mh

    main_ate = main_stats["ate_m"]
    t0 = time.perf_counter()
    ranks = mh.spawn(shard_rank, SHARD_RANKS, device="cuda", backend="gloo",
                     timeout_s=SHARD_TIMEOUT_S,
                     args=(sim, [("shard_points", "points", None), ("shard_map", "map", None),
                                 ("posegraph_sharded", "posegraph", slam_graph)]))
    world_s = time.perf_counter() - t0
    pts = check_shard_run("shard_points", ranks, sim, res_main, main_ate, SHARD_POS_TOL_M)
    phase("shard_points", **pts, main_step_p50_ms=main_stats["step_p50_ms"],
          main_step_p95_ms=main_stats["step_p95_ms"], world_s=world_s)
    launches = pts["kernel_launches"]

    mp = check_shard_run("shard_map", ranks, sim, res_main, main_ate, SHARD_POS_TOL_M,
                         every_window=False)
    runs = [r["shard_map"] for r in ranks]
    bucket_sum = sum(r["local_buckets"] for r in runs)
    phase("shard_map", **mp, local_buckets=[r["local_buckets"] for r in runs],
          bucket_sum=bucket_sum, telemetry_buckets=runs[0]["telemetry_buckets"],
          table_rows=[r["table_rows"] for r in runs], owners_ok=[r["owners_ok"] for r in runs])
    owners = [r["owners_ok"] for r in runs]
    if bucket_sum != runs[0]["telemetry_buckets"] or not all(owners):
        raise AssertionError(f"shard_map: buckets {bucket_sum} against the telemetry's "
                             f"{runs[0]['telemetry_buckets']}, owners {owners}")
    launches += mp["kernel_launches"]

    g, Rs, ps = slam_graph
    Rs1, ps1, _ = optimize_pose_graph(g, Rs, ps, iters=10, device=DEVICE)
    errs = [max(float(np.abs(r["posegraph_sharded"]["Rs"] - Rs1).max()),
                float(np.abs(r["posegraph_sharded"]["ps"] - ps1).max())) for r in ranks]
    phase("posegraph_sharded", keyframes=len(ps), edges=len(g.weights), max_abs_err=errs,
          seconds=[r["posegraph_sharded"]["seconds"] for r in ranks])
    if max(errs) >= POSEGRAPH_TOL:
        raise AssertionError(f"posegraph_sharded: {errs} against one device")

    t0 = time.perf_counter()
    ranks = mh.spawn(shard_rank, 1, device="cuda", backend="nccl", timeout_s=SHARD_TIMEOUT_S,
                     args=(sim, [("shard_nccl", "points", None)]))
    nc = check_shard_run("shard_nccl", ranks, sim, res_main, main_ate, NCCL_POS_TOL_M)
    phase("shard_nccl", **nc, main_step_p50_ms=main_stats["step_p50_ms"],
          main_step_p95_ms=main_stats["step_p95_ms"], world_s=time.perf_counter() - t0)
    launches += nc["kernel_launches"]

    if torch.cuda.device_count() >= SHARD_RANKS:
        t0 = time.perf_counter()
        ranks = mh.spawn(shard_rank, SHARD_RANKS, device="cuda", backend="nccl",
                         timeout_s=SHARD_TIMEOUT_S,
                         args=(sim, [("shard_points_nccl", "points", None)]))
        n2 = check_shard_run("shard_points_nccl", ranks, sim, res_main, main_ate,
                             SHARD_POS_TOL_M)
        phase("shard_points_nccl", run=True, **n2, world_s=time.perf_counter() - t0)
        launches += n2["kernel_launches"]
    else:
        phase("shard_points_nccl", run=False,
              reason=f"{torch.cuda.device_count()} card(s): nccl needs a card per rank")
    return launches


def cli_devices_phase():
    """`sim --devices 2 --shard points` through the CLI in process."""
    from limovelo_tpu_torch.__main__ import main as cli
    from limovelo_tpu_torch.io.simulate import circle_trajectory, room_world, simulate
    from limovelo_tpu_torch.runtime.evaluate import ate_rmse

    t0 = time.perf_counter()
    cfg = smoke_profiles()["smoke_sim"]
    out = SMOKE_DIR / "sim_devices.tum"
    cli(["sim", "--world", "room", "--duration", str(CLI_SIM_S), "--config", "smoke_sim",
         "--devices", str(SHARD_RANKS), "--shard", "points", "--out", str(out)])
    cli_s = time.perf_counter() - t0
    times, pos = read_tum(out)
    # the CLI's own stream (`sim`: its configuration and simulator defaults)
    sim = simulate(room_world(), circle_trajectory(omega=0.5),
                   cfg.replace(real_time=False, min_dist=0.5, downsample_prec=0.3),
                   duration=CLI_SIM_S)
    ate = ate_rmse(times, pos, sim.gt_t, sim.gt_R, sim.gt_p)[0]
    phase("cli_devices", records=len(times), ate_m=ate, cli_s=cli_s,
          seconds=time.perf_counter() - t0)
    if len(times) < 5 or not np.all(np.isfinite(pos)) or not ate < EVAL_ATE_M:
        raise AssertionError(f"cli_devices: {len(times)} records, ATE {ate} m")


def smoke_profiles():
    """The configurations the CLI phases name, added to the port's
    PROFILES (the card machine has no PyYAML for a --config file): the
    KITTI, XALOC and DEFAULT profiles with the 1-ring grouped KNN.  The XALOC
    profile's warm-up has as many deltas as times, which the warm-up
    schedule rejects in both packages (ROADMAP, "Faults to reproduce, not
    fix"): the bag phase warms up as DEFAULT does, 10 → 20 → 50 Hz windows
    at 0.5 s and 1.0 s."""
    from limovelo_tpu_torch.config import (DEFAULT, KITTI, PROFILES, XALOC,
                                           InitializationParams)

    PROFILES["smoke_kitti"] = KITTI.replace(knn_rings=1, knn_backend="grouped")
    PROFILES["smoke_sim"] = DEFAULT.replace(knn_rings=1, knn_backend="grouped")
    PROFILES["smoke_xaloc"] = XALOC.replace(
        knn_rings=1, knn_backend="grouped",
        Initialization=InitializationParams(times=(0.5, 1.0), deltas=(0.1, 0.05, 0.02)))
    return PROFILES


def read_tum(path):
    d = np.atleast_2d(np.loadtxt(path))
    return d[:, 0], d[:, 1:4]


def kitti_phase():
    """A KITTI raw drive at HDL-64 width through the `kitti` CLI command."""
    from limovelo_tpu_torch.__main__ import main as cli
    from limovelo_tpu_torch.io.fixtures import write_kitti_drive
    from limovelo_tpu_torch.io.kitti import KittiRawReader, oxts_trajectory
    from limovelo_tpu_torch.io.simulate import corridor_trajectory, corridor_world
    from limovelo_tpu_torch.runtime.evaluate import ate_rmse

    t0 = time.perf_counter()
    cfg = smoke_profiles()["smoke_kitti"]
    drive_dir = SMOKE_DIR / "2011_09_26_drive_0001_sync"
    sim = write_kitti_drive(str(drive_dir), corridor_world(length=120.0, width=12.0),
                            corridor_trajectory(speed=8.0), cfg, seed=5, **KITTI_SIM)
    sim_s = time.perf_counter() - t0
    out, map_path = SMOKE_DIR / "kitti.tum", SMOKE_DIR / "kitti_map.npz"
    ts = time.perf_counter()
    with counted_windows() as cw:
        cli(["kitti", "--drive", str(drive_dir), "--config", "smoke_kitti", "--out", str(out),
             "--save-map", str(map_path), "--device", DEVICE])
    replay_s = time.perf_counter() - ts
    cw.check_every_window("kitti")
    times, pos = read_tum(out)
    accepted = sum(w[1] for w in cw.windows)
    ate = ate_rmse(times, pos, sim.gt_t, sim.gt_R, sim.gt_p)[0]
    ate_oxts = ate_rmse(times, pos, *oxts_trajectory(KittiRawReader(str(drive_dir))))[0]
    raw = np.array([w[3] for w in cw.windows])
    stats = dict(**window_stats(cw.windows, cw.launches), records=len(times), ate_m=ate,
                 ate_oxts_m=ate_oxts, rays_per_scan=KITTI_SIM["lidar_lines"]
                 * KITTI_SIM["pts_per_line"],
                 returns_per_scan=float(np.mean([len(s.pts) for s in sim.scans])),
                 max_window_points=int(raw.max()),
                 point_bucket=cfg.bucket_for(int(raw.max()), cfg.point_buckets),
                 windows_over_largest_bucket=int((raw > cfg.point_buckets[-1]).sum()),
                 map_npz_bytes=map_path.stat().st_size, sim_s=sim_s, replay_s=replay_s,
                 seconds=time.perf_counter() - t0)
    phase("kitti", **stats)
    if len(times) != accepted or accepted == 0:
        raise AssertionError(f"kitti: {len(times)} TUM lines for {accepted} records")
    if not ate < FIXTURE_ATE_M:
        raise AssertionError(f"kitti: ATE {ate} m >= {FIXTURE_ATE_M} m")
    if abs(ate_oxts - ate) >= OXTS_ATE_TOL_M:
        raise AssertionError(f"kitti: ATE against OXTS {ate_oxts} m, against the fixture {ate} m")
    return stats


def bag_phase():
    """A VLP-16 ROS1 bag with the XALOC profile through the `run` command."""
    from limovelo_tpu_torch.__main__ import main as cli
    from limovelo_tpu_torch.io.fixtures import write_rosbag
    from limovelo_tpu_torch.io.simulate import circle_trajectory, room_world, simulate
    from limovelo_tpu_torch.runtime.evaluate import ate_rmse

    t0 = time.perf_counter()
    cfg = smoke_profiles()["smoke_xaloc"]
    sim = simulate(room_world(size=24, n_boxes=10),
                   circle_trajectory(radius=4, omega=0.5, ramp=1.0, hold=0.5), cfg,
                   imu_rate=cfg.imu_rate, **BAG_SIM)
    bag = SMOKE_DIR / "xaloc.bag"
    write_rosbag(str(bag), sim, cfg)
    sim_s = time.perf_counter() - t0
    out = SMOKE_DIR / "xaloc.tum"
    ts = time.perf_counter()
    with counted_windows() as cw:
        cli(["run", "--bag", str(bag), "--config", "smoke_xaloc", "--out", str(out),
             "--device", DEVICE])
    replay_s = time.perf_counter() - ts
    cw.check_every_window("bag")
    times, pos = read_tum(out)
    ate = ate_rmse(times, pos, sim.gt_t, sim.gt_R, sim.gt_p)[0]
    late = times[times >= times[0] + BAG_WARMUP_S]
    rate = (len(late) - 1) / (late[-1] - late[0]) if len(late) > 1 else 0.0
    stats = dict(**window_stats(cw.windows, cw.launches), records=len(times), ate_m=ate,
                 update_hz_after_warmup=rate, bag_bytes=bag.stat().st_size, sim_s=sim_s,
                 replay_s=replay_s, seconds=time.perf_counter() - t0)
    phase("bag", **stats)
    if not rate > BAG_MIN_RATE_HZ:
        raise AssertionError(f"bag: {rate} Hz of updates after the warm-up")
    if not ate < FIXTURE_ATE_M:
        raise AssertionError(f"bag: ATE {ate} m >= {FIXTURE_ATE_M} m")
    return stats


def publish_phase(sim, res_main, main_stats):
    """The main stream with every publisher sink attached."""
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline
    from limovelo_tpu_torch.runtime.publishers import Publisher

    t0 = time.perf_counter()
    metrics, traj = SMOKE_DIR / "publish.jsonl", SMOKE_DIR / "publish.tum"
    pub = Publisher(str(metrics), str(traj))
    log = {k: [] for k in ("state", "tf", "cloud", "full_cloud", "planes", "states",
                           "extrinsics")}
    pipe = LioPipeline(main_config().replace(print_extrinsics=True), device=DEVICE,
                       publisher=pub)
    short_states = []

    def on_states(pkt):
        log["states"].append(len(pkt.times))
        if len(pkt.times) != len(pipe._anchors):
            short_states.append((pkt.t, len(pkt.times), len(pipe._anchors)))

    pub.on_state.append(log["state"].append)
    pub.on_tf.append(log["tf"].append)
    pub.on_cloud.append(lambda pts, t, intensity: log["cloud"].append((len(pts), intensity)))
    pub.on_full_cloud.append(lambda pts, t, intensity:
                             log["full_cloud"].append((len(pts), intensity)))
    pub.on_planes.append(log["planes"].append)
    pub.on_states.append(on_states)
    pub.on_extrinsics.append(log["extrinsics"].append)
    windows, launches = drive(pipe, whole(sim))
    pub.close()
    res, ate = checked_result(pipe, windows, sim)
    same_times = np.array_equal(res.times, res_main.times)
    d = (np.linalg.norm(res.positions - res_main.positions, axis=1) if same_times
         else np.array([np.inf]))
    all_in = np.round(np.concatenate([s.intensity for s in sim.scans]), 5)
    genuine = {k: float(np.isin(np.round(np.concatenate([c[1] for c in log[k]]), 5),
                                all_in).mean()) for k in ("cloud", "full_cloud")}
    bad_planes = [i for i, (rec, pk) in enumerate(zip(res.records, log["planes"]))
                  if len(pk.normals) != rec.num_matches
                  or not np.allclose(np.linalg.norm(pk.normals, axis=-1), 1.0, atol=1e-4)]
    n_jsonl = len(metrics.read_text().splitlines())
    n_tum = len(traj.read_text().splitlines())
    stats = dict(**window_stats(windows, launches), records=len(res.records), ate_m=ate,
                 same_record_times=same_times, max_pos_diff_m=float(d.max()),
                 packets={k: len(v) for k, v in log.items()}, jsonl_rows=n_jsonl, tum_lines=n_tum,
                 mean_cloud_points=float(np.mean([c[0] for c in log["cloud"]])),
                 mean_full_cloud_points=float(np.mean([c[0] for c in log["full_cloud"]])),
                 genuine_intensity=genuine, main_step_p50_ms=main_stats["step_p50_ms"],
                 main_step_p95_ms=main_stats["step_p95_ms"], seconds=time.perf_counter() - t0)
    phase("publish", **stats)
    if not same_times or d.max() >= RESUME_TOL_M:
        raise AssertionError(f"publish: records differ from the main run's by {d.max()} m")
    n = len(res.records)
    if n_jsonl != n or n_tum != n or any(len(v) != n for v in log.values()):
        raise AssertionError(f"publish: {n} records, {n_jsonl} JSONL rows, {n_tum} TUM lines, "
                             f"packets {stats['packets']}")
    if bad_planes:
        raise AssertionError(f"publish: planes packets of records {bad_planes[:5]} are not one "
                             "unit normal per match")
    if short_states:
        raise AssertionError(f"publish: states packets not the anchor history: {short_states[:3]}")
    if min(genuine.values()) <= GENUINE_SHARE:
        raise AssertionError(f"publish: published intensities are not the input's: {genuine}")
    return stats


def eval_rows_md(path: Path) -> dict:
    """EVAL.md's table: scenario → (ATE, updates, update rate)."""
    rows = {}
    for ln in path.read_text().splitlines() if path.is_file() else []:
        cells = [c.strip() for c in ln.strip().strip("|").split("|")]
        if ln.startswith("| ") and len(cells) >= 4 and cells[0] != "scenario":
            try:
                rows[cells[0]] = (float(cells[1]), int(cells[2]), float(cells[3]))
            except ValueError:
                continue
    return rows


def eval_phase():
    """The accuracy battery on the card through the `eval` command."""
    from limovelo_tpu_torch.__main__ import main as cli

    t0 = time.perf_counter()
    out = SMOKE_DIR / "EVAL.md"
    with counted_windows() as cw:
        rows = cli(["eval", "--fast", "--out", str(out), "--device", DEVICE])
    ref = eval_rows_md(ROOT / "EVAL.md")
    table = [dict(scenario=r.scenario, ate_m=r.ate_m, updates=r.updates, update_hz=r.update_hz,
                  wall_s=r.wall_s, eval_md=ref.get(r.scenario)) for r in rows]
    stats = dict(**window_stats(cw.windows, cw.launches), rows=table,
                 seconds=time.perf_counter() - t0)
    phase("eval", **stats)
    bad = [r.scenario for r in rows
           if not (r.updates > 0 and np.isfinite(r.ate_m) and r.ate_m < EVAL_ATE_M)]
    if len(rows) != 9 or bad:
        raise AssertionError(f"eval: {len(rows)} rows; failed: {bad}")
    return stats


def profile_phase(sim, n_windows: int = 20):
    """torch.profiler over `n_windows` main-path windows after a warm-up:
    device busy time against wall time, and the ops by host and device
    time."""
    from torch.profiler import ProfilerActivity, profile

    from limovelo_tpu_torch.io.simulate import replay_into
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    pipe = LioPipeline(main_config(), device="cuda")
    step = pipe.step_window
    state = {"n": 0, "prof": None, "wall": 0.0}

    def profiled(t1, t2):
        state["n"] += 1
        if state["n"] == 30:                       # past the 10 and 20 Hz warm-up windows
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].__enter__()
            state["t0"] = time.perf_counter()
        rec = step(t1, t2)
        if state["n"] == 30 + n_windows - 1:
            torch.cuda.synchronize()
            state["wall"] = time.perf_counter() - state["t0"]
            state["prof"].__exit__(None, None, None)
        return rec

    pipe.step_window = profiled
    replay_into(pipe, sim)
    prof = state["prof"]
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events)
    top = lambda key: [(e.key, getattr(e, key) / n_windows / 1e3, e.count // n_windows)
                       for e in sorted(events, key=lambda e: -getattr(e, key))[:15]]
    phase("profile", windows=n_windows, wall_ms_per_window=state["wall"] / n_windows * 1e3,
          device_busy_ms_per_window=device_us / n_windows / 1e3,
          device_idle_share=1.0 - device_us / 1e6 / state["wall"],
          top_host_ms_per_window=top("self_cpu_time_total"),
          top_device_ms_per_window=top("self_device_time_total"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script drives the port on an NVIDIA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "limovelo_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the limovelo_tpu_torch package is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    phase("env", device=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)

    from limovelo_tpu_torch.ops.cuda import build

    t = time.perf_counter()
    build.build(["knn_grouped"])
    phase("build", seconds=time.perf_counter() - t,
          ptxas=[ln.strip() for ln in build.build_logs.get("knn_grouped", "").splitlines()
                 if "Used" in ln or "spill" in ln])

    if "--profile" in sys.argv[1:]:
        profile_phase(make_sim()[1])
        return 0

    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    world, sim = make_sim()
    render_s = {"main": time.perf_counter() - t}
    phase("sim", scans=len(sim.scans), returns_per_scan=float(np.mean([len(s.pts) for s in sim.scans])),
          imu_samples=len(sim.imu_t), seconds=render_s["main"])

    cases, max_err = kernel_phase(*kernel_views(world, sim))
    phase("kernel", kernel="knn_grouped", max_abs_d2_err=max_err, cases=cases)

    phase_launches = {}
    main_pipe, res, stats = main_phase(sim)
    phase_launches["main"] = stats["kernel_launches"]
    cpu_phase(sim, res, main_config())
    phase_launches["offline"] = offline_phase(sim, stats["ate_m"])["kernel_launches"]
    phase_launches["hd_map"] = hd_map_phase(sim, main_pipe)["kernel_launches"]
    del main_pipe
    phase_launches["checkpoint"] = checkpoint_phase(sim, res)["kernel_launches"]
    prune_stats = prune_phase()
    phase_launches["prune"] = (prune_stats["kernel_launches"]
                               + prune_stats["unpruned"]["kernel_launches"])
    slam_stats, slam_graph = slam_phase()
    phase_launches["slam"] = slam_stats["kernel_launches"]
    phase_launches["shard"] = shard_phases(sim, res, stats, slam_graph)
    cli_devices_phase()
    render_s.update(prune=prune_stats["sim_s"], slam=slam_stats["sim_s"])
    for name, run in (("kitti", kitti_phase), ("bag", bag_phase)):
        st = run()
        phase_launches[name] = st["kernel_launches"]
        render_s[name] = st["sim_s"]
    phase_launches["publish"] = publish_phase(sim, res, stats)["kernel_launches"]
    phase_launches["eval"] = eval_phase()["kernel_launches"]
    phase("render", seconds=render_s, main_prune_slam_s=sum(
        render_s[k] for k in ("main", "prune", "slam")), launches_by_phase=phase_launches)

    main_case = next(c for c in cases if c["n"] == 8192 and c["rings"] == 1)
    emit({"kernels": [{
        "name": "knn_grouped",
        "route": "cuda",
        "source": "limovelo_tpu_torch/csrc/knn_grouped.cu",
        "replaces": "limovelo_tpu/ops/pallas/knn.py:184",
        "launches": int(sum(phase_launches.values())),
        "max_abs_err": max_err,
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
    }]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

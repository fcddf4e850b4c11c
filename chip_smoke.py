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
           size): the function's outputs, and the kernel's raw outputs held
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

Every phase on the card counts its own kernel launches (set to 0 just
before it, read just after) and fails if a window launched none; the
kernels line sums them.  Then the kernels line, nvidia-smi's line and, last,
{"ok": true, "device": {...}}.  Any failed check raises: the script then
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
MIN_MATCH_FRAC = 0.15
D2_ATOL = 1e-5
K = 5
SPIN_CYCLES = 10_000_000     # ~5 ms at the H100's 1.98 GHz boost clock
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
    1-ring envelope and the tiered rings=3 NB=32 one."""
    leaf = main_config().downsample_prec
    for n in (8192, 16384, 32768):
        q_np, n_ds = main_path_queries(scan_w, sensor, n, leaf)
        q = torch.as_tensor(q_np, device=dev)
        for rings, mb in ((1, None), (3, 32)):
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
    q = next(kernel_shapes(scan_w, sensor, dev))[2]
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


def drive(pipe, feed):
    """Run `feed(pipe)` with every kernel's launch count set to 0 just
    before and read just after; returns (per window: launches, accepted,
    seconds; the launches).  On the card, every window must have launched
    the grouped kernel."""
    from limovelo_tpu_torch.ops.cuda import knn

    windows = []
    step = pipe.step_window

    def counted(t1, t2):
        before, t0 = knn.knn_grouped.launches, time.perf_counter()
        rec = step(t1, t2)            # ends in the telemetry read: synchronous
        windows.append((knn.knn_grouped.launches - before, rec is not None,
                        time.perf_counter() - t0))
        return rec

    pipe.step_window = counted
    knn.knn_grouped.launches = 0
    feed(pipe)
    launches = knn.knn_grouped.launches
    per_win = np.array([w[0] for w in windows])
    if pipe.device.type == "cuda" and (not windows or not np.all(per_win >= 1)):
        raise AssertionError(f"windows without a kernel launch: {int((per_win < 1).sum())}"
                             f"/{len(windows)}")
    return windows, launches


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

    world, sim = make_sim()
    phase("sim", scans=len(sim.scans), returns_per_scan=float(np.mean([len(s.pts) for s in sim.scans])),
          imu_samples=len(sim.imu_t))

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
    phase_launches["slam"] = slam_phase()["kernel_launches"]

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

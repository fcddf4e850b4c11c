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

then the kernels line, nvidia-smi's line and, last,
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
POS_TOL_M = 0.005
MIN_MATCH_FRAC = 0.15
D2_ATOL = 1e-5
K = 5
SPIN_CYCLES = 10_000_000     # ~5 ms at the H100's 1.98 GHz boost clock

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


def replay(sim, device, count_windows: bool):
    """Replay `sim` through the port's LioPipeline on `device`; returns the
    pipeline and, per window, (kernel launches, accepted, seconds)."""
    from limovelo_tpu_torch.io.simulate import replay_into
    from limovelo_tpu_torch.ops.cuda import knn
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline

    pipe = LioPipeline(main_config(), device=device)
    windows = []
    step = pipe.step_window

    def counted(t1, t2):
        before, t0 = knn.knn_grouped.launches, time.perf_counter()
        rec = step(t1, t2)            # ends in the telemetry read: synchronous
        windows.append((knn.knn_grouped.launches - before, rec is not None,
                        time.perf_counter() - t0))
        return rec

    if count_windows:
        pipe.step_window = counted
    replay_into(pipe, sim)
    return pipe, windows


def truncate(sim, t_end: float):
    """The stream's first `t_end` seconds of scans, with the IMU samples
    that let the pipeline process every window ending by then."""
    from limovelo_tpu_torch.io.simulate import SimData

    t0 = sim.imu_t[0]
    keep = sim.imu_t <= t0 + t_end + 0.1 + 1e-9
    return SimData(scans=[s for s in sim.scans if s.stamp < t0 + t_end - 1e-9],
                   imu_t=sim.imu_t[keep], imu_a=sim.imu_a[keep], imu_w=sim.imu_w[keep],
                   gt_t=sim.gt_t, gt_R=sim.gt_R, gt_p=sim.gt_p)


def main_phase(sim, device="cuda"):
    from limovelo_tpu_torch.ops.cuda import knn
    from limovelo_tpu_torch.runtime.evaluate import ate_rmse

    knn.knn_grouped.launches = 0          # every kernel's count, just before the main path
    t0 = time.perf_counter()
    pipe, windows = replay(sim, device, count_windows=True)
    res = pipe.result
    wall = time.perf_counter() - t0
    launches = knn.knn_grouped.launches   # read just after

    n_win = len(windows)
    per_win = np.array([w[0] for w in windows])
    step_s = np.array([w[2] for w in windows])
    on_card = torch.device(device).type == "cuda"
    if on_card and (n_win == 0 or not np.all(per_win >= 1)):
        raise AssertionError(f"windows without a kernel launch: {int((per_win < 1).sum())}/{n_win}")
    accepted = sum(w[1] for w in windows)
    if (on_card and launches < accepted) or accepted != len(res.records) or not res.records:
        raise AssertionError(f"launches {launches}, accepted {accepted}, records {len(res.records)}")
    pos = res.positions
    if not np.all(np.isfinite(pos)) or not np.all(np.isfinite(res.rotations)):
        raise AssertionError("non-finite pose")
    ds = np.array([r.ds_count for r in res.records], float)
    nm = np.array([r.num_matches for r in res.records], float)
    match_frac = float(nm[1:].sum() / ds[1:].sum())
    ate, _ = ate_rmse(res.times, pos, sim.gt_t, sim.gt_R, sim.gt_p)
    stats = dict(
        windows=n_win, records=len(res.records), kernel_launches=int(launches),
        launches_per_window=float(per_win.mean()), ate_m=ate,
        mean_ds_count=float(ds.mean()), mean_matches=float(nm.mean()), match_frac=match_frac,
        step_p50_ms=float(np.percentile(step_s, 50) * 1e3),
        step_p95_ms=float(np.percentile(step_s, 95) * 1e3),
        windows_per_s=float(n_win / step_s.sum()), replay_wall_s=wall,
        collapsed_windows=pipe.collapsed_windows,
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
    return res, stats


def cpu_phase(sim, res_card):
    t0 = time.perf_counter()
    pipe, _ = replay(truncate(sim, CPU_REPLAY_S), "cpu", count_windows=False)
    cpu = pipe.result
    n = len(cpu.records)
    if n < 3 or not np.array_equal(cpu.times, res_card.times[:n]):
        raise AssertionError(f"CPU records {cpu.times} are not the card's first {n}: "
                             f"{res_card.times[:n]}")
    d = np.linalg.norm(cpu.positions - res_card.positions[:n], axis=1)
    phase("cpu", records=n, max_pos_diff_m=float(d.max()), seconds=time.perf_counter() - t0)
    if d.max() >= POS_TOL_M:
        raise AssertionError(f"card vs CPU positions differ by {d.max()} m")


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

    res, stats = main_phase(sim)
    cpu_phase(sim, res)

    main_case = next(c for c in cases if c["n"] == 8192 and c["rings"] == 1)
    emit({"kernels": [{
        "name": "knn_grouped",
        "route": "cuda",
        "source": "limovelo_tpu_torch/csrc/knn_grouped.cu",
        "replaces": "limovelo_tpu/ops/pallas/knn.py:184",
        "launches": stats["kernel_launches"],
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

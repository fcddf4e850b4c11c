"""The port's CUDA kernels on the card, each against its plain PyTorch version.

A CUDA kernel has no CPU mode, so these tests carry the `cuda` marker and
skip where there is no card.  This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from limovelo_tpu_torch.mapping import hashgrid as hg
from limovelo_tpu_torch.ops.cuda import knn as gk

from knn_cases import adversarial_groups

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _scan_map(rng, params, device, n=20000, center=(150.0, 80.0, 5.0)):
    """Scan-like world (ground disc + walls) far from the origin."""
    ang = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(2, 25, n)
    pts = np.stack([center[0] + r * np.cos(ang), center[1] + r * np.sin(ang),
                    center[2] + np.where(rng.random(n) < 0.3, rng.uniform(0, 3, n),
                                         rng.normal(0, 0.05, n))], -1).astype(np.float32)
    m = hg.insert(hg.make_map(params, device=device), torch.as_tensor(pts, device=device),
                  torch.ones(n, dtype=torch.bool, device=device), params)
    return m, pts


@pytest.mark.cuda
def test_knn_grouped_kernel_matches_plain(cuda_device):
    """Equal valid masks, d² within 1e-5 on valid entries and equal
    neighbour coordinates, at rings=1 and tiered (rings=3, 32 buckets), with
    and without group overflow, and on an empty map.  Both sides compute
    the same recentred (q − p)² rounded after every operation, so they
    normally agree exactly; 1e-5 is the stated bound.  The raw per-group
    outputs also meet the output contract (`gk.check_topk_contract`)."""
    rng = np.random.default_rng(0)
    params = hg.GridParams(table_size=1 << 14)
    m, world = _scan_map(rng, params, cuda_device)
    q = torch.as_tensor((world[rng.choice(len(world), 4096, replace=False)]
                         + rng.normal(0, 0.05, (4096, 3))).astype(np.float32), device=cuda_device)
    empty = hg.make_map(params, device=cuda_device)
    for mm, g_max, rings, mb in ((m, 1024, 1, None), (m, 1024, 3, 32), (m, 16, 1, None),
                                 (empty, 1024, 1, None)):
        before = gk.knn_grouped.launches
        got = gk.knn_grouped(mm, q, params, k=5, g_max=g_max, rings=rings, max_buckets=mb)
        torch.cuda.synchronize()
        assert gk.knn_grouped.launches == before + 1
        want = gk.knn_grouped_plain(mm, q, params, k=5, g_max=g_max, rings=rings, max_buckets=mb)
        assert torch.equal(got[2], want[2])
        v = want[2]
        assert torch.allclose(got[1][v], want[1][v], rtol=0, atol=1e-5)
        assert torch.equal(got[0][v], want[0][v])
        assert bool(torch.isinf(got[1][~v]).all())
        assert bool(v.any()) == (mm is m)
        grp = gk.group_queries(mm, q, params, g_max, rings=rings, max_buckets=mb)
        raw = (grp.bucket_ids, grp.order_q, grp.centers, mm.pts, 5)
        gk.check_topk_contract(grp.order_q, grp.bucket_ids, params.slots,
                               gk.group_topk(*raw), gk.group_topk_plain(*raw))


@pytest.mark.cuda
@pytest.mark.parametrize("k,nb,unaligned", [
    (1, 27, False), (5, 27, False), (8, 32, False), (5, 32, False), (8, 27, False),
    (5, 27, True), (1, 32, True)])
def test_knn_grouped_kernel_contract_adversarial(cuda_device, k, nb, unaligned):
    """The raw outputs on groups built to break a kernel (tests/knn_cases.py:
    a full group and a one-query group, an all-absent group and one past the
    last, mirrored and duplicated map points that tie exactly, 5-33 real
    queries, non-prefix slots, a bucket with two points, 64 padding rows)
    meet the output contract against the plain version: bit-identical d and
    idx below 1e16, and every entry written (outputs start as NaN and -7).
    The groups' real-query counts take the lanes rule through 32, 16, 8 and
    4 lanes per query.  At k = 1, 5 and 8, NB = 27 and 32, and with a map
    table 4 bytes off 16-byte alignment (the 4-byte copy path)."""
    bids, oq, ctr, pts = (torch.as_tensor(a, device=cuda_device)
                          for a in adversarial_groups(11, nb))
    if unaligned:
        flat = torch.empty(pts.numel() + 1, device=cuda_device)
        flat[1:] = pts.reshape(-1)
        pts = flat[1:].view(pts.shape)
        assert pts.data_ptr() % 16 != 0 and pts.is_contiguous()
    G = bids.shape[0]
    out = (torch.full((G, gk.GROUP_CAP, k), float("nan"), device=cuda_device),
           torch.full((G, gk.GROUP_CAP, k), -7, dtype=torch.int32, device=cuda_device))
    before = gk.knn_grouped.launches
    got = gk._launch(bids, oq, ctr, pts, k, out=out)
    torch.cuda.synchronize()
    assert gk.knn_grouped.launches == before + 1
    want = gk.group_topk_plain(bids, oq, ctr, pts, k)
    assert gk.check_topk_contract(oq, bids, pts.shape[1], got, want) > 0


def _to(obj, device):
    """A copy of a NamedTuple of tensors (nested) on `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device, copy=True)
    return type(obj)(*(_to(v, device) for v in obj))


@pytest.mark.cuda
def test_prune_on_card_matches_cpu(cuda_device):
    """`hashgrid.prune` of one seeded map on the card and on the CPU:
    bit-equal map fields, and it drops buckets."""
    rng = np.random.default_rng(1)
    params = hg.GridParams(table_size=1 << 14)
    m_cpu, _ = _scan_map(rng, params, "cpu")
    m_card = _to(m_cpu, cuda_device)
    center = torch.tensor([150.0, 80.0, 5.0])
    got = hg.prune(m_card, center.to(cuda_device), 12.0, params)
    want = hg.prune(m_cpu, center, 12.0, params)
    for f in want._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert 0 < int(want.num_buckets) < int(_scan_map(rng, params, "cpu")[0].num_buckets)


def _cells(m):
    """The map's content as {(coarse key, slot): point}."""
    keys, pts, d2 = (t.cpu().numpy() for t in (m.keys, m.pts, m.cell_d2))
    b, j = np.nonzero(np.isfinite(d2))
    return {(*keys[i].tolist(), int(k)): pts[i, k] for i, k in zip(b, j)}


@pytest.mark.cuda
def test_mapping_step_on_card_matches_cpu(cuda_device):
    """`step.mapping_step` (re-deskew one rotation, downsample, insert) on
    one seeded input, on the card and on the CPU.  The card rounds the
    deskew's products in another order (1e-6 relative at 10 m), so a point
    within that of a 0.2 m voxel face may go to the neighbouring cell: the
    global clouds agree to 5e-5, and the maps hold the same (key, slot)
    cells, but for at most one cell in or out per such boundary point, and
    the counters differ by at most as many; the points of common cells
    agree to 5e-5.  The points sit on a jittered grid coarser than the
    voxel leaf, so no medoid is a near-tie between two points.  The mapping
    step runs no search: the grouped kernel's count stays."""
    from limovelo_tpu_torch import DEFAULT
    from limovelo_tpu_torch.config import DynParams
    from limovelo_tpu_torch.filter.process import ImuWindow
    from limovelo_tpu_torch.geometry import state as st
    from limovelo_tpu_torch.step import mapping_step

    rng = np.random.default_rng(2)
    cfg = DEFAULT.replace(downsample_prec=0.3)
    params = hg.GridParams(table_size=1 << 14)
    n_imu, n_pts = 24, 4096
    t = ((np.arange(n_imu) + 1) * 0.1 / n_imu).astype(np.float32)
    a = (rng.normal(size=(n_imu, 3)) * 0.1 - np.array(cfg.gravity_vec)).astype(np.float32)
    w = (rng.normal(size=(n_imu, 3)) * 0.05).astype(np.float32)
    # a jittered 0.6 m grid: no 0.3 m voxel holds two points, so no medoid
    # is a near-tie
    grid = np.stack(np.meshgrid(*[np.arange(16) * 0.6 - 4.5] * 3, indexing="ij"), -1)
    pts = (grid.reshape(-1, 3) + rng.uniform(-0.1, 0.1, (n_pts, 3))).astype(np.float32)
    pts_t = rng.uniform(0, 0.1, n_pts).astype(np.float32)

    def run(dev):
        T = lambda v: torch.as_tensor(v).to(dev)
        x = st.make_initial(cfg, device=dev)
        x_t2 = x._replace(p=T(np.float32([0.3, -0.1, 0.02])))
        m = hg.make_map(params, device=dev)
        imus = ImuWindow(T(t), T(a), T(w), torch.ones(n_imu, dtype=torch.bool, device=dev))
        return mapping_step(m, x, T(np.float32(0.0)), T(a[0]), T(w[0]), imus, x_t2,
                            T(np.float32(0.1)), T(pts), T(pts_t),
                            torch.ones(n_pts, dtype=torch.bool, device=dev),
                            DynParams.from_config(cfg), params)

    before = gk.knn_grouped.launches
    got, want = run(cuda_device), run("cpu")
    assert gk.knn_grouped.launches == before
    assert torch.allclose(got[1].cpu(), want[1], rtol=0, atol=5e-5)
    g = want[3][want[4]].numpy() / params.voxel_size
    near = int(np.sum(np.any(np.abs(g - np.round(g)) < 5e-4, axis=-1)))
    assert near < 0.01 * len(g)
    cg, cw = _cells(got[0]), _cells(want[0])
    assert len(set(cg) ^ set(cw)) <= 2 * near
    common = set(cg) & set(cw)
    assert len(common) > 1000
    for c in common:
        np.testing.assert_allclose(cg[c], cw[c], rtol=0, atol=5e-5)
    for f in ("num_points", "num_buckets", "dropped"):
        assert abs(int(getattr(got[0], f)) - int(getattr(want[0], f))) <= near, f
    assert int(want[0].num_points) > 1000


def _room_config(**kw):
    from limovelo_tpu_torch.config import DEFAULT

    return DEFAULT.replace(knn_rings=1, knn_backend="grouped", map_table_size=1 << 12,
                           min_dist=0.5, downsample_prec=0.3, imu_rate=200.0,
                           real_time_delay=0.1, degeneracy_threshold=0.0, **kw)


@pytest.mark.cuda
def test_publisher_on_card_matches_cpu(cuda_device):
    """One short replay with every sink attached, on the card and on the
    CPU: the same packets (counts and times), positions within 5 mm, one
    plane per match, the state history as long as the anchor history, and
    published intensities that are input intensities.  The card's run
    launches the grouped kernel at least once per record; the CPU's runs its
    plain version."""
    from limovelo_tpu_torch.io.simulate import circle_trajectory, replay_into, room_world, simulate
    from limovelo_tpu_torch.runtime.pipeline import LioPipeline
    from limovelo_tpu_torch.runtime.publishers import Publisher

    # "rematch" re-searches every iteration: with "auto" the neighbour sets
    # frozen at the predicted pose carry one point of the card's and the
    # CPU's rounding on to later windows, and on this narrow scene the runs
    # drifted 8.9 mm apart in one second (the main phase's wide stream
    # agrees to 0.79 mm under "auto")
    cfg = _room_config(print_extrinsics=True, match_mode="rematch")
    sim = simulate(room_world(size=12, n_boxes=10), circle_trajectory(radius=2.5, omega=0.5), cfg,
                   duration=1.0, lidar_lines=8, pts_per_line=160, imu_rate=200.0, seed=3)
    runs = {}
    for dev in (cuda_device, "cpu"):
        pub = Publisher()
        log = {k: [] for k in ("state", "cloud", "full_cloud", "planes", "states", "extrinsics")}
        pub.on_state.append(log["state"].append)
        pub.on_cloud.append(lambda pts, t, intensity, log=log: log["cloud"].append((t, intensity)))
        pub.on_full_cloud.append(lambda pts, t, intensity, log=log:
                                 log["full_cloud"].append((t, intensity)))
        pub.on_planes.append(log["planes"].append)
        pub.on_states.append(log["states"].append)
        pub.on_extrinsics.append(log["extrinsics"].append)
        pipe = LioPipeline(cfg, device=dev, publisher=pub)
        before = gk.knn_grouped.launches
        replay_into(pipe, sim)
        runs[str(dev)] = (pipe, log, gk.knn_grouped.launches - before)
    (card, clog, launches), (cpu, plog, cpu_launches) = runs["cuda"], runs["cpu"]
    assert cpu_launches == 0 and launches >= len(card.result.records) >= 6
    np.testing.assert_array_equal(card.result.times, cpu.result.times)
    assert np.linalg.norm(card.result.positions - cpu.result.positions, axis=1).max() < 0.005
    all_in = np.round(np.concatenate([s.intensity for s in sim.scans]), 5)
    for k in clog:
        assert len(clog[k]) == len(plog[k]) == len(card.result.records), k
    for rec, planes in zip(card.result.records, clog["planes"]):
        assert len(planes.normals) == rec.num_matches
        np.testing.assert_allclose(np.linalg.norm(planes.normals, axis=-1), 1.0, atol=1e-4)
    assert len(clog["states"][-1].times) == len(card._anchors)
    for k in ("cloud", "full_cloud"):
        assert [t for t, _ in clog[k]] == [t for t, _ in plog[k]]
        inten = np.concatenate([i for _, i in clog[k]])
        assert np.isin(np.round(inten, 5), all_in).mean() > 0.99, k


@pytest.mark.cuda
def test_cli_kitti_on_card_launches_the_kernel(cuda_device, tmp_path, monkeypatch):
    """`main(["kitti", ...])` on a tiny drive with `--device cuda`: the
    grouped kernel is launched at least once per record, and the trajectory
    is within 5 cm ATE of the drive's ground truth.  The configuration goes
    in as a profile name (the card machine has no PyYAML)."""
    from limovelo_tpu_torch.__main__ import main
    from limovelo_tpu_torch.config import KITTI, PROFILES
    from limovelo_tpu_torch.io.fixtures import write_kitti_drive
    from limovelo_tpu_torch.io.simulate import circle_trajectory, room_world
    from limovelo_tpu_torch.runtime.evaluate import ate_rmse

    cfg = KITTI.replace(knn_rings=1, knn_backend="grouped", min_dist=0.5, downsample_prec=0.3,
                        downsample_rate=1, imu_rate=200.0, real_time_delay=0.1,
                        empty_lidar_time=0.5, degeneracy_threshold=0.0,
                        covariance_acceleration=1e-2, covariance_gyroscope=1e-3,
                        map_table_size=1 << 12)
    monkeypatch.setitem(PROFILES, "card_test_kitti", cfg)
    drive = str(tmp_path / "2011_09_26_drive_9999_sync")
    sim = write_kitti_drive(drive, room_world(size=12, n_boxes=10),
                            circle_trajectory(radius=2.5, omega=0.5), cfg, duration=2.0,
                            lidar_lines=12, pts_per_line=200, seed=5)
    out = tmp_path / "card.tum"
    before = gk.knn_grouped.launches
    main(["kitti", "--drive", drive, "--config", "card_test_kitti", "--out", str(out),
          "--device", "cuda"])
    traj = np.loadtxt(out)
    assert gk.knn_grouped.launches - before >= len(traj) >= 12
    ate, _ = ate_rmse(traj[:, 0], traj[:, 1:4], sim.gt_t, sim.gt_R, sim.gt_p)
    assert ate < 0.05, ate


def _two_rooms(n: int, seed: int = 0) -> np.ndarray:
    """A window whose first and second halves lie in two rooms 0.8 m apart
    (a floor and a wall each): with two ranks no voxel spans the shards, so
    the per-shard voxel dedup is the single device's, and each half fills
    few enough coarse voxels that no query overflows the per-shard g_max."""
    rng = np.random.default_rng(seed)
    halves = []
    for sign in (-1.0, 1.0):
        m = n // 2
        x = sign * rng.uniform(0.4, 4.0, m)
        y = rng.uniform(-2.0, 2.0, m)
        z = np.full(m, -1.5)
        wall = rng.random(m) < 0.4
        y[wall], z[wall] = 2.0, rng.uniform(-1.5, 1.0, wall.sum())
        halves.append(np.stack([x, y, z], -1) + rng.normal(0, 0.01, (m, 3)))
    return np.concatenate(halves).astype(np.float32)


@pytest.mark.cuda
def test_point_sharded_step_on_card_matches_single(cuda_device, tmp_path):
    """Two ranks on the one card (gloo, collectives staged through the
    host) run two chained point-sharded steps with the grouped backend, the
    second against the map the first built: both ranks launch the grouped
    kernel in each step, hold the state on the card, and match the
    single-device card step (p to 1e-5) on a window whose shards share no
    voxel (`_two_rooms`)."""
    from limovelo_tpu_torch import DEFAULT
    from limovelo_tpu_torch.parallel import multihost as mh
    from limovelo_tpu_torch.step import lio_step

    from torch_parallel_ranks import example_inputs, run_cases

    cfg = DEFAULT.replace(real_time=False, min_dist=0.5, downsample_prec=0.3,
                          map_table_size=1 << 14, knn_rings=1, knn_backend="grouped")
    pts = _two_rooms(2048)
    runs = {"s": ("card_step", dict(cfg=cfg, n_pts=2048, n_imu=64, pts=pts))}
    ranks = [r["s"] for r in mh.spawn(run_cases, 2, args=(runs,), device="cuda",
                                      backend="gloo", workdir=str(tmp_path), timeout_s=300)]
    for r in ranks:
        assert "error" not in r, r.get("error")
        assert r["mesh"]["backend"] == "gloo" and r["mesh"]["host_staging"]
        assert all(n >= 1 for n in r["launches"]), r["launches"]
        assert all(s["device"].startswith("cuda") for s in r["steps"])
    grid = hg.GridParams.from_config(cfg)
    inp = example_inputs(cfg, 2048, 64, cuda_device, pts)
    m = hg.make_map(grid, device=cuda_device)
    for k in range(2):
        out = lio_step(inp, m, cfg.static(), grid)
        m = out.map
        for r in ranks:
            np.testing.assert_allclose(r["steps"][k]["p"], out.x.p.cpu().numpy(), atol=1e-5)
            assert r["steps"][k]["num_matches"] == int(out.diag.num_matches)
    assert ranks[0]["steps"][1]["num_matches"] > 0

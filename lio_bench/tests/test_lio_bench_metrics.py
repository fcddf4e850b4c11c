"""The metric arithmetic on synthetic inputs."""

import numpy as np
import pytest
import torch

from lio_bench import trace as tr
from lio_bench.cells import metric_reader
from lio_bench.drive import Context
from lio_bench.roofline import FAR, topk_bound

MS = 1_000_000   # ns


def _ctx(**kw):
    base = dict(setup_s=12.5, windows=40, window_s=8.0, step_s=[0.1] * 40,
                device_kind="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return Context(**base)


def test_rate_is_over_the_whole_window():
    assert metric_reader("windows_per_s")(_ctx()) == pytest.approx(5.0)
    assert metric_reader("windows_per_s")(_ctx(windows=0)) is None
    assert metric_reader("setup_s")(_ctx()) == 12.5


def test_p95_is_over_all_windows():
    steps = list(np.linspace(0.010, 0.109, 100))     # 10..109 ms
    got = metric_reader("step_p95_ms")(_ctx(step_s=steps))
    assert got == pytest.approx(np.percentile(np.array(steps) * 1e3, 95))
    assert got == pytest.approx(104.05)


def _trace():
    """Two windows: device work [0,2] [1,3] (overlapping) [6,7] ms, then
    [9,10]; the host thread's runtime calls around them, one of them a
    wait in [3.5,6.5] ms, and a profiler thread's call that is not the
    host's."""
    E = tr.Ev
    return [
        E("k1", "kernel", 0, 2 * MS, 0), E("k2", "kernel", 1 * MS, 3 * MS, 0),
        E("Memcpy DtoH", "memcpy", 6 * MS, 7 * MS, 0), E("k3", "kernel", 9 * MS, 10 * MS, 0),
        E("cudaLaunchKernel", "runtime", 0, 1000, 1), E("cudaLaunchKernel", "runtime", 5, 900, 1),
        E("cudaMemcpyAsync", "runtime", 3 * MS + MS // 2, 6 * MS + MS // 2, 1),
        E("cudaLaunchKernel", "runtime", 9 * MS, 9 * MS + 10, 1),
        E("cudaStreamSynchronize", "runtime", 9 * MS + 20, 10 * MS, 1),
        E("cudaEventQuery", "runtime", 7 * MS, 9 * MS, 2),
    ]


def test_idle_share_from_a_synthetic_trace():
    ev = _trace()
    assert tr.device_intervals(ev) == [(0, 3 * MS), (6 * MS, 7 * MS), (9 * MS, 10 * MS)]
    busy = tr.busy_seconds(ev)
    assert busy == pytest.approx(0.005)
    ctx = _ctx(events=ev, traced_windows=2, traced_s=0.010, busy_s=busy)
    assert metric_reader("device.idle_share")(ctx) == pytest.approx(50.0)
    assert metric_reader("step.launches_per_window")(ctx) == pytest.approx(1.5)
    assert metric_reader("step.syncs_per_window")(ctx) == pytest.approx(0.5)
    # the idle gaps [3,6] and [7,9] ms: the first inside the host's copy,
    # the second between its calls (the other thread's call is not the host's)
    gaps = dict((k, v) for k, v in tr.idle_by_host(ev))
    assert gaps == {"cudaMemcpyAsync": pytest.approx(0.003), "host": pytest.approx(0.002)}
    assert tr.top_device_ops(ev)[0] == ["k1", pytest.approx(0.002)]


def test_readers_return_nothing_without_a_trace():
    for name in ("device.idle_share", "step.launches_per_window", "step.syncs_per_window",
                 "runtime.host_ms", "knn_grouped.roofline_share"):
        assert metric_reader(name)(_ctx()) is None


def test_host_ms_per_window():
    ctx = _ctx(host_windows=4, host_stage_ms={"assemble": 8.0, "h2d": 4.0, "resolve_host": 2.0},
               host_harness_s=0.006)
    assert metric_reader("runtime.host_ms")(ctx) == pytest.approx((14.0 + 6.0) / 4)


def _groups():
    """G=2 groups, NB=3 neighbour buckets, S=64 slots, k=5: group 0 has 2
    real queries and buckets 7 and 9 present, group 1 has 1 real query and
    bucket 9 present (shared) and one more, 4."""
    bucket_ids = torch.tensor([[7, -1, 9], [9, 4, -1]], dtype=torch.int32)
    order_q = torch.full((2, 64, 3), FAR)
    order_q[0, :2] = 1.0
    order_q[1, :1] = 2.0
    return bucket_ids, order_q


def test_topk_bound_on_a_hand_counted_case():
    bucket_ids, order_q = _groups()
    peak = {"bytes_per_s": 1e9, "f32_flop_per_s": 1e12}
    ms, by = topk_bound(bucket_ids, order_q, 64, 5, peak)
    flops = 8 * (2 * 2 + 1 * 2) * 64                           # 3072
    nbytes = (2 * 3 * 4 + 2 * 64 * 3 * 4 + 2 * 3 * 4 + 3 * 64 * 3 * 4 + 2 * 64 * 5 * 8)
    assert nbytes == 9008
    assert by == "bytes"
    assert ms == pytest.approx(max(nbytes / 1e9, flops / 1e12) * 1e3)


def test_roofline_share_over_the_traced_launches():
    bucket_ids, order_q = _groups()
    calls = [(bucket_ids, order_q, 64, 5)] * 2
    ev = [tr.Ev("void knn_grouped_kernel<5>(Args)", "kernel", 0, 40_000, 0),
          tr.Ev("void knn_grouped_kernel<5>(Args)", "kernel", 100_000, 140_000, 0)]
    ctx = _ctx(events=ev, traced_windows=2, knn_calls=calls)
    bound = 9008 / 3.35e12 * 1e3
    got = metric_reader("knn_grouped.roofline_share")(ctx)
    assert got == pytest.approx(100.0 * 2 * bound / 0.080)
    assert metric_reader("knn_grouped.roofline_share")(_ctx(events=ev, knn_calls=calls,
                                                            device_kind="cpu")) is None

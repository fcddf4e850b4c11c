"""Raw inputs of the grouped KNN's per-group top-k (`group_topk`) with the
groups a kernel can get wrong, made with numpy from a seed.  Shared by
tests/test_torch_knn_grouped.py (CPU) and tests/test_torch_cuda.py (card);
imports neither JAX nor torch.

Each case is (bucket_ids (G, nb) int32, order_q (G, 64, 3) f32,
centers (G, 1, 3) f32, map_pts (T, 64, 3) f32), laid out as
`ops/cuda/knn.py::group_queries` lays them out.
"""

import numpy as np

FAR = np.float32(1.0e9)
CAP = 64        # query slots per group
S = 64          # slots per bucket
TABLE = 48

# a dyadic centre and tie query: every recentred coordinate and distance of
# the tie rows is exact in f32, so mirrored points tie exactly
CTR = np.array([100.5, -20.0, 3.25], np.float32)
Q_TIE = CTR + np.array([0.125, -0.25, 0.0625], np.float32)

# groups, in order (real query count in brackets)
GROUPS = ("full[64]", "one[1]", "all_absent[10]", "past_last[0]", "ties[3]",
          "buckets_no_query[0]", "five[5]", "nine[9]", "seventeen[17]",
          "thirty_three[33]", "non_prefix[4]", "sparse_bucket[1]", "padding[64]")


def _tie_rows(rng):
    """Rows 0-2: row 0 holds points Q_TIE + δ, with Q_TIE − δ in slot s+32
    of the same row (a tie inside one row) and in the same slot of row 1
    (across rows); row 2 is a copy of row 0 (every point tied with its
    twin)."""
    delta = rng.integers(-48, 49, (32, 3)).astype(np.float32) / 64.0
    rows = np.full((3, S, 3), FAR, np.float32)
    rows[0, :32] = Q_TIE + delta
    rows[0, 32:] = Q_TIE - delta
    rows[1, :32] = Q_TIE - delta
    rows[1, 32:] = Q_TIE + delta
    rows[2] = rows[0]
    return rows


def adversarial_groups(seed: int, nb: int):
    rng = np.random.default_rng(seed)
    pts = np.full((TABLE, S, 3), FAR, np.float32)
    pts[:3] = _tie_rows(rng)
    for t in range(3, TABLE - 1):
        occ = rng.random(S) < rng.uniform(0.1, 0.9)
        pts[t, occ] = CTR + rng.uniform(-1.2, 1.2, (int(occ.sum()), 3)).astype(np.float32)
    pts[TABLE - 1, [5, 40]] = CTR + np.float32(0.3)      # a bucket with two points

    G = len(GROUPS)
    bids = np.full((G, nb), -1, np.int32)
    order_q = np.full((G, CAP, 3), FAR, np.float32)
    centers = np.tile(CTR, (G, 1, 1))

    def generic_ids():
        ids = rng.choice(np.arange(3, TABLE - 1), nb, replace=False).astype(np.int32)
        ids[rng.random(nb) < 0.35] = -1
        ids[rng.integers(nb)] = rng.integers(3, TABLE - 1)   # at least one present
        return ids

    def near(n):
        return (CTR + rng.uniform(-1.0, 1.0, (n, 3))).astype(np.float32)

    for g, name in enumerate(GROUPS):
        n = int(name[name.index("[") + 1:-1])
        if name not in ("ties[3]", "padding[64]", "non_prefix[4]"):
            order_q[g, :n] = near(n)
        if name in ("all_absent[10]", "past_last[0]"):
            continue
        bids[g] = generic_ids()
        if name != "full[64]":      # generic centres, off the dyadic grid
            centers[g, 0] = CTR + rng.uniform(-0.4, 0.4, 3).astype(np.float32)
    g = GROUPS.index("ties[3]")
    bids[g] = -1
    bids[g, [0, nb // 2, nb - 1]] = [0, 1, 2]
    centers[g, 0] = CTR
    order_q[g, :3] = [Q_TIE, Q_TIE, Q_TIE + np.float32(1 / 64)]
    g = GROUPS.index("non_prefix[4]")
    order_q[g, [3, 17, 40, 63]] = near(4)
    g = GROUPS.index("sparse_bucket[1]")
    bids[g] = -1
    bids[g, nb // 2] = TABLE - 1
    g = GROUPS.index("padding[64]")     # 64 rows at one point, as padding rows
    order_q[g] = CTR + np.float32(0.05)
    return bids, order_q, centers, pts

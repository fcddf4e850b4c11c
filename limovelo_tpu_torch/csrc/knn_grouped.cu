// Grouped hash-grid KNN for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel `limovelo_tpu/ops/pallas/knn.py:184` (`_knn_kernel`,
// launched by the `pallas_call` at :276).  Queries that share a coarse voxel
// share its neighbourhood of NB hash-grid buckets (27 for the 1-ring envelope,
// 32 for the tiered one).  The host-side pre-pass
// (`ops/cuda/knn.py::group_queries`) packs them into groups of at most
// GROUP_CAP = 64 query slots and resolves each group's bucket ids; this kernel
// gives, for every slot of a group, the k smallest squared distances to the
// NB*64 slots of those buckets and the flat candidate index b*64 + slot of
// each (b: the bucket's position among the group's NB).
//
// Output contract (`ops/cuda/knn.py::check_topk_contract` checks it against
// the plain version `group_topk_plain`).  A *real* slot is one whose query x
// is not the FAR sentinel (slots fill from 0); a bucket is *present* when its
// id is >= 0.
//  - On every real slot, each entry that the plain version gives with
//    d < 1e16 is bit-identical in d and in idx; ties go to the lowest idx.
//  - Where the plain version gives d >= 1e16 (only FAR slots or absent
//    buckets are left), the kernel gives d >= 1e16 (+inf allowed) and some
//    idx in [0, NB*64).
//  - Every entry of the (G, 64, k) outputs is written, vacant slots and
//    groups without work included (d = +inf, idx = 0 there), so every idx
//    the caller may read is in range.
// The distance is (q - p)^2 on coordinates recentred on the group centre,
// rounded after every operation (__fsub_rn, __fmul_rn, __fadd_rn, no FMA
// contraction), in the plain version's order: that is what makes it
// bit-identical.
//
// What bounds it: the work the data needs is small.  On the main path
// (N = 8192 rows, g_max = 2048 groups, NB = 27) about 250 groups hold a
// present bucket, a 1-ring neighbourhood holds about ten present buckets,
// and the few hundred real queries sit one to a few per group.  The ~115
// groups of 64 identical padding rows (the sensor origin) have no present
// bucket in the 1-ring envelope; in the tiered one they do, and they are
// most of its work.  The least time is set by bytes: the outputs
// (G*64*k*8 bytes, 5.2 MB at k = 5), the query slots and the present buckets,
// a few microseconds at 3.35 TB/s.  The f32 work, 8 operations per
// (real query, present candidate) pair, is far below that.  So the design
// makes the work follow the data, not g_max:
//  1. Prologue and early exit.  Every warp reads the group's NB <= 32 bucket
//     ids and the 64 slots' x, and ballots give the present-bucket mask and
//     the real-slot mask (uniform over the CTA, no barrier).  A group with no
//     present bucket or no real slot writes its sentinel outputs with
//     coalesced stores and is done.
//  2. Only present buckets are staged.  Each bucket row is 64 x 3 x 4 = 768
//     contiguous bytes; present rows are copied into a compacted shared
//     array with 16-byte `cp.async` (4-byte copies when a row is not a
//     multiple of 16 bytes or the table is not 16-byte aligned), and a table
//     keeps each compacted row's original neighbour index b.  The vacant
//     slots' sentinels are stored while the copies are in flight.  The
//     coordinates are recentred in registers at use, with the same rounded
//     subtractions as before, so the bits do not change.
//  3. L lanes per real query, L = 32 (a warp per query) down to 4, the
//     largest power of two with L * (real queries) <= 256 threads: a group
//     with 1-8 real queries gets a warp per query, the 64-query padding
//     groups get 4 lanes per query, and every lane of the CTA has work
//     either way.  The L lanes of a query stride over the compacted
//     candidates in increasing index, each keeping a sorted top-k in
//     registers that it replaces on strict `<` (equal distances keep the
//     lower index).  Then k rounds of an xor-butterfly shuffle minimum over
//     the pair (d, idx), compared lexicographically, take the lanes' heads:
//     the k lexicographically smallest pairs, in order, which is exactly what
//     the plain version's k passes of first-minimum give.  Compacted indices
//     keep the original order, so ties resolve as before; the winner is
//     mapped back to b*64 + slot when it is stored.  The rule was chosen by
//     timing it against a fixed warp per query and a fixed thread per query
//     on the main path's data (PERF.md, Findings).  On an H100 80GB HBM3 at
//     700 W, N = 8192: rings=1 (2.3 real queries per group with work)
//     0.0093 ms for the rule and for a warp per query, 0.089 ms for a thread
//     per query; tiered (118 groups of 64 padding rows with work) 0.033 ms
//     for the rule, 0.055 ms for a warp per query, 0.163 ms for a thread per
//     query.  So the crossover sits where the lanes run out: a warp per query
//     up to 8 real queries, fewer lanes beyond (4 for a full group).
//  4. Tensor cores are not used.  The work the data needs is ~0.5 M pair
//     evaluations per window, microseconds on the CUDA cores.  The only f32
//     tensor-core path is TF32 (10 mantissa bits): it would break the bit
//     identity with the plain version and can reorder near-tie neighbours,
//     which changes the plane fits downstream.
//  5. Grid: one CTA of 256 threads per group, with the early exit.
//     Persistent CTAs (as many as are resident, a static stride over the
//     groups) were timed against it on the main path's data (PERF.md,
//     Findings): 0.0099 / 0.0151 / 0.0218 ms against 0.0093 / 0.0117 /
//     0.0186 ms for one CTA per group at N = 8192 / 16384 / 32768, rings=1
//     (same card).  One CTA per group is the launch: it measured faster, the
//     block scheduler already hands a free SM the next group, and a dynamic
//     work counter would need a zeroed word per launch (one more launch on
//     the main path).  Shared memory: NB*768 bytes of candidates + 512 bytes
//     of tables; 32-40 registers, no spills (ptxas, k = 1..8).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kGroupCap = 64;          // query slots per group
constexpr int kThreads = 256;          // threads per CTA (8 warps)
constexpr int kMaxNb = 32;             // neighbour buckets per group: one ballot
constexpr float kFar = 1.0e9f;         // vacant-slot / empty-slot sentinel
constexpr int kNoCand = 0x7fffffff;    // idx of an empty top-k entry

struct Args {
  const int32_t* bucket_ids;  // (G, nb) table bucket of each neighbour, -1 absent
  const float* order_q;       // (G, 64, 3) query of each slot, FAR x when vacant
  const float* centers;       // (G, 1, 3) group centre (recentring)
  const float* map_pts;       // (T, slots, 3) the map's points, FAR in empty slots
  float* sq_out;              // (G, 64, K)
  int32_t* idx_out;           // (G, 64, K)
  int nb, slots;
  bool vec16;                 // bucket rows may be copied 16 bytes at a time
};

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool lex_less(float d0, int i0, float d1, int i1) {
  return d0 < d1 || (d0 == d1 && i0 < i1);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_grouped_kernel(const Args a) {
  extern __shared__ __align__(16) float cand[];  // (present rows * slots, 3), raw
  __shared__ int s_bucket[kMaxNb];   // neighbour index b of each compacted row
  __shared__ int s_bid[kMaxNb];      // its table bucket
  __shared__ int s_slot[kGroupCap];  // slot of the j-th real query

  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = a.slots * 3;       // floats per bucket row

  // 1. prologue: every warp takes the same ballots, so the masks are uniform
  //    over the CTA
  const int bid = lane < a.nb ? a.bucket_ids[(size_t)g * a.nb + lane] : -1;
  const unsigned present = __ballot_sync(0xffffffffu, bid >= 0);
  const float* qg = a.order_q + (size_t)g * kGroupCap * 3;
  const unsigned real_lo = __ballot_sync(0xffffffffu, qg[lane * 3] != kFar);
  const unsigned real_hi = __ballot_sync(0xffffffffu, qg[(lane + 32) * 3] != kFar);
  const unsigned long long real = ((unsigned long long)real_hi << 32) | real_lo;
  float* sq_g = a.sq_out + (size_t)g * kGroupCap * K;
  int32_t* idx_g = a.idx_out + (size_t)g * kGroupCap * K;
  if (present == 0u || real == 0ull) {
    for (int e = tid; e < kGroupCap * K; e += kThreads) {
      sq_g[e] = CUDART_INF_F;
      idx_g[e] = 0;
    }
    return;
  }
  const int n_q = __popcll(real);
  const int n_p = __popc(present);
  const int n_cand = n_p * a.slots;

  // 2. compaction tables, then the present rows, asynchronously
  if (warp == 0 && bid >= 0) {
    const int r = __popc(present & ((1u << lane) - 1u));
    s_bucket[r] = lane;
    s_bid[r] = bid;
  }
  if (tid < kGroupCap && ((real >> tid) & 1ull)) {
    s_slot[__popcll(real & ((1ull << tid) - 1ull))] = tid;
  }
  __syncthreads();
  if (a.vec16) {
    const int chunks = row / 4;
    for (int e = tid; e < n_p * chunks; e += kThreads) {
      const int r = e / chunks, c = e - r * chunks;
      cp_async_16(cand + r * row + c * 4, a.map_pts + (size_t)s_bid[r] * row + c * 4);
    }
  } else {
    for (int e = tid; e < n_p * row; e += kThreads) {
      const int r = e / row;
      cp_async_4(cand + e, a.map_pts + (size_t)s_bid[r] * row + (e - r * row));
    }
  }
  for (int e = tid; e < kGroupCap * K; e += kThreads) {
    if (!((real >> (e / K)) & 1ull)) {
      sq_g[e] = CUDART_INF_F;
      idx_g[e] = 0;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. L lanes per real query
  int L = 32;
  while (L > 1 && L * n_q > kThreads) L >>= 1;
  const int seg = tid / L, sl = tid & (L - 1), per_pass = kThreads / L;
  const int warp_first = warp * 32 / L;  // a warp-uniform trip count keeps
                                         // every lane in the shuffles
  const float cx = a.centers[g * 3 + 0], cy = a.centers[g * 3 + 1],
              cz = a.centers[g * 3 + 2];
  for (int j0 = 0; warp_first + j0 < n_q; j0 += per_pass) {
    const int j = seg + j0;
    const bool active = j < n_q;
    const int slot = active ? s_slot[j] : 0;
    const float qx = __fsub_rn(qg[slot * 3 + 0], cx);
    const float qy = __fsub_rn(qg[slot * 3 + 1], cy);
    const float qz = __fsub_rn(qg[slot * 3 + 2], cz);

    float bd[K];
    int bi[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      bd[t] = CUDART_INF_F;
      bi[t] = kNoCand;
    }
    const int end = active ? n_cand : 0;
    for (int i = sl; i < end; i += L) {
      const float dx = __fsub_rn(qx, __fsub_rn(cand[3 * i + 0], cx));
      const float dy = __fsub_rn(qy, __fsub_rn(cand[3 * i + 1], cy));
      const float dz = __fsub_rn(qz, __fsub_rn(cand[3 * i + 2], cz));
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < bd[K - 1]) {
        // insert after every entry <= d: a lane meets its candidates in
        // increasing index, so equal distances stay in index order
#pragma unroll
        for (int t = K - 1; t >= 0; --t) {
          const bool above = (t > 0) && (d < bd[t > 0 ? t - 1 : 0]);
          if (above) {
            bd[t] = bd[t - 1];
            bi[t] = bi[t - 1];
          } else if (d < bd[t]) {
            bd[t] = d;
            bi[t] = i;
          }
        }
      }
    }

    // k rounds of a lexicographic (d, idx) minimum over the L lanes' heads
    float* sq_q = sq_g + slot * K;
    int32_t* idx_q = idx_g + slot * K;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      float md = bd[0];
      int mi = bi[0];
      for (int off = L >> 1; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, md, off);
        const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
        if (lex_less(od, oi, md, mi)) {
          md = od;
          mi = oi;
        }
      }
      if (bi[0] == mi) {  // the owner (candidate indices are unique) pops
#pragma unroll
        for (int t = 0; t < K - 1; ++t) {
          bd[t] = bd[t + 1];
          bi[t] = bi[t + 1];
        }
        bd[K - 1] = CUDART_INF_F;
        bi[K - 1] = kNoCand;
      }
      if (active && sl == 0) {
        sq_q[r] = md;
        idx_q[r] = mi < n_cand ? s_bucket[mi / a.slots] * a.slots + mi % a.slots : 0;
      }
    }
  }
}

template <int K>
cudaError_t launch(const Args& a, int g_max, cudaStream_t stream) {
  const size_t smem = (size_t)a.nb * a.slots * 3 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_grouped_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  knn_grouped_kernel<K><<<g_max, kThreads, smem, stream>>>(a);  // one CTA per group
  return cudaGetLastError();
}

}  // namespace

// Every pointer is device memory laid out as documented on `Args`; the
// Python wrapper checks shapes, dtypes and contiguity.  Returns a
// cudaError_t value (0 on success).
extern "C" int knn_grouped_launch(const void* bucket_ids, const void* order_q,
                                  const void* centers, const void* map_pts, void* sq_out,
                                  void* idx_out, int g_max, int nb, int k, int slots,
                                  void* stream) {
  if (g_max <= 0) return (int)cudaSuccess;
  if (nb < 1 || nb > kMaxNb || slots < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.bucket_ids = static_cast<const int32_t*>(bucket_ids);
  a.order_q = static_cast<const float*>(order_q);
  a.centers = static_cast<const float*>(centers);
  a.map_pts = static_cast<const float*>(map_pts);
  a.sq_out = static_cast<float*>(sq_out);
  a.idx_out = static_cast<int32_t*>(idx_out);
  a.nb = nb;
  a.slots = slots;
  a.vec16 = (slots * 3) % 4 == 0 && reinterpret_cast<uintptr_t>(map_pts) % 16 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return (int)launch<1>(a, g_max, st);
    case 2: return (int)launch<2>(a, g_max, st);
    case 3: return (int)launch<3>(a, g_max, st);
    case 4: return (int)launch<4>(a, g_max, st);
    case 5: return (int)launch<5>(a, g_max, st);
    case 6: return (int)launch<6>(a, g_max, st);
    case 7: return (int)launch<7>(a, g_max, st);
    case 8: return (int)launch<8>(a, g_max, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

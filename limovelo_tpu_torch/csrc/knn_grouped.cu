// Grouped hash-grid KNN for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel `limovelo_tpu/ops/pallas/knn.py::_knn_kernel`.
// Queries that share a coarse voxel share its neighbourhood of NB hash-grid
// buckets (27 for the 1-ring envelope, `max_buckets` for the tiered one).
// The host-side pre-pass (`ops/cuda/knn.py::group_queries`) packs them into
// groups of at most GROUP_CAP = 64 and resolves each group's bucket ids; this
// kernel computes, for every query of a group, the k smallest squared
// distances to the NB*64 slots of those buckets, and the flat candidate index
// (bucket * 64 + slot) of each.  Ties go to the lowest flat index, as in the
// TPU kernel's k passes of min/argmin.
//
// What bounds it on the H100: the work the data needs is small.  On the
// main path's voxel-downsampled windows a group holds one or two real
// queries and a 27-bucket neighbourhood holds about eight occupied buckets,
// so at N = 8192 (g_max = 2048) the needed f32 work is a few MFLOP (8 per
// query-candidate pair) against ~7 MB of inputs and outputs: the least time
// is set by bytes, ~2 us at 3.35 TB/s.  This first kernel does not exploit
// that sparsity: every CTA evaluates all 64 query slots against all NB*64
// candidates, vacant slots, absent buckets and empty groups included
// (2048 x 64 x 1728 = 2.3e8 pair evaluations at N = 8192), so it is bound
// by its own instruction issue; PERF.md has its distance to the bound.
//
// What the design does about it: one CTA per group stages the group's
// buckets once in shared memory (recentred on the group leader's bucket
// centre, absent buckets written as the FAR sentinel instead of loaded), so
// every bucket byte crosses the memory bus once per group and the inner loop
// reads shared memory only, as a broadcast (all lanes read the same
// candidate).  One thread per query keeps its sorted top-k in registers
// (K is a template parameter, so the insertion network is fully unrolled).
// Skipping absent buckets and vacant slots is the next step.
// The distance is (q - p)^2 on the recentred coordinates, rounded after
// every operation (__fsub_rn/__fmul_rn/__fadd_rn, no FMA contraction), which
// makes it bit-identical to the plain PyTorch version
// (`ops/cuda/knn.py::group_topk_plain`) and so gives both the same ties.
// Tensor cores (the TPU kernel's MXU expansion) and TMA are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kGroupCap = 64;      // queries per group == threads per CTA
constexpr float kFar = 1.0e9f;     // empty-slot / absent-bucket sentinel

template <int K>
__global__ void __launch_bounds__(kGroupCap)
knn_grouped_kernel(const int32_t* __restrict__ bucket_ids,  // (G, nb)
                   const float* __restrict__ order_q,       // (G, 64, 3)
                   const float* __restrict__ centers,       // (G, 1, 3)
                   const float* __restrict__ map_pts,       // (T, slots, 3)
                   float* __restrict__ sq_out,              // (G, 64, K)
                   int32_t* __restrict__ idx_out,           // (G, 64, K)
                   int nb, int slots) {
  extern __shared__ float cand[];  // (nb * slots, 3), recentred
  const int g = blockIdx.x;
  const float c[3] = {centers[g * 3 + 0], centers[g * 3 + 1], centers[g * 3 + 2]};
  const int row = slots * 3;       // floats per bucket
  const int n_cand = nb * slots;

  // Stage the group's buckets: consecutive threads read consecutive floats
  // of one contiguous bucket row.
  for (int e = threadIdx.x; e < nb * row; e += blockDim.x) {
    const int b = e / row;
    const int off = e - b * row;
    const int bid = bucket_ids[(size_t)g * nb + b];
    const float v = bid >= 0 ? map_pts[(size_t)bid * row + off] : kFar;
    cand[e] = __fsub_rn(v, c[off % 3]);
  }
  __syncthreads();

  const int qi = threadIdx.x;
  const float* q = order_q + ((size_t)g * kGroupCap + qi) * 3;
  const float qx = __fsub_rn(q[0], c[0]);
  const float qy = __fsub_rn(q[1], c[1]);
  const float qz = __fsub_rn(q[2], c[2]);

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = CUDART_INF_F;
    bi[j] = 0;
  }

  for (int i = 0; i < n_cand; ++i) {
    const float dx = __fsub_rn(qx, cand[3 * i + 0]);
    const float dy = __fsub_rn(qy, cand[3 * i + 1]);
    const float dz = __fsub_rn(qz, cand[3 * i + 2]);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    if (d < bd[K - 1]) {
      // insert after every entry <= d: candidates arrive in increasing
      // index, so equal distances stay in index order
#pragma unroll
      for (int j = K - 1; j >= 0; --j) {
        const bool above = (j > 0) && (d < bd[j > 0 ? j - 1 : 0]);
        if (above) {
          bd[j] = bd[j - 1];
          bi[j] = bi[j - 1];
        } else if (d < bd[j]) {
          bd[j] = d;
          bi[j] = i;
        }
      }
    }
  }

  const size_t o = ((size_t)g * kGroupCap + qi) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    sq_out[o + j] = bd[j];
    idx_out[o + j] = bi[j];
  }
}

template <int K>
cudaError_t launch(const int32_t* bucket_ids, const float* order_q,
                   const float* centers, const float* map_pts, float* sq_out,
                   int32_t* idx_out, int g_max, int nb, int slots,
                   cudaStream_t stream) {
  const size_t smem = (size_t)nb * slots * 3 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_grouped_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  knn_grouped_kernel<K><<<g_max, kGroupCap, smem, stream>>>(
      bucket_ids, order_q, centers, map_pts, sq_out, idx_out, nb, slots);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value (0 on success); the Python wrapper raises on
// anything else.  Every pointer is device memory laid out as documented on
// the kernel; the wrapper checks shapes, dtypes and contiguity.
extern "C" int knn_grouped_launch(const void* bucket_ids, const void* order_q,
                                  const void* centers, const void* map_pts,
                                  void* sq_out, void* idx_out, int g_max,
                                  int nb, int k, int slots, void* stream) {
  if (g_max <= 0) return (int)cudaSuccess;
  const auto* b = static_cast<const int32_t*>(bucket_ids);
  const auto* q = static_cast<const float*>(order_q);
  const auto* c = static_cast<const float*>(centers);
  const auto* p = static_cast<const float*>(map_pts);
  auto* s = static_cast<float*>(sq_out);
  auto* i = static_cast<int32_t*>(idx_out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return (int)launch<1>(b, q, c, p, s, i, g_max, nb, slots, st);
    case 2: return (int)launch<2>(b, q, c, p, s, i, g_max, nb, slots, st);
    case 3: return (int)launch<3>(b, q, c, p, s, i, g_max, nb, slots, st);
    case 4: return (int)launch<4>(b, q, c, p, s, i, g_max, nb, slots, st);
    case 5: return (int)launch<5>(b, q, c, p, s, i, g_max, nb, slots, st);
    case 6: return (int)launch<6>(b, q, c, p, s, i, g_max, nb, slots, st);
    case 7: return (int)launch<7>(b, q, c, p, s, i, g_max, nb, slots, st);
    case 8: return (int)launch<8>(b, q, c, p, s, i, g_max, nb, slots, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

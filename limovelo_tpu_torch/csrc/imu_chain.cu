// The IMU chains of the device step for Hopper (sm_90a), bound to Python
// through ctypes (wrapper: `ops/cuda/imu_chain.py`).
//
// Replaces no TPU kernel: the JAX package runs these chains as XLA scans
// (`limovelo_tpu/filter/process.py::predict_window`,
// `limovelo_tpu/deskew/compensate.py::build_path` and `compensate`).  Run
// eagerly in PyTorch they are Python loops over a window's IMU samples that
// issue one small operation per sample: at KITTI's 1000 Hz (101 samples in
// the 128 bucket) about 590 launches for the prediction and 660 for the
// deskew, and 8 host reads of 0-dim index tensors, in every window.  Three
// kernels do the same arithmetic in three launches and read nothing back:
//
//  imu_predict_kernel  one CTA: `filter/process.py::predict_window_plain`.
//      The masked dt, the rotation increments Exp((w - bg) dt) and their
//      inverses are computed for a chunk of samples in parallel; thread 0
//      walks the chunk's rotation chain and the p, v running sums; then all
//      threads walk its covariance chain P <- Fx P Fx^T + Fw Q Fw^T, a
//      thread per entry of the 23x23 P, P and Fx in shared memory, a barrier
//      between the two products.  Fx is the identity with the six blocks of
//      `error_jacobians` (written per sample by 39 threads into one of two
//      buffers, so a barrier per product is enough); Fw Q Fw^T is formed per
//      entry from Fw's three non-zero columns in each row.  A masked sample
//      has dt = 0, for which the plain update is an exact identity (Exp(0) =
//      I, no noise), so its covariance step is skipped.
//  imu_path_kernel  one CTA: `deskew/compensate.py::build_path`.  With
//      `after_anchor` (lio_step) only samples strictly after the anchor time
//      count and the anchor's controls are the first such sample's (the
//      host's when there is none); without it (mapping_step) the mask and
//      controls are as given.  Warp 0 walks the rotation chain and the p, v
//      sums, warp 1 the carried node times and the 1/2 (s + a) control
//      smoothing, side by side.
//  imu_deskew_kernel  a thread per point: `compensate_plain`.  A CTA stages
//      the node times in shared memory; warp 0 brackets t2 and integrates to
//      it (`state_at`) for the CTA's world -> lidar@t2 transform; each
//      thread brackets its stamp by counting the nodes whose carried time is
//      <= it (`_bracket`, exactly: no search), integrates the residual dt
//      and maps the point lidar -> imu -> world -> lidar@t2.  Masked rows
//      come back as zeros.
//
// What bounds them: latency, not bytes or FLOPs.  The two chains are
// sequential scans of M steps (a 3x3 product, then two dependent 23-term
// dot products with a barrier each); the card's work is tens of
// microseconds against the milliseconds the host spent issuing the loops.
// The deskew reads 16 bytes and writes 12 a point, with an S-term count
// from shared memory: microseconds at N = 32768.
//
// Numerics: f32 throughout, IEEE division and square root, the precise
// sinf/cosf (no --use_fast_math), and `geometry/so3.py::exp`'s Taylor
// branch below theta = 1e-4; every step of the plain functions is kept.
// The nominal chains (R, p, v, the path's nodes) and the deskewed points
// are the plain functions' on the card bit for bit: the deskew feeds the
// voxel filter's medoid choice, which a last-bit difference can flip, and a
// flipped medoid changes the map from then on.  So each operation rounds as
// the PyTorch operation it replaces does on the card (measured on an H100
// with PyTorch 2.11 and CUDA 12.8, `tests/test_torch_cuda.py` holds it):
// an elementwise operation rounds once (the `_rn` intrinsics, which nvcc
// never fuses); a sum of three over the last dimension adds
// (x0 + x2) + x1; a division by a Python number multiplies by its f32
// reciprocal; and cuBLAS rounds a 3-term dot product one of three ways
// (`dot3`), by the kind of product.  Two things are not followed: past
// 65535 points (a bucket of 65536) cuBLAS computes the batched 3x3 products
// of the last rows another way, a few ulps apart; and the covariance chain,
// whose 23x23 products are summed in another order than cuBLAS's, with
// fused products, within 1e-6 of P's largest entry per hundred steps.
//
// The IMU bucket M is the loop bound (8 to 512 in the configurations, more
// beyond the last bucket); samples are staged in shared memory kChunk at a
// time, so no size needs more than the static shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

// Argument blocks, passed by pointer from Python (`ops/cuda/imu_chain.py`
// mirrors them as ctypes structures).  Every pointer is device memory, f32
// unless marked; the wrapper checks shapes, dtypes and contiguity.
struct PredictArgs {
  const float* R;        // (3, 3) x.R
  const float* p;        // (3,)
  const float* v;        // (3,)
  const float* bg;       // (3,)
  const float* ba;       // (3,)
  const float* g;        // (3,)
  const float* P;        // (23, 23)
  const float* Q;        // (12, 12)
  const float* t;        // (M,)
  const float* acc;      // (M, 3)
  const float* gyr;      // (M, 3)
  const uint8_t* mask;   // (M,) bool
  const float* t0;       // (1,) time of the state
  float* out;            // (552,): P at 0, R at 532, p at 544, v at 548
  int m;
  int mv;                // DotKind of a batched matrix-vector product of M
};

struct PathArgs {
  const float* R;        // (3, 3) anchor.R
  const float* p;        // (3,)
  const float* v;        // (3,)
  const float* bg;       // (3,)
  const float* ba;       // (3,)
  const float* g;        // (3,)
  const float* t0;       // (1,) anchor time
  const float* a0;       // (3,) the host's controls at the anchor
  const float* w0;       // (3,)
  const float* t;        // (M,)
  const float* acc;      // (M, 3)
  const float* gyr;      // (M, 3)
  const uint8_t* mask;   // (M,) bool
  float* nodes;          // (22 S,), S = M + 1: t (S) | R (9 S) | p | v | a | w (3 S each)
  uint8_t* node_mask;    // (S,) bool
  int m;
  int mv;                // DotKind of a batched matrix-vector product of M
  int after_anchor;
};

struct DeskewArgs {
  const float* nt;       // (S,) path node times
  const float* nR;       // (S, 3, 3)
  const float* np;       // (S, 3)
  const float* nv;       // (S, 3)
  const float* na;       // (S, 3)
  const float* nw;       // (S, 3)
  const float* bg;       // (3,) anchor
  const float* ba;       // (3,)
  const float* g;        // (3,)
  const float* R_LI;     // (3, 3)
  const float* t_LI;     // (3,)
  const float* t2;       // (1,)
  const float* pts;      // (N, 3)
  const float* pts_t;    // (N,)
  const uint8_t* pts_mask;  // (N,) bool
  float* out;            // (N, 3)
  int s;
  int n;
  int mv;                // DotKind of a batched matrix-vector product of N
};

namespace {

constexpr int kDim = 23;                // error-state dimension
constexpr int kDim2 = kDim * kDim;
constexpr int kNoise = 12;              // noise dimension (gyro, acc, bias gyro, bias acc)
constexpr int kPos = 0, kRot = 3, kVel = 12, kBg = 15, kBa = 18, kGrav = 21;
constexpr int kFxBlock = 39;            // Fx entries that differ from the identity
constexpr int kPredictThreads = 544;    // 17 warps: a thread per entry of P
constexpr int kPathThreads = 64;        // warp 0: poses; warp 1: times and controls
constexpr int kPointThreads = 256;
constexpr int kChunk = 256;             // IMU samples staged at a time
constexpr int kOutR = 532, kOutP = 544, kOutV = 548;
constexpr float kSmallAngle = 1e-4f;    // geometry/so3.py::exp's Taylor branch

// ---- PyTorch's arithmetic on the card, operation for operation ----

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float clamp0(float d) { return d < 0.0f ? 0.0f : d; }  // NaN stays

// How cuBLAS rounds a dot product of three, by the kind of product:
//  kGemm      a batched 3x3 product, (N, 3) @ (3, 3)^T, or the product of
//             two transposed 3x3 matrices: fma chain in k order;
//  kGemv      a single 3x3 product or matrix-vector product, and a batched
//             matrix-vector product (`@ v[..., None]`, einsum "nij,nj->ni")
//             of other batch sizes: (a0 b0 + a1 b1, fused) + a2 b2;
//  kGemvWide  a batched matrix-vector product of 16384 to 32768:
//             (a0 b0 + a2 b2, fused) + a1 b1.
enum DotKind { kGemm = 0, kGemv = 1, kGemvWide = 2 };

__device__ __forceinline__ float dot3(int kind, float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  if (kind == kGemm) return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
  if (kind == kGemv) return __fadd_rn(__fmaf_rn(a1, b1, __fmul_rn(a0, b0)), __fmul_rn(a2, b2));
  return __fadd_rn(__fmaf_rn(a2, b2, __fmul_rn(a0, b0)), __fmul_rn(a1, b1));
}

// C = A B, 3x3 row-major.
__device__ __forceinline__ void mat3(int kind, const float* A, const float* B, float* C) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      C[3 * r + c] = dot3(kind, A[3 * r], A[3 * r + 1], A[3 * r + 2], B[c], B[3 + c], B[6 + c]);
}

// Row r of A (3x3, row-major) times x.
__device__ __forceinline__ float row_dot(int kind, const float* A, int r, const float* x) {
  return dot3(kind, A[3 * r], A[3 * r + 1], A[3 * r + 2], x[0], x[1], x[2]);
}

// Exp(hat(u)) into E and, when Einv is given, Exp(-hat(u)) into Einv, as
// geometry/so3.py::exp computes them: I + a hat(+-u) + b hat(u)^2.  `w2`
// is the kind of product hat(u) @ hat(u) is: kGemm for a batch, kGemv for
// one vector.
__device__ __forceinline__ void so3_exp(const float u[3], int w2, float* E, float* Einv) {
  const float th2 = add(add(mul(u[0], u[0]), mul(u[2], u[2])), mul(u[1], u[1]));
  const float th = __fsqrt_rn(th2);
  float a, b;
  if (th < kSmallAngle) {              // x / 6.0 is x * (1 / 6.0f) on the card
    a = sub(1.0f, mul(th2, 1.0f / 6.0f));
    b = sub(0.5f, mul(th2, 1.0f / 24.0f));
  } else {
    a = __fdiv_rn(sinf(th), th);
    b = __fdiv_rn(sub(1.0f, cosf(th)), th2);
  }
  const float W[9] = {0.0f, -u[2], u[1], u[2], 0.0f, -u[0], -u[1], u[0], 0.0f};
  float W2[9];
  mat3(w2, W, W, W2);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float id = (k % 4 == 0) ? 1.0f : 0.0f;
    E[k] = add(add(id, mul(a, W[k])), mul(b, W2[k]));
    if (Einv) Einv[k] = add(add(id, mul(a, -W[k])), mul(b, W2[k]));
  }
}

// The path's pose after one sample (filter/process.py::predict_window_plain
// and deskew/compensate.py::build_path_plain): acc_w = R (a - ba) + g as a
// batched matrix-vector product of kind `mv`, v += acc_w dt, p += dp with
// dp = v dt + h, where h is 0.5 acc_w dt dt rounded as ((0.5 acc_w) dt) dt
// (`squared` false: the prediction) or (0.5 acc_w)(dt dt) (the path).
__device__ __forceinline__ void nominal_step(int mv, bool squared, const float* inc,
                                             const float am[3], const float g[3], float dt,
                                             float R[9], float p[3], float v[3]) {
  const float d2 = mul(dt, dt);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float acc_w = add(row_dot(mv, R, r, am), g[r]);
    const float h = squared ? mul(mul(0.5f, acc_w), d2) : mul(mul(mul(0.5f, acc_w), dt), dt);
    p[r] = add(p[r], add(mul(v[r], dt), h));
    v[r] = add(v[r], mul(acc_w, dt));
  }
  float Rn[9];
  mat3(kGemv, R, inc, Rn);             // rotation_chain: one 3x3 product a sample
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = Rn[e];
}

// Valid IMU entry: masked in, and strictly after the anchor time when the
// path asks for it (lio_step's path mask).
__device__ __forceinline__ bool entry_valid(const float* t, const uint8_t* mask, int j,
                                            float t_anchor, bool after) {
  return mask[j] != 0 && (!after || t[j] > t_anchor);
}

// dt of entry i against the last valid entry before it (or t0), clamped at
// 0, and 0 where the entry is not valid (filter/process.py::masked_dt).
__device__ float masked_dt(const float* t, const uint8_t* mask, int i, float t0, bool after) {
  if (!entry_valid(t, mask, i, t0, after)) return 0.0f;
  float prev = t0;
  for (int j = i - 1; j >= 0; --j) {
    if (entry_valid(t, mask, j, t0, after)) {
      prev = t[j];
      break;
    }
  }
  return clamp0(sub(t[i], prev));
}

// s2.dexp_dg(g) = -hat(g) B(g), the gravity block of Fx per unit dt (3x2,
// row-major), with geometry/s2.py::basis.
__device__ void gravity_block(const float g[3], float C[6]) {
  const float ng = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]) + 1e-30f;
  const float n[3] = {g[0] / ng, g[1] / ng, g[2] / ng};
  const float ax[3] = {fabsf(n[0]), fabsf(n[1]), fabsf(n[2])};
  float ref[3] = {0.0f, 0.0f, 0.0f};
  if (ax[2] <= ax[0] && ax[2] <= ax[1]) ref[2] = 1.0f;
  else if (ax[0] <= ax[1]) ref[0] = 1.0f;
  else ref[1] = 1.0f;
  float b1[3] = {n[1] * ref[2] - n[2] * ref[1], n[2] * ref[0] - n[0] * ref[2],
                 n[0] * ref[1] - n[1] * ref[0]};
  const float nb = sqrtf(b1[0] * b1[0] + b1[1] * b1[1] + b1[2] * b1[2]) + 1e-30f;
#pragma unroll
  for (int k = 0; k < 3; ++k) b1[k] = b1[k] / nb;
  const float b2[3] = {n[1] * b1[2] - n[2] * b1[1], n[2] * b1[0] - n[0] * b1[2],
                       n[0] * b1[1] - n[1] * b1[0]};
  const float H[9] = {0.0f, -g[2], g[1], g[2], 0.0f, -g[0], -g[1], g[0], 0.0f};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    C[2 * r] = -(H[3 * r] * b1[0] + H[3 * r + 1] * b1[1] + H[3 * r + 2] * b1[2]);
    C[2 * r + 1] = -(H[3 * r] * b2[0] + H[3 * r + 1] * b2[1] + H[3 * r + 2] * b2[2]);
  }
}

// First column of Fw's non-zero 3-block in error-state row r, -1 if none:
// rot <- gyro noise, vel <- acc noise, bg and ba <- their random walks.
__device__ __forceinline__ int noise_col(int r) {
  if (r >= kRot && r < kRot + 3) return 0;
  if (r >= kVel && r < kVel + 3) return 3;
  if (r >= kBg && r < kBg + 3) return 6;
  if (r >= kBa && r < kBa + 3) return 9;
  return -1;
}

// Fw[r][c0 + k] for k = 0..2 at one sample (process.py::error_jacobians).
__device__ __forceinline__ void fw_row(int r, const float* Rp, float dt, float f[3]) {
  if (r >= kVel && r < kVel + 3) {
#pragma unroll
    for (int k = 0; k < 3; ++k) f[k] = mul(-Rp[3 * (r - kVel) + k], dt);
    return;
  }
  const int rr = r < kVel ? r - kRot : (r < kBa ? r - kBg : r - kBa);
  const float d = r < kVel ? -dt : dt;
#pragma unroll
  for (int k = 0; k < 3; ++k) f[k] = k == rr ? d : 0.0f;
}

// Entry e (0..38) of the blocks in which Fx differs from the identity, at
// one sample with pre-sample rotation Rp, inverse increment Einv and
// accelerometer reading less bias am (process.py::error_jacobians).
__device__ void fx_entry(int e, float* Fx, const float* Rp, const float* Einv, const float am[3],
                         const float* C, float dt) {
  if (e < 9) {                               // rot <- rot: Exp(-(w - bg) dt)
    Fx[(kRot + e / 3) * kDim + kRot + e % 3] = Einv[e];
  } else if (e < 18) {                       // vel <- rot: -(R hat(a - ba)) dt
    const int r = (e - 9) / 3, c = (e - 9) % 3;
    const float H[9] = {0.0f, -am[2], am[1], am[2], 0.0f, -am[0], -am[1], am[0], 0.0f};
    const float m = dot3(kGemm, Rp[3 * r], Rp[3 * r + 1], Rp[3 * r + 2], H[c], H[3 + c], H[6 + c]);
    Fx[(kVel + r) * kDim + kRot + c] = mul(-m, dt);
  } else if (e < 27) {                       // vel <- ba: -R dt
    const int r = (e - 18) / 3, c = (e - 18) % 3;
    Fx[(kVel + r) * kDim + kBa + c] = mul(-Rp[3 * r + c], dt);
  } else if (e < 33) {                       // vel <- grav: dexp_dg(g) dt
    const int r = (e - 27) / 2, c = (e - 27) % 2;
    Fx[(kVel + r) * kDim + kGrav + c] = mul(C[e - 27], dt);
  } else if (e < 36) {                       // rot <- bg: -I dt
    const int r = e - 33;
    Fx[(kRot + r) * kDim + kBg + r] = -dt;
  } else {                                   // pos <- vel: I dt
    const int r = e - 36;
    Fx[(kPos + r) * kDim + kVel + r] = dt;
  }
}

__global__ void __launch_bounds__(kPredictThreads) imu_predict_kernel(PredictArgs a) {
  __shared__ float sP[kDim2];
  __shared__ float sT[kDim2];
  __shared__ float sFx[2][kDim2];
  __shared__ float sDt[kChunk];
  __shared__ float sR[kChunk * 9];     // the increment, then the pre-sample rotation
  __shared__ float sE[kChunk * 9];     // the inverse increment
  __shared__ float sC[6];

  const int tid = threadIdx.x;
  const int M = a.m;
  const float t0 = a.t0[0];
  float bg[3], ba[3], g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    bg[k] = a.bg[k];
    ba[k] = a.ba[k];
    g[k] = a.g[k];
  }
  for (int k = tid; k < kDim2; k += blockDim.x) {
    sP[k] = a.P[k];
    const float id = (k / kDim == k % kDim) ? 1.0f : 0.0f;
    sFx[0][k] = id;
    sFx[1][k] = id;
  }
  if (tid == 32) gravity_block(g, sC);

  // this thread's entry (i, j) of P, and the Q terms of its Fw Q Fw^T
  const int i = tid / kDim, j = tid % kDim;
  const bool owns = tid < kDim2;
  const int ci = owns ? noise_col(i) : -1, cj = owns ? noise_col(j) : -1;
  const bool noisy = ci >= 0 && cj >= 0;
  float q[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) q[k] = noisy ? a.Q[(ci + k / 3) * kNoise + cj + k % 3] : 0.0f;

  float R[9], p[3], v[3];              // the nominal chain, thread 0's
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = a.R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = a.p[k];
      v[k] = a.v[k];
    }
  }
  int par = 0;
  for (int c0 = 0; c0 < M; c0 += kChunk) {
    const int n = min(kChunk, M - c0);
    for (int s = tid; s < n; s += blockDim.x) {
      const int k = c0 + s;
      const float dt = masked_dt(a.t, a.mask, k, t0, false);
      sDt[s] = dt;
      const float u[3] = {mul(sub(a.gyr[3 * k], bg[0]), dt), mul(sub(a.gyr[3 * k + 1], bg[1]), dt),
                          mul(sub(a.gyr[3 * k + 2], bg[2]), dt)};
      so3_exp(u, kGemm, &sR[9 * s], &sE[9 * s]);
    }
    __syncthreads();
    if (tid == 0) {
      for (int s = 0; s < n; ++s) {
        const int k = c0 + s;
        float inc[9];
#pragma unroll
        for (int e = 0; e < 9; ++e) {
          inc[e] = sR[9 * s + e];
          sR[9 * s + e] = R[e];
        }
        const float am[3] = {sub(a.acc[3 * k], ba[0]), sub(a.acc[3 * k + 1], ba[1]),
                             sub(a.acc[3 * k + 2], ba[2])};
        nominal_step(a.mv, false, inc, am, g, sDt[s], R, p, v);
      }
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const int k = c0 + s;
      if (!a.mask[k]) continue;        // dt = 0: the plain update is an exact identity
      float* Fx = sFx[par];
      const float dt = sDt[s];
      const float* Rp = &sR[9 * s];
      if (tid < kFxBlock) {
        const float am[3] = {sub(a.acc[3 * k], ba[0]), sub(a.acc[3 * k + 1], ba[1]),
                             sub(a.acc[3 * k + 2], ba[2])};
        fx_entry(tid, Fx, Rp, &sE[9 * s], am, sC, dt);
      }
      __syncthreads();
      if (owns) {                      // T = Fx P
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < kDim; ++m) acc += Fx[i * kDim + m] * sP[m * kDim + j];
        sT[tid] = acc;
      }
      __syncthreads();
      if (owns) {                      // P = T Fx^T + Fw Q Fw^T
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < kDim; ++m) acc += sT[i * kDim + m] * Fx[j * kDim + m];
        if (noisy) {
          float fi[3], fj[3];
          fw_row(i, Rp, dt, fi);
          fw_row(j, Rp, dt, fj);
          float nz = 0.0f;
#pragma unroll
          for (int l = 0; l < 3; ++l) {
            const float fq = fi[0] * q[l] + fi[1] * q[3 + l] + fi[2] * q[6 + l];
            nz += fq * fj[l];
          }
          acc += nz;
        }
        sP[tid] = acc;
      }
      par ^= 1;
    }
    __syncthreads();
  }
  for (int k = tid; k < kDim2; k += blockDim.x) a.out[k] = sP[k];
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) a.out[kOutR + k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.out[kOutP + k] = p[k];
      a.out[kOutV + k] = v[k];
    }
  }
}

__global__ void __launch_bounds__(kPathThreads) imu_path_kernel(PathArgs a) {
  __shared__ float sDt[kChunk];
  __shared__ float sInc[kChunk * 9];
  __shared__ int sFirst;

  const int tid = threadIdx.x;
  const int M = a.m, S = M + 1;
  const bool after = a.after_anchor != 0;
  const float t0 = a.t0[0];
  float* nt = a.nodes;
  float* nR = nt + S;
  float* np = nR + 9 * S;
  float* nv = np + 3 * S;
  float* na = nv + 3 * S;
  float* nw = na + 3 * S;
  float bg[3], ba[3], g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    bg[k] = a.bg[k];
    ba[k] = a.ba[k];
    g[k] = a.g[k];
  }
  if (tid == 0) sFirst = M;
  __syncthreads();
  if (after) {
    for (int k = tid; k < M; k += blockDim.x)
      if (entry_valid(a.t, a.mask, k, t0, true)) atomicMin(&sFirst, k);
  }
  __syncthreads();

  float R[9], p[3], v[3];              // warp 0's lane 0: node poses
  float ctl[6], tc = t0;               // warp 1's lane 0: controls and carried time
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) nR[k] = R[k] = a.R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      np[k] = p[k] = a.p[k];
      nv[k] = v[k] = a.v[k];
    }
  } else if (tid == 32) {
    // the anchor's controls: the first valid sample's (lio_step), else the host's
    const int f = sFirst;
    const bool derived = after && f < M;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ctl[k] = derived ? a.acc[3 * f + k] : a.a0[k];
      ctl[3 + k] = derived ? a.gyr[3 * f + k] : a.w0[k];
      na[k] = ctl[k];
      nw[k] = ctl[3 + k];
    }
    nt[0] = t0;
    a.node_mask[0] = 1;
  }
  for (int c0 = 0; c0 < M; c0 += kChunk) {
    const int n = min(kChunk, M - c0);
    for (int s = tid; s < n; s += blockDim.x) {
      const int k = c0 + s;
      const float dt = masked_dt(a.t, a.mask, k, t0, after);
      sDt[s] = dt;
      const float u[3] = {mul(sub(a.gyr[3 * k], bg[0]), dt), mul(sub(a.gyr[3 * k + 1], bg[1]), dt),
                          mul(sub(a.gyr[3 * k + 2], bg[2]), dt)};
      so3_exp(u, kGemm, &sInc[9 * s], nullptr);
    }
    __syncthreads();
    if (tid == 0) {
      for (int s = 0; s < n; ++s) {
        const int k = c0 + s;
        const float am[3] = {sub(a.acc[3 * k], ba[0]), sub(a.acc[3 * k + 1], ba[1]),
                             sub(a.acc[3 * k + 2], ba[2])};
        nominal_step(a.mv, true, &sInc[9 * s], am, g, sDt[s], R, p, v);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          np[3 * (k + 1) + r] = p[r];
          nv[3 * (k + 1) + r] = v[r];
        }
#pragma unroll
        for (int e = 0; e < 9; ++e) nR[9 * (k + 1) + e] = R[e];
      }
    } else if (tid == 32) {
      for (int s = 0; s < n; ++s) {
        const int k = c0 + s;
        const bool valid = entry_valid(a.t, a.mask, k, t0, after);
        if (valid) {                   // 1/2 (s + a): halving is exact
          tc = a.t[k];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            ctl[q] = mul(0.5f, add(ctl[q], a.acc[3 * k + q]));
            ctl[3 + q] = mul(0.5f, add(ctl[3 + q], a.gyr[3 * k + q]));
          }
        }
        nt[k + 1] = tc;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          na[3 * (k + 1) + q] = ctl[q];
          nw[3 * (k + 1) + q] = ctl[3 + q];
        }
        a.node_mask[k + 1] = valid ? 1 : 0;
      }
    }
    __syncthreads();
  }
}

// Index of the last node whose carried time is <= q: the count of such
// nodes less one, clamped (deskew/compensate.py::_bracket).
__device__ __forceinline__ int clamp_bracket(int count, int S) {
  const int s = count - 1;
  return s < 0 ? 0 : (s > S - 1 ? S - 1 : s);
}

// One constant-control step of dt from node k (compensate.py::_integrate):
// the rotation and position reached.  `mv` and `mm` are the kinds of
// R (a - ba) and of the 3x3 products: for every point at once (compensate)
// the batched kinds, for t2 alone (state_at) kGemv.
__device__ void integrate(const DeskewArgs& a, int k, float dt, int mv, int mm, const float bg[3],
                          const float ba[3], const float g[3], float Rn[9], float pn[3]) {
  float R[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = __ldg(&a.nR[9 * k + e]);
  float am[3], u[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    am[r] = sub(__ldg(&a.na[3 * k + r]), ba[r]);
    u[r] = mul(sub(__ldg(&a.nw[3 * k + r]), bg[r]), dt);
  }
  float E[9];
  so3_exp(u, mm, E, nullptr);
  mat3(mm, R, E, Rn);
  const float d2 = mul(dt, dt);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float acc_w = add(row_dot(mv, R, r, am), g[r]);
    pn[r] = add(add(__ldg(&a.np[3 * k + r]), mul(__ldg(&a.nv[3 * k + r]), dt)),
                mul(mul(0.5f, acc_w), d2));
  }
}

__global__ void __launch_bounds__(kPointThreads) imu_deskew_kernel(DeskewArgs a) {
  extern __shared__ float st[];        // node times (S)
  __shared__ float sX[12];             // world -> lidar@t2: R_w2l (9), t_w2l (3)

  const int S = a.s;
  for (int k = threadIdx.x; k < S; k += blockDim.x) st[k] = a.nt[k];
  float bg[3], ba[3], g[3], RL[9], tL[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    bg[k] = a.bg[k];
    ba[k] = a.ba[k];
    g[k] = a.g[k];
    tL[k] = a.t_LI[k];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) RL[k] = a.R_LI[k];
  __syncthreads();

  if (threadIdx.x < 32) {              // state_at(t2), then the CTA's transform
    const float q = a.t2[0];
    int c = 0;
    for (int k = threadIdx.x; k < S; k += 32) c += st[k] <= q ? 1 : 0;
    c = __reduce_add_sync(0xffffffffu, c);
    if (threadIdx.x == 0) {
      const int s = clamp_bracket(c, S);
      float R2[9], p2[3];
      integrate(a, s, clamp0(sub(q, st[s])), kGemv, kGemv, bg, ba, g, R2, p2);
      // R_w2l = R_LI^T R2^T (two transposed operands: kGemm);
      // t_w2l = (-R_w2l) p2 - R_LI^T t_LI (matrix-vector products)
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int col = 0; col < 3; ++col)
          sX[3 * r + col] = dot3(kGemm, RL[r], RL[3 + r], RL[6 + r], R2[3 * col],
                                 R2[3 * col + 1], R2[3 * col + 2]);
#pragma unroll
      for (int r = 0; r < 3; ++r)
        sX[9 + r] = sub(-row_dot(kGemv, sX, r, p2),
                        dot3(kGemv, RL[r], RL[3 + r], RL[6 + r], tL[0], tL[1], tL[2]));
    }
  }
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.n) return;
  float* o = a.out + 3 * n;
  if (!a.pts_mask[n]) {
    o[0] = o[1] = o[2] = 0.0f;
    return;
  }
  const float q = a.pts_t[n];
  int c = 0;
  for (int k = 0; k < S; ++k) c += st[k] <= q ? 1 : 0;
  const int s = clamp_bracket(c, S);
  float Rt[9], pt[3];
  integrate(a, s, clamp0(sub(q, st[s])), a.mv, kGemm, bg, ba, g, Rt, pt);
  const float x[3] = {a.pts[3 * n], a.pts[3 * n + 1], a.pts[3 * n + 2]};
  float pi[3], pw[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)          // lidar -> imu: pts @ R_LI^T + t_LI
    pi[r] = add(row_dot(kGemm, RL, r, x), tL[r]);
#pragma unroll
  for (int r = 0; r < 3; ++r)          // imu -> world at the point's stamp
    pw[r] = add(row_dot(a.mv, Rt, r, pi), pt[r]);
#pragma unroll
  for (int r = 0; r < 3; ++r)          // world -> lidar at t2: p_world @ R_w2l^T + t_w2l
    o[r] = add(row_dot(kGemm, sX, r, pw), sX[9 + r]);
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).
extern "C" int imu_predict_launch(const PredictArgs* a, void* stream) {
  imu_predict_kernel<<<1, kPredictThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int imu_path_launch(const PathArgs* a, void* stream) {
  imu_path_kernel<<<1, kPathThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int imu_deskew_launch(const DeskewArgs* a, void* stream) {
  if (a->n <= 0) return (int)cudaSuccess;
  if (a->s < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a->s * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        imu_deskew_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (a->n + kPointThreads - 1) / kPointThreads;
  imu_deskew_kernel<<<grid, kPointThreads, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

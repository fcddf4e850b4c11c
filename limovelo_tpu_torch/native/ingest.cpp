// Native host-side sensor ingest for limovelo_tpu.
//
// TPU-native replacement for the reference's C++ host layer: the
// PointCloudProcessor decode/filter/sort chain
// (/root/reference/src/Utils/PointCloudProcessor.cpp) and the Buffer<T>
// time-indexed store (src/Objects/Buffer.cpp).  The TPU does all the math;
// this library keeps the CPU-side byte shuffling (PointCloud2 struct
// decoding, temporal downsample, min-range filter, time sort, window
// extraction) native so a 100 Hz pipeline never stalls on Python loops.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PointCloud2 field extraction: gather a strided field from a raw byte blob.
//   data: n_points * point_step bytes
//   out:  n_points floats (dtype converted)
// dtype codes follow sensor_msgs/PointField.
// ---------------------------------------------------------------------------
int pc2_extract_field(const uint8_t* data, int64_t n, int32_t point_step,
                      int32_t offset, int32_t datatype, float* out) {
  switch (datatype) {
    case 7:  // FLOAT32
      for (int64_t i = 0; i < n; ++i) {
        float v;
        std::memcpy(&v, data + i * point_step + offset, 4);
        out[i] = v;
      }
      return 0;
    case 8:  // FLOAT64
      for (int64_t i = 0; i < n; ++i) {
        double v;
        std::memcpy(&v, data + i * point_step + offset, 8);
        out[i] = static_cast<float>(v);
      }
      return 0;
    case 6:  // UINT32
      for (int64_t i = 0; i < n; ++i) {
        uint32_t v;
        std::memcpy(&v, data + i * point_step + offset, 4);
        out[i] = static_cast<float>(v);
      }
      return 0;
    case 5:  // INT32
      for (int64_t i = 0; i < n; ++i) {
        int32_t v;
        std::memcpy(&v, data + i * point_step + offset, 4);
        out[i] = static_cast<float>(v);
      }
      return 0;
    case 4:  // UINT16
      for (int64_t i = 0; i < n; ++i) {
        uint16_t v;
        std::memcpy(&v, data + i * point_step + offset, 2);
        out[i] = static_cast<float>(v);
      }
      return 0;
    default:
      return -1;
  }
}

// Like pc2_extract_field but into float64 (per-point absolute timestamps
// must not round through float32).
int pc2_extract_field_f64(const uint8_t* data, int64_t n, int32_t point_step,
                          int32_t offset, int32_t datatype, double* out) {
  switch (datatype) {
    case 7:
      for (int64_t i = 0; i < n; ++i) {
        float v;
        std::memcpy(&v, data + i * point_step + offset, 4);
        out[i] = v;
      }
      return 0;
    case 8:
      for (int64_t i = 0; i < n; ++i) {
        double v;
        std::memcpy(&v, data + i * point_step + offset, 8);
        out[i] = v;
      }
      return 0;
    case 6:
      for (int64_t i = 0; i < n; ++i) {
        uint32_t v;
        std::memcpy(&v, data + i * point_step + offset, 4);
        out[i] = static_cast<double>(v);
      }
      return 0;
    default:
      return -1;
  }
}

// ---------------------------------------------------------------------------
// temporal_downsample + min-range filter + stable time sort, fused.
// (PointCloudProcessor.cpp:101-123 semantics: keep every rate-th point by
// running counter, drop points with |p| <= min_dist, then sort by time.)
// Returns the number of surviving points; xyz_out/t_out must hold >= n.
// ---------------------------------------------------------------------------
int64_t process_scan(const float* xyz, const double* t, int64_t n,
                     int32_t downsample_rate, double min_dist,
                     float* xyz_out, double* t_out) {
  std::vector<int64_t> keep;
  keep.reserve(n);
  const double md2 = min_dist * min_dist;
  int64_t counter = 0;
  for (int64_t i = 0; i < n; ++i) {
    ++counter;
    if (downsample_rate > 1 && (counter % downsample_rate) != 0) continue;
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) continue;
    const double r2 =
        double(x) * x + double(y) * y + double(z) * z;
    if (r2 <= md2) continue;
    keep.push_back(i);
  }
  std::stable_sort(keep.begin(), keep.end(),
                   [&](int64_t a, int64_t b) { return t[a] < t[b]; });
  const int64_t m = static_cast<int64_t>(keep.size());
  for (int64_t j = 0; j < m; ++j) {
    const int64_t i = keep[j];
    xyz_out[3 * j] = xyz[3 * i];
    xyz_out[3 * j + 1] = xyz[3 * i + 1];
    xyz_out[3 * j + 2] = xyz[3 * i + 2];
    t_out[j] = t[i];
  }
  return m;
}

// Same as process_scan but also records each survivor's ORIGINAL index so
// the caller can gather side channels (intensity/reflectivity) without a
// second pass (Point.cpp:172-175 carries intensity through the pipeline).
int64_t process_scan_idx(const float* xyz, const double* t, int64_t n,
                         int32_t downsample_rate, double min_dist,
                         float* xyz_out, double* t_out, int64_t* idx_out) {
  std::vector<int64_t> keep;
  keep.reserve(n);
  const double md2 = min_dist * min_dist;
  int64_t counter = 0;
  for (int64_t i = 0; i < n; ++i) {
    ++counter;
    if (downsample_rate > 1 && (counter % downsample_rate) != 0) continue;
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) continue;
    const double r2 = double(x) * x + double(y) * y + double(z) * z;
    if (r2 <= md2) continue;
    keep.push_back(i);
  }
  std::stable_sort(keep.begin(), keep.end(),
                   [&](int64_t a, int64_t b) { return t[a] < t[b]; });
  const int64_t m = static_cast<int64_t>(keep.size());
  for (int64_t j = 0; j < m; ++j) {
    const int64_t i = keep[j];
    xyz_out[3 * j] = xyz[3 * i];
    xyz_out[3 * j + 1] = xyz[3 * i + 1];
    xyz_out[3 * j + 2] = xyz[3 * i + 2];
    t_out[j] = t[i];
    idx_out[j] = i;
  }
  return m;
}

// ---------------------------------------------------------------------------
// window extraction over a sorted time array: indices with t in (t1, t2].
// Returns (lo, hi) half-open range via out params (binary search,
// Algorithms::binary_search analog, Utils.hpp:8-23 — ours on ascending).
// ---------------------------------------------------------------------------
void time_window(const double* t, int64_t n, double t1, double t2,
                 int64_t* lo, int64_t* hi) {
  *lo = std::upper_bound(t, t + n, t1) - t;
  *hi = std::upper_bound(t, t + n, t2) - t;
}

// ---------------------------------------------------------------------------
// Pad a window into fixed-shape device staging buffers (bucketed shapes):
// copies m=hi-lo points, rebases times to float32, fills the mask.
// ---------------------------------------------------------------------------
void stage_window(const float* xyz, const double* t, int64_t lo, int64_t hi,
                  double rebase, int64_t bucket, float* xyz_pad, float* t_pad,
                  uint8_t* mask) {
  const int64_t m = std::min(hi - lo, bucket);
  const int64_t start = hi - m;  // keep newest if overfull
  for (int64_t j = 0; j < m; ++j) {
    const int64_t i = start + j;
    xyz_pad[3 * j] = xyz[3 * i];
    xyz_pad[3 * j + 1] = xyz[3 * i + 1];
    xyz_pad[3 * j + 2] = xyz[3 * i + 2];
    t_pad[j] = static_cast<float>(t[i] - rebase);
    mask[j] = 1;
  }
  for (int64_t j = m; j < bucket; ++j) {
    xyz_pad[3 * j] = xyz_pad[3 * j + 1] = xyz_pad[3 * j + 2] = 0.0f;
    t_pad[j] = 0.0f;
    mask[j] = 0;
  }
}

}  // extern "C"

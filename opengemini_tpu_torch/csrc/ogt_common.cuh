// Shared device and host helpers for the port's kernels (bucket_basic.cu,
// bucket_selectors.cu, grid_window.cu, widen_packed.cu, unpack_bits.cu,
// probe_count.cu).
//
// The sources expose a plain C interface (no PyTorch headers), are built
// with nvcc for sm_90a at first use and loaded with ctypes by
// opengemini_tpu_torch/ops/cuda_segment.py. Every entry point launches on
// the caller's stream, allocates nothing and returns the cudaError_t of
// the launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ogt {

constexpr unsigned kFullMask = 0xffffffffu;

// min/max that propagate NaN like jnp.min / torch.amin (fmin would drop it).
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double pos_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_nan_min(T x) {
  for (int o = 16; o > 0; o >>= 1) x = nan_min(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_nan_max(T x) {
  for (int o = 16; o > 0; o >>= 1) x = nan_max(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

// Segment of a tile in a segmented launch: the largest r < nseg with
// tile0[r] <= tile, tile0 non-decreasing with tile0[nseg] past the last
// tile, so empty segments (tile0[r] == tile0[r + 1]) are never chosen.
// Every thread of a CTA searches the same tile: uniform reads, which a
// __grid_constant__ table serves as broadcasts from the constant bank.
__device__ __forceinline__ int find_segment(const int* tile0, int nseg, int tile) {
  int lo = 0, hi = nseg;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile0[mid] <= tile) lo = mid; else hi = mid;
  }
  return lo;
}

// Whether p may be read or written as a vector of `bytes` bytes.
inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Grid of a grid-stride launch over `tiles` tiles on the current device:
// min(tiles, SM count x ctas_per_sm), the SM count read once per device;
// minus the cudaError_t when the device cannot be queried.
inline long long capped_grid(long long tiles, int ctas_per_sm) {
  static int sm_count[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  int n = (dev >= 0 && dev < 64) ? sm_count[dev] : 0;
  if (n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -static_cast<long long>(e);
    if (dev >= 0 && dev < 64) sm_count[dev] = n;
  }
  const long long cap = static_cast<long long>(n) * ctas_per_sm;
  return tiles < cap ? tiles : cap;
}

}  // namespace ogt

// Each source builds into its own shared library, so each carries one copy.
extern "C" const char* ogt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Capability probe: the masked count of every row of an int8 (R, C)
// matrix into int32 (R, 1), out[r] = #{c : m[r, c] != 0}.
//
// Replaces the TPU kernel opengemini_tpu/utils/devobs.py
// _probe_pallas.kern, the self-contained kernel whose run answers
// devobs.pallas_supported(); ops/device_decode.py routes the widen and
// bit-unpack steps to the card only when it ran and counted right. The
// port's utils/devobs.probe launches it on the 8 x 8 all-ones matrix
// once per process.
//
// Bound on the card: launch latency (it reads R*C bytes and writes 4*R,
// 96 bytes at 8 x 8: no launch reaches the byte bound).
// Design: one warp per block, one row per lane. A lane reads its row a
// word pair at a time (8-byte vector loads once the row pointer is
// 8-byte aligned, as every row of the 8 x 8 probe is) and counts the
// non-zero bytes of each 32-bit word with a byte-SIMD compare
// (__vcmpne4: 0xff in every byte that differs from 0) and __popc of
// its low bits; a scalar head and tail take unaligned bytes.
//
// ogt_probe_empty launches an empty kernel through the same library and
// binding: the launch floor kernel 6's time is held against.
#include "ogt_common.cuh"

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ int nonzero_bytes(unsigned w) {
  return __popc(__vcmpne4(w, 0u) & 0x01010101u);
}

__global__ void __launch_bounds__(kWarp)
probe_count_kernel(const int8_t* __restrict__ m, long long rows, int cols,
                   int32_t* __restrict__ out) {
  const long long r = static_cast<long long>(blockIdx.x) * kWarp + threadIdx.x;
  if (r >= rows) return;
  const int8_t* row = m + r * cols;
  int c = 0;
  int j = 0;
  while (j < cols && (reinterpret_cast<uintptr_t>(row + j) & 7u)) {
    c += row[j] != 0;
    ++j;
  }
  for (; j + 8 <= cols; j += 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + j);
    c += nonzero_bytes(w.x) + nonzero_bytes(w.y);
  }
  if (j + 4 <= cols) {
    c += nonzero_bytes(*reinterpret_cast<const unsigned*>(row + j));
    j += 4;
  }
  for (; j < cols; ++j) c += row[j] != 0;
  out[r] = c;
}

__global__ void probe_empty_kernel() {}

}  // namespace

extern "C" int ogt_probe_count(const void* m, long long rows, int cols,
                               void* out, void* stream) {
  if (rows <= 0) return 0;
  const long long blocks = (rows + kWarp - 1) / kWarp;
  probe_count_kernel<<<static_cast<unsigned>(blocks), kWarp, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(m), rows, cols, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ogt_probe_empty(void* stream) {
  probe_empty_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

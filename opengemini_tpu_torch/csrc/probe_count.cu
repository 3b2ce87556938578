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
// Bound on the card: launch latency (it reads R*C bytes and writes 4*R).
// Design: one thread per row, looping over its columns.
#include "ogt_common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
probe_count_kernel(const int8_t* __restrict__ m, long long rows, int cols,
                   int32_t* __restrict__ out) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  int c = 0;
  for (int j = 0; j < cols; ++j) c += m[r * cols + j] != 0;
  out[r] = c;
}

}  // namespace

extern "C" int ogt_probe_count(const void* m, long long rows, int cols,
                               void* out, void* stream) {
  if (rows <= 0) return 0;
  const long long blocks = (rows + kThreads - 1) / kThreads;
  probe_count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(m), rows, cols, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

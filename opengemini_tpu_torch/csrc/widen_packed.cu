// Packed little-endian widen: `cnt` unsigned values of `width` bytes
// (width 1 or 2) -> int32, out[i] = sum_j raw[i*width + j] << (8*j).
//
// Replaces the TPU kernel opengemini_tpu/ops/pallas_segment.py
// widen_packed -> _widen_call -> _widen_kernel, the byte-combine step of
// the device-side FOR-delta and dictionary-index decode
// (ops/device_decode.py _widen). int32 is exact for widths 1 and 2.
//
// Bound on the card: bytes. The kernel reads cnt*width bytes once and
// writes 4*cnt bytes, with one shift-or per byte. Design: one thread per
// output value; neighbouring threads read neighbouring bytes and write
// neighbouring words, so both sides coalesce.
#include "ogt_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int W>
__global__ void __launch_bounds__(kThreads)
widen_kernel(const uint8_t* __restrict__ raw, long long cnt,
             int32_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= cnt) return;
  int32_t acc = raw[i * W];
#pragma unroll
  for (int j = 1; j < W; ++j) acc |= static_cast<int32_t>(raw[i * W + j]) << (8 * j);
  out[i] = acc;
}

}  // namespace

extern "C" int ogt_widen_packed(const void* raw, long long cnt, int width,
                                void* out, void* stream) {
  if (cnt <= 0) return 0;
  const long long blocks = (cnt + kThreads - 1) / kThreads;
  auto s = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint8_t*>(raw);
  auto o = static_cast<int32_t*>(out);
  if (width == 1) {
    widen_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(in, cnt, o);
  } else if (width == 2) {
    widen_kernel<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(in, cnt, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bit unpack: `nbytes` bytes -> nbytes*8 int32 bits, most significant
// bit of each byte first (np.unpackbits order, the gorilla stream's bit
// order): out[8*b + k] = (raw[b] >> (7 - k)) & 1.
//
// Replaces the TPU kernel opengemini_tpu/ops/pallas_segment.py
// unpack_bits -> _unpack_bits_call -> _unpack_bits_kernel, the
// bit-addressing substrate of the device-side gorilla decode
// (ops/device_decode.py _unpack_bits / _gorilla_piece).
//
// Bound on the card: bytes. It reads nbytes and writes 32*nbytes, so the
// writes are 97% of the traffic. Design: one thread per output bit;
// neighbouring threads write neighbouring words (coalesced stores), and
// the eight threads of one byte read the same address, which the L1
// serves once.
#include "ogt_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
unpack_bits_kernel(const uint8_t* __restrict__ raw, long long nbits,
                   int32_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nbits) return;
  out[i] = (raw[i >> 3] >> (7 - static_cast<int>(i & 7))) & 1;
}

}  // namespace

extern "C" int ogt_unpack_bits(const void* raw, long long nbytes, void* out,
                               void* stream) {
  if (nbytes <= 0) return 0;
  const long long nbits = nbytes * 8;
  const long long blocks = (nbits + kThreads - 1) / kThreads;
  unpack_bits_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), nbits, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Segmented bit unpack: a table of up to kMaxSegments byte segments
// (src_byte_off, nbytes) of one payload -> the concatenation, in table
// order, of each segment's bits as int32, most significant bit of each
// byte first (np.unpackbits order, the gorilla stream's bit order):
// segment r's byte b lands at out[8*(P_r + b) + k] = (raw[src_r + b] >>
// (7 - k)) & 1, P_r the bytes of the segments before r. One segment is
// the single-block unpack_bits.
//
// Replaces the TPU kernel opengemini_tpu/ops/pallas_segment.py
// unpack_bits -> _unpack_bits_call -> _unpack_bits_kernel, the
// bit-addressing substrate of the device-side gorilla decode
// (ops/device_decode.py _gorilla_chunk), which now unpacks a chunk of
// whole gorilla blocks in one launch instead of one launch per block.
//
// Bound on the card: bytes. It reads nbytes and writes 32*nbytes, so the
// writes are 97% of the traffic; there is no reuse and no arithmetic
// worth a tensor core, so TMA, wgmma and cp.async staging buy nothing.
// Design:
//  - the whole segment table travels as one __grid_constant__ kernel
//    parameter (about 7 KB at 256 rows, 0.2 KB in the form for up to 8
//    rows; sm_90 with CUDA >= 12.1 takes up to 32 KB of parameters): no
//    device allocation, no copy and no synchronisation for it;
//  - each segment is cut into tiles of kTileBytes input bytes; a CTA
//    finds its tile's segment by a binary search over the tile prefix
//    (at most 8 steps, uniform across the CTA, so every read is a
//    broadcast from the constant bank), and a grid sized from the SM
//    count strides over the tiles;
//  - one thread per 4 output bits (half a byte): neighbouring threads
//    make neighbouring 16-byte int4 stores, so each store instruction of
//    a warp writes 512 contiguous bytes (whole sectors), and a warp's
//    loads are 16 neighbouring bytes. Every segment's output offset is a
//    multiple of 8 int32 (32 B), so the stores stay aligned when the
//    output's base is (the wrapper checks 16 B).
#include "ogt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 4;
constexpr int kTileBytes = kThreads * kBytesPerThread;
constexpr int kMaxSegments = 256;
constexpr int kSmallSegments = 8;  // a C1 chunk; one block
constexpr int kCtasPerSm = 8;      // 8 x 256 threads: a full SM

// kCap rows: the launch's parameters carry the whole table, so a small
// table takes the small form (the driver copies fewer bytes per launch)
template <int kCap>
struct UnpackTable {
  int nseg;
  int total_tiles;
  int tile0[kCap + 1];     // first tile of each segment; [nseg] = total
  long long src[kCap];     // first input byte of each segment
  long long out[kCap];     // first output bit (a multiple of 8)
  long long nbytes[kCap];
};

template <int kCap>
__global__ void __launch_bounds__(kThreads)
unpack_bits_kernel(const uint8_t* __restrict__ raw, int32_t* __restrict__ out,
                   const __grid_constant__ UnpackTable<kCap> t) {
  for (int tile = blockIdx.x; tile < t.total_tiles; tile += gridDim.x) {
    const int r = ogt::find_segment(t.tile0, t.nseg, tile);
    // int4 (4 bits) q of the segment: byte q / 2, its high half first
    const long long q0 = 2LL * (tile - t.tile0[r]) * kTileBytes;
    const long long nq = 2 * t.nbytes[r];
    const uint8_t* src = raw + t.src[r];
    int4* dst = reinterpret_cast<int4*>(out + t.out[r]);
#pragma unroll
    for (int k = 0; k < 2 * kBytesPerThread; ++k) {
      const long long q = q0 + k * kThreads + threadIdx.x;
      if (q < nq) {
        const int v = __ldg(src + (q >> 1)) >> ((q & 1) ? 0 : 4);
        dst[q] = make_int4((v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1, v & 1);
      }
    }
  }
}

template <int kCap>
int launch(const void* raw, const long long* table, int nseg, void* out,
           cudaStream_t stream) {
  UnpackTable<kCap> t{};
  t.nseg = nseg;
  long long tiles = 0, pos = 0;
  for (int r = 0; r < nseg; ++r) {
    const long long src = table[2 * r], nb = table[2 * r + 1];
    if (src < 0 || nb < 0) return static_cast<int>(cudaErrorInvalidValue);
    t.tile0[r] = static_cast<int>(tiles);
    t.src[r] = src;
    t.out[r] = 8 * pos;
    t.nbytes[r] = nb;
    tiles += (nb + kTileBytes - 1) / kTileBytes;
    pos += nb;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.tile0[nseg] = static_cast<int>(tiles);
  t.total_tiles = static_cast<int>(tiles);
  if (tiles == 0) return 0;
  const long long grid = ogt::capped_grid(tiles, kCtasPerSm);
  if (grid < 0) return static_cast<int>(-grid);
  unpack_bits_kernel<kCap><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(raw), static_cast<int32_t*>(out), t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `table` is a host array of nseg rows (src_byte_off, nbytes), int64.
extern "C" int ogt_unpack_bits_segments(const void* raw, const long long* table,
                                        int nseg, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (nseg >= 0 && nseg <= kSmallSegments) {
    return launch<kSmallSegments>(raw, table, nseg, out, s);
  }
  if (nseg <= kMaxSegments) return launch<kMaxSegments>(raw, table, nseg, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

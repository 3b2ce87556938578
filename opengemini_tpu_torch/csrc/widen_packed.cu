// Segmented packed little-endian widen: a table of up to kMaxSegments
// segments (src_byte_off, cnt, width) of one payload, width 1 or 2 per
// segment -> the concatenation, in table order, of each segment's `cnt`
// unsigned values as int32: segment r's value i lands at
// out[P_r + i] = sum_j raw[src_r + i*width_r + j] << (8*j), P_r the
// values of the segments before r. One segment is the single-block
// widen_packed.
//
// Replaces the TPU kernel opengemini_tpu/ops/pallas_segment.py
// widen_packed -> _widen_call -> _widen_kernel, the byte-combine step of
// the device-side FOR-delta and dictionary-index decode
// (ops/device_decode.py _widen_group), which now widens every width-1/2
// block of a plan in one launch instead of one launch per block. int32
// is exact for widths 1 and 2.
//
// Bound on the card: bytes. It reads width bytes and writes 4 for each
// value, with one shift-or per byte; there is no reuse and no arithmetic
// worth a tensor core, so TMA, wgmma and cp.async staging buy nothing.
// Design:
//  - the whole segment table travels as one __grid_constant__ kernel
//    parameter (about 8 KB at 256 rows, 0.3 KB in the form for up to 8
//    rows; sm_90 with CUDA >= 12.1 takes up to 32 KB of parameters): no
//    device allocation, no copy and no synchronisation for it;
//  - one thread per group of 4 outputs whose first global index is a
//    multiple of 4: a group wholly inside its segment is one aligned
//    16-byte int4 store, the (at most two) groups that a segment's ends
//    cut store their values one by one; a warp writes 512 neighbouring
//    bytes per store and reads 128*width neighbouring bytes, as the
//    aligned 32-bit words that hold them (a funnel shift takes the
//    group's bytes out of two or three words at any source offset; only
//    words inside the segment are read, so a group at a segment's edge
//    may take byte loads instead);
//  - each segment's groups are cut into tiles of kTileGroups; a CTA
//    finds its tile's segment by a binary search over the tile prefix
//    (at most 8 steps, uniform across the CTA: constant-bank
//    broadcasts), and a grid sized from the SM count strides over the
//    tiles. Width is a per-segment runtime value: one plan may mix them.
#include "ogt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroupsPerThread = 4;
constexpr int kTileGroups = kThreads * kGroupsPerThread;
constexpr int kMaxSegments = 256;
constexpr int kSmallSegments = 8;  // one block, or a few
constexpr int kCtasPerSm = 8;

// kCap rows: the launch's parameters carry the whole table, so a small
// table takes the small form (the driver copies fewer bytes per launch)
template <int kCap>
struct WidenTable {
  int nseg;
  int total_tiles;
  int tile0[kCap + 1];       // first tile of each segment; [nseg] = total
  int width[kCap];
  long long src[kCap];       // first input byte of each segment
  long long out[kCap];       // first output value of each segment
  long long cnt[kCap];
};

__device__ __forceinline__ int32_t widen_one(const uint8_t* p, int w) {
  const int32_t b0 = __ldg(p);
  return w == 1 ? b0 : b0 | (static_cast<int32_t>(__ldg(p + 1)) << 8);
}

// Whether the aligned 32-bit words holding bytes [p, p + n) all lie in
// [begin, end): then they may be read whole.
__device__ __forceinline__ bool words_inside(const uint8_t* p, int n,
                                             const uint8_t* begin, const uint8_t* end) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return (a & ~uintptr_t(3)) >= reinterpret_cast<uintptr_t>(begin) &&
         (((a + n - 1) | uintptr_t(3)) + 1) <= reinterpret_cast<uintptr_t>(end);
}

template <int kCap>
__global__ void __launch_bounds__(kThreads)
widen_kernel(const uint8_t* __restrict__ raw, int32_t* __restrict__ out,
             const __grid_constant__ WidenTable<kCap> t) {
  for (int tile = blockIdx.x; tile < t.total_tiles; tile += gridDim.x) {
    const int r = ogt::find_segment(t.tile0, t.nseg, tile);
    const long long lo = t.out[r], hi = lo + t.cnt[r];
    const long long a0 = lo & ~3LL;
    const long long groups = (((hi + 3) & ~3LL) - a0) >> 2;
    const int w = t.width[r];
    const uint8_t* src = raw + t.src[r];
    const long long q0 = static_cast<long long>(tile - t.tile0[r]) * kTileGroups;
#pragma unroll
    for (int k = 0; k < kGroupsPerThread; ++k) {
      const long long q = q0 + k * kThreads + threadIdx.x;
      if (q >= groups) break;
      const long long e0 = a0 + 4 * q;  // first global output of the group
      const uint8_t* p = src + (e0 - lo) * w;
      if (e0 >= lo && e0 + 4 <= hi && words_inside(p, 4 * w, src, src + t.cnt[r] * w)) {
        // the group's 4*w bytes from the aligned words that hold them
        const unsigned sh = 8u * (reinterpret_cast<uintptr_t>(p) & 3u);
        const uint32_t* wp = reinterpret_cast<const uint32_t*>(
            reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3));
        const uint32_t w0 = __ldg(wp);
        const uint32_t w1 = (sh || w == 2) ? __ldg(wp + 1) : 0u;
        const uint32_t w2 = (sh && w == 2) ? __ldg(wp + 2) : 0u;
        const uint32_t x = __funnelshift_r(w0, w1, sh);
        const uint32_t y = __funnelshift_r(w1, w2, sh);
        *reinterpret_cast<int4*>(out + e0) =
            w == 1 ? make_int4(x & 0xff, (x >> 8) & 0xff, (x >> 16) & 0xff, x >> 24)
                   : make_int4(x & 0xffff, x >> 16, y & 0xffff, y >> 16);
      } else if (e0 >= lo && e0 + 4 <= hi) {
        *reinterpret_cast<int4*>(out + e0) = make_int4(
            widen_one(p, w), widen_one(p + w, w), widen_one(p + 2 * w, w),
            widen_one(p + 3 * w, w));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long e = e0 + j;
          if (e >= lo && e < hi) out[e] = widen_one(src + (e - lo) * w, w);
        }
      }
    }
  }
}

template <int kCap>
int launch(const void* raw, const long long* table, int nseg, void* out,
           cudaStream_t stream) {
  WidenTable<kCap> t{};
  t.nseg = nseg;
  long long tiles = 0, pos = 0;
  for (int r = 0; r < nseg; ++r) {
    const long long src = table[3 * r], cnt = table[3 * r + 1], w = table[3 * r + 2];
    if (src < 0 || cnt < 0 || (w != 1 && w != 2)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long a0 = pos & ~3LL;
    const long long groups = cnt ? (((pos + cnt + 3) & ~3LL) - a0) >> 2 : 0;
    t.tile0[r] = static_cast<int>(tiles);
    t.width[r] = static_cast<int>(w);
    t.src[r] = src;
    t.out[r] = pos;
    t.cnt[r] = cnt;
    tiles += (groups + kTileGroups - 1) / kTileGroups;
    pos += cnt;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.tile0[nseg] = static_cast<int>(tiles);
  t.total_tiles = static_cast<int>(tiles);
  if (tiles == 0) return 0;
  const long long grid = ogt::capped_grid(tiles, kCtasPerSm);
  if (grid < 0) return static_cast<int>(-grid);
  widen_kernel<kCap><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(raw), static_cast<int32_t*>(out), t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `table` is a host array of nseg rows (src_byte_off, cnt, width), int64.
extern "C" int ogt_widen_packed_segments(const void* raw, const long long* table,
                                         int nseg, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (nseg >= 0 && nseg <= kSmallSegments) {
    return launch<kSmallSegments>(raw, table, nseg, out, s);
  }
  if (nseg <= kMaxSegments) return launch<kMaxSegments>(raw, table, nseg, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

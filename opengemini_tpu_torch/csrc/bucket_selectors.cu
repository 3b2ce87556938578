// Bucket-row selectors: per row of a (G, W) bucket matrix, the values of
// the first and last points and the sample indices (`idx`) of the
// first, last, min and max points.
//
// Replaces the TPU kernel opengemini_tpu/ops/pallas_segment.py
// bucket_stats_selectors -> _bucket_sel_call -> _sel_kernel (_lex_col,
// _first_last_col), which models/ragged.py BucketedBatch runs for
// first/last/min/max without time grouping.
//
// Order rules (the same as the TPU kernel and the XLA oracle in
// models/ragged.py):
//   time is the int32 pair (hi, lo) with 0 <= lo < 2^30, reduced here as
//   the int64 key hi * 2^30 + lo, which orders exactly as (hi, lo);
//   first/last take the extreme key, an exact time tie takes the larger
//   value, then the lowest column; a NaN among the tied values leaves the
//   row without a pick (the TPU kernel's max/== then finds no column);
//   min/max take, among the lanes equal to the row's NaN-propagating
//   min/max, the earliest key, then the lowest column;
//   a row without a pick selects column W-1 (the TPU kernel's clip).
//
// Bound on the card: bytes. Inputs G*W*(sizeof(T)+4+4+4+1) are read once
// from device memory; outputs are G*(2*sizeof(T)+16). Design: one warp per
// row; each lane scans its strided columns in increasing order and keeps
// a running pick, then warp shuffles merge the picks. Two passes: the
// first finds min, max, first and last; the second, which needs the row
// min and max, picks the min and max columns. The second pass re-reads a
// row the warp just touched, from L1/L2.
#include "ogt_common.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr long long kKeyMax = LLONG_MAX;  // keys are < 2^61 in magnitude
constexpr long long kKeyMin = LLONG_MIN;

__device__ __forceinline__ long long time_key(int hi, int lo) {
  return static_cast<long long>(hi) * (1LL << 30) + static_cast<long long>(lo);
}

// Pick of first/last: extreme key, then larger value, then lower column.
template <typename T>
struct TimePick {
  long long k;
  T v;
  int c;
  int nan;  // a NaN value sits among the lanes tied at key k
};

template <typename T, bool kLatest>
__device__ __forceinline__ void merge_time(TimePick<T>& a, const TimePick<T>& b) {
  const bool better = kLatest ? (b.k > a.k) : (b.k < a.k);
  if (better) {
    a = b;
  } else if (b.k == a.k) {
    a.nan |= b.nan;
    if (b.v > a.v) {
      a.v = b.v;
      a.c = b.c;
    } else if (b.v == a.v && b.c < a.c) {
      a.c = b.c;
    }
  }
}

template <typename T, bool kLatest>
__device__ __forceinline__ void warp_merge_time(TimePick<T>& a) {
  for (int o = 16; o > 0; o >>= 1) {
    TimePick<T> b;
    b.k = __shfl_xor_sync(ogt::kFullMask, a.k, o);
    b.v = __shfl_xor_sync(ogt::kFullMask, a.v, o);
    b.c = __shfl_xor_sync(ogt::kFullMask, a.c, o);
    b.nan = __shfl_xor_sync(ogt::kFullMask, a.nan, o);
    merge_time<T, kLatest>(a, b);
  }
}

// Pick of min/max: earliest key, then lower column.
struct KeyPick {
  long long k;
  int c;
};

__device__ __forceinline__ void merge_key(KeyPick& a, const KeyPick& b) {
  if (b.k < a.k || (b.k == a.k && b.c < a.c)) a = b;
}

__device__ __forceinline__ void warp_merge_key(KeyPick& a) {
  for (int o = 16; o > 0; o >>= 1) {
    KeyPick b;
    b.k = __shfl_xor_sync(ogt::kFullMask, a.k, o);
    b.c = __shfl_xor_sync(ogt::kFullMask, a.c, o);
    merge_key(a, b);
  }
}

template <typename T>
__device__ __forceinline__ int time_col(const TimePick<T>& p, long long empty, int W) {
  return (p.k == empty || p.nan) ? W - 1 : p.c;
}

__device__ __forceinline__ int key_col(const KeyPick& p, int W) {
  return p.k == kKeyMax ? W - 1 : p.c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bucket_selectors_kernel(const T* __restrict__ v, const int* __restrict__ hi,
                        const int* __restrict__ lo, const int* __restrict__ idx,
                        const uint8_t* __restrict__ m, int64_t G, int W,
                        T* __restrict__ first_out, T* __restrict__ last_out,
                        int* __restrict__ sel_first, int* __restrict__ sel_last,
                        int* __restrict__ sel_min, int* __restrict__ sel_max) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= G) return;  // uniform across the warp: shuffles stay full-mask
  const int64_t base = row * W;

  T mn = ogt::pos_inf<T>();
  T mx = -ogt::pos_inf<T>();
  TimePick<T> pf{kKeyMax, T(0), INT_MAX, 0};
  TimePick<T> pl{kKeyMin, T(0), INT_MAX, 0};
  for (int j = lane; j < W; j += 32) {
    if (!m[base + j]) continue;
    const T x = v[base + j];
    const long long k = time_key(hi[base + j], lo[base + j]);
    mn = ogt::nan_min(mn, x);
    mx = ogt::nan_max(mx, x);
    const TimePick<T> e{k, x, j, x != x ? 1 : 0};
    merge_time<T, false>(pf, e);
    merge_time<T, true>(pl, e);
  }
  mn = ogt::warp_nan_min(mn);
  mx = ogt::warp_nan_max(mx);
  warp_merge_time<T, false>(pf);
  warp_merge_time<T, true>(pl);

  KeyPick pmin{kKeyMax, INT_MAX};
  KeyPick pmax{kKeyMax, INT_MAX};
  for (int j = lane; j < W; j += 32) {
    if (!m[base + j]) continue;
    const T x = v[base + j];
    if (x != mn && x != mx) continue;
    const KeyPick e{time_key(hi[base + j], lo[base + j]), j};
    if (x == mn) merge_key(pmin, e);
    if (x == mx) merge_key(pmax, e);
  }
  warp_merge_key(pmin);
  warp_merge_key(pmax);

  if (lane == 0) {
    const int cf = time_col(pf, kKeyMax, W);
    const int cl = time_col(pl, kKeyMin, W);
    first_out[row] = v[base + cf];
    last_out[row] = v[base + cl];
    sel_first[row] = idx[base + cf];
    sel_last[row] = idx[base + cl];
    sel_min[row] = idx[base + key_col(pmin, W)];
    sel_max[row] = idx[base + key_col(pmax, W)];
  }
}

template <typename T>
int launch(const void* v, const void* hi, const void* lo, const void* idx,
           const void* m, long long G, int W, void* first, void* last,
           void* sf, void* sl, void* smin, void* smax, void* stream) {
  if (G <= 0) return 0;
  const long long blocks = (G + kRowsPerBlock - 1) / kRowsPerBlock;
  bucket_selectors_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const int*>(hi),
      static_cast<const int*>(lo), static_cast<const int*>(idx),
      static_cast<const uint8_t*>(m), G, W, static_cast<T*>(first),
      static_cast<T*>(last), static_cast<int*>(sf), static_cast<int*>(sl),
      static_cast<int*>(smin), static_cast<int*>(smax));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ogt_bucket_selectors_f32(const void* v, const void* hi,
                                        const void* lo, const void* idx,
                                        const void* m, long long G, int W,
                                        void* first, void* last, void* sf,
                                        void* sl, void* smin, void* smax,
                                        void* stream) {
  return launch<float>(v, hi, lo, idx, m, G, W, first, last, sf, sl, smin,
                       smax, stream);
}

extern "C" int ogt_bucket_selectors_f64(const void* v, const void* hi,
                                        const void* lo, const void* idx,
                                        const void* m, long long G, int W,
                                        void* first, void* last, void* sf,
                                        void* sl, void* smin, void* smax,
                                        void* stream) {
  return launch<double>(v, hi, lo, idx, m, G, W, first, last, sf, sl, smin,
                        smax, stream);
}

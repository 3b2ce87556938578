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
// One pass. The TPU kernel (and this kernel's first form) needs the row's
// min and max before it can pick their columns: two passes. Here each
// lane keeps, beside the first/last picks, a min pick and a max pick
// (value, key, column, NaN seen), merged as: a NaN among the masked-in
// values marks the pick (the row then selects W-1); otherwise the smaller
// (for max the larger) value wins; an equal value (==, so -0.0 equals
// 0.0) takes the earlier key, then the lower column. The pick starts at
// (+inf for min, -inf for max; key kKeyMax; no column) and a row whose
// key is still kKeyMax at the end selects W-1. Why this equals the two
// passes: without a NaN, the order (value under ==, key, column) is a
// total preorder, the merge keeps its least element and is associative
// and commutative, so any lane split and merge tree ends at the least
// masked-in element: the lowest (key, column) among the elements equal
// to the row's min, which is the two passes' pick. A masked-in +inf (for
// max -inf) equals the start value but carries a key below kKeyMax, so
// it replaces the start, as the two passes pick it (v == mn holds there).
// An empty row keeps kKeyMax: W-1. With a NaN the two passes' min is NaN,
// no lane equals it: W-1, as the NaN mark gives. The CPU tests hold a
// numpy model of this merge, lane split and shuffle tree included, to
// the plain version (tests/test_torch_kernels.py).
//
// Bound on the card: bytes. Inputs G*W*(sizeof(T)+4+4+4+1) are read once
// from device memory (idx only at the picked columns); outputs are
// G*(2*sizeof(T)+16). Design: P lanes of a warp per row, each lane taking
// V = 4 adjacent columns (a group) a step: values as one or two 16-B
// loads, hi and lo as 16 B each, the mask as one 32-bit word (V = 1 where
// W is no multiple of 4 or a pointer is not aligned). P is the largest
// power of two <= 32 that leaves a lane kGroupsPerLane groups: W = 1024
// gives 32 lanes, W = 256 8 lanes (4 rows a warp), W <= 32 one lane a
// row, so the shuffle tree and the picked-column reads, a fixed cost per
// row, stay small beside the fold. Steps go in batches of kBatch: the
// batch's mask words first, then the vectors of the words that are not
// zero (an empty group of a prefix row's tail or a padded row costs no
// value or time bytes), all in flight before any is used; streaming
// loads. A lane folds its columns in increasing order; xor shuffles
// within the row's P lanes merge the picks; lane 0 of the row then reads
// v and idx at the picked columns (six independent loads) and writes the
// six outputs. The fold is a few dozen instructions an element and the
// loads wait on the mask words, so the kernel needs many warps in
// flight: 128-thread CTAs, six an SM (the register cap that gives).
#include "ogt_common.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCtasPerSm = 6;  // 768 threads an SM: at most 85 registers
constexpr int kBatch = 2;  // a lane's column groups whose loads fly together
constexpr int kGroupsPerLane = 8;  // fewest column groups a lane of a row takes
constexpr long long kKeyMax = LLONG_MAX;  // keys are < 2^61 in magnitude
constexpr long long kKeyMin = LLONG_MIN;

__device__ __forceinline__ long long time_key(int hi, int lo) {
  return static_cast<long long>(hi) * (1LL << 30) + static_cast<long long>(lo);
}

// A pick: the value and key of the picked element, its column, and
// whether a NaN was seen among the elements it was chosen from.
template <typename T>
struct Pick {
  T v;
  long long k;
  int c;
  int nan;
};

// first/last: extreme key, then larger value, then lower column; a NaN
// among the elements tied at the extreme key marks the pick.
template <typename T, bool kLatest>
__device__ __forceinline__ void merge_time(Pick<T>& a, const Pick<T>& b) {
  const bool better = kLatest ? (b.k > a.k) : (b.k < a.k);
  if (better) {
    a = b;
  } else if (b.k == a.k) {
    a.nan |= b.nan;
    if (b.v > a.v || (b.v == a.v && b.c < a.c)) {
      a.v = b.v;
      a.c = b.c;
    }
  }
}

// min/max: a NaN anywhere marks the pick; else the smaller (larger)
// value, then the earlier key, then the lower column.
template <typename T, bool kMax>
__device__ __forceinline__ void merge_value(Pick<T>& a, const Pick<T>& b) {
  a.nan |= b.nan;
  const bool better = kMax ? (b.v > a.v) : (b.v < a.v);
  if (better || (b.v == a.v && (b.k < a.k || (b.k == a.k && b.c < a.c)))) {
    a.v = b.v;
    a.k = b.k;
    a.c = b.c;
  }
}

template <typename T>
__device__ __forceinline__ Pick<T> shfl_xor(const Pick<T>& a, int o) {
  Pick<T> b;
  b.v = __shfl_xor_sync(ogt::kFullMask, a.v, o);
  b.k = __shfl_xor_sync(ogt::kFullMask, a.k, o);
  b.c = __shfl_xor_sync(ogt::kFullMask, a.c, o);
  b.nan = __shfl_xor_sync(ogt::kFullMask, a.nan, o);
  return b;
}

// The four picks of a lane, and the fold of one masked-in element.
template <typename T>
struct Picks {
  Pick<T> first, last, mn, mx;

  __device__ __forceinline__ void init() {
    first = Pick<T>{T(0), kKeyMax, INT_MAX, 0};
    last = Pick<T>{T(0), kKeyMin, INT_MAX, 0};
    mn = Pick<T>{ogt::pos_inf<T>(), kKeyMax, INT_MAX, 0};
    mx = Pick<T>{-ogt::pos_inf<T>(), kKeyMax, INT_MAX, 0};
  }

  // A lane's columns come in increasing order, so a tie at an equal
  // key or value keeps the pick's (lower) column.
  __device__ __forceinline__ void fold(T x, int hi, int lo, int col) {
    const long long k = time_key(hi, lo);
    const int nan = x != x ? 1 : 0;
    if (k < first.k) {
      first = Pick<T>{x, k, col, nan};
    } else if (k == first.k) {
      first.nan |= nan;
      if (x > first.v) {
        first.v = x;
        first.c = col;
      }
    }
    if (k > last.k) {
      last = Pick<T>{x, k, col, nan};
    } else if (k == last.k) {
      last.nan |= nan;
      if (x > last.v) {
        last.v = x;
        last.c = col;
      }
    }
    mn.nan |= nan;
    if (x < mn.v || (x == mn.v && k < mn.k)) mn = Pick<T>{x, k, col, mn.nan};
    mx.nan |= nan;
    if (x > mx.v || (x == mx.v && k < mx.k)) mx = Pick<T>{x, k, col, mx.nan};
  }

  // xor shuffles within aligned groups of P lanes (a power of two)
  __device__ __forceinline__ void merge_lanes(int P) {
    for (int o = P >> 1; o > 0; o >>= 1) {
      merge_time<T, false>(first, shfl_xor(first, o));
      merge_time<T, true>(last, shfl_xor(last, o));
      merge_value<T, false>(mn, shfl_xor(mn, o));
      merge_value<T, true>(mx, shfl_xor(mx, o));
    }
  }
};

template <int V> struct Group;
template <> struct Group<1> { using Word = unsigned char; };
template <> struct Group<4> { using Word = unsigned int; };

template <typename T>
__device__ __forceinline__ void load_vals(const T* p, T (&x)[1]) {
  x[0] = __ldcs(p);
}
__device__ __forceinline__ void load_vals(const double* p, double (&x)[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}
__device__ __forceinline__ void load_vals(const float* p, float (&x)[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}
__device__ __forceinline__ void load_ints(const int* p, int (&x)[1]) {
  x[0] = __ldcs(p);
}
__device__ __forceinline__ void load_ints(const int* p, int (&x)[4]) {
  const int4 a = __ldcs(reinterpret_cast<const int4*>(p));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}

template <typename T>
struct SelOuts {
  T* first;
  T* last;
  int* sel_first;
  int* sel_last;
  int* sel_min;
  int* sel_max;
};

template <typename T>
__device__ __forceinline__ int time_col(const Pick<T>& p, long long empty,
                                        int W) {
  return (p.k == empty || p.nan) ? W - 1 : p.c;
}

template <typename T>
__device__ __forceinline__ int value_col(const Pick<T>& p, int W) {
  return (p.k == kKeyMax || p.nan) ? W - 1 : p.c;
}

// Rows of P lanes (P a power of two <= 32); lane q of a row takes column
// groups q, q + P, ... of V columns each.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
bucket_selectors_kernel(const T* __restrict__ v, const int* __restrict__ hi,
                        const int* __restrict__ lo, const int* __restrict__ idx,
                        const uint8_t* __restrict__ m, int64_t G, int W, int P,
                        SelOuts<T> out) {
  using Word = typename Group<V>::Word;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = t / P;
  const int q = static_cast<int>(t - row * P);
  const bool live = row < G;  // dead lanes still join the shuffles
  const int64_t base = (live ? row : 0) * W;
  const int groups = W / V;

  Picks<T> p;
  p.init();
  for (int g0 = q; g0 < groups; g0 += P * kBatch) {
    Word w[kBatch];
    T x[kBatch][V];
    int h[kBatch][V], l[kBatch][V];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int g = g0 + u * P;
      w[u] = (live && g < groups)
                 ? __ldcs(reinterpret_cast<const Word*>(m + base) + g)
                 : Word(0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (w[u]) {
        const int64_t c = base + static_cast<int64_t>(g0 + u * P) * V;
        load_vals(v + c, x[u]);
        load_ints(hi + c, h[u]);
        load_ints(lo + c, l[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!w[u]) continue;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if ((w[u] >> (8 * j)) & 0xffu)
          p.fold(x[u][j], h[u][j], l[u][j], (g0 + u * P) * V + j);
      }
    }
  }
  p.merge_lanes(P);
  if (!live || q != 0) return;

  // lane 0 of the row: six independent loads at the picked columns
  const int cf = time_col(p.first, kKeyMax, W);
  const int cl = time_col(p.last, kKeyMin, W);
  const int cmin = value_col(p.mn, W);
  const int cmax = value_col(p.mx, W);
  const T vf = v[base + cf], vl = v[base + cl];
  const int sf = idx[base + cf], sl = idx[base + cl];
  const int smin = idx[base + cmin], smax = idx[base + cmax];
  out.first[row] = vf;
  out.last[row] = vl;
  out.sel_first[row] = sf;
  out.sel_last[row] = sl;
  out.sel_min[row] = smin;
  out.sel_max[row] = smax;
}

template <typename T, int V>
int launch_v(const T* v, const int* hi, const int* lo, const int* idx,
             const uint8_t* m, long long G, int W, const SelOuts<T>& out,
             cudaStream_t stream) {
  // lanes per row: the largest power of two <= 32 that leaves each lane
  // kGroupsPerLane column groups (at least one lane)
  int P = 1;
  while (2 * P <= 32 && 2 * P * kGroupsPerLane <= W / V) P *= 2;
  const long long threads = G * P;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  bucket_selectors_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(v, hi, lo, idx, m, G, W, P, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* v, const void* hi, const void* lo, const void* idx,
           const void* m, long long G, int W, void* first, void* last,
           void* sf, void* sl, void* smin, void* smax, void* stream) {
  if (G <= 0 || W <= 0) return 0;
  const SelOuts<T> out{static_cast<T*>(first), static_cast<T*>(last),
                       static_cast<int*>(sf),  static_cast<int*>(sl),
                       static_cast<int*>(smin), static_cast<int*>(smax)};
  const bool vec = W % 4 == 0 && ogt::aligned(v, 16) &&
                   ogt::aligned(hi, 16) && ogt::aligned(lo, 16) &&
                   ogt::aligned(m, 4);
  const auto st = static_cast<cudaStream_t>(stream);
  const T* vt = static_cast<const T*>(v);
  const int* ht = static_cast<const int*>(hi);
  const int* lt = static_cast<const int*>(lo);
  const int* it = static_cast<const int*>(idx);
  const uint8_t* mt = static_cast<const uint8_t*>(m);
  return vec ? launch_v<T, 4>(vt, ht, lt, it, mt, G, W, out, st)
             : launch_v<T, 1>(vt, ht, lt, it, mt, G, W, out, st);
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

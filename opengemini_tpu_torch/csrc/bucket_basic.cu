// Bucket-row basic statistics: per row of a (G, W) bucket matrix, the
// count, sum, mean = sum / max(count, 1), min (+inf when empty) and max
// (-inf when empty), both NaN-propagating, and the sum of squared
// deviations ssd = sum over the masked-in values of (x - mean)^2.
//
// Replaces the TPU kernel opengemini_tpu/ops/pallas_segment.py
// bucket_stats_basic -> _bucket_basic_call -> _basic_kernel, which
// models/ragged.py BucketedBatch runs for every bucket of a GROUP BY
// tags (no time grouping) aggregate.
//
// Bound on the card: bytes. The mask (G*W bytes) and the masked-in
// values are read once from device memory, the outputs G*(4+5*sizeof(T))
// written once; a handful of flops per element.
//
// Why the ssd takes two passes. The TPU kernel and the plain version take
// the mean in the data type first, then sum (x - mean)^2 over the row.
// A one-pass form rounds differently: a shifted sum of squares,
// sum (x-K)^2 - (sum (x-K))^2 / n, loses the digits of the row's spread
// when its mean lies far from K (counters near 1e9 or epoch-like gauges
// leave nothing of rtol 1e-10 at K = 0), and Welford or Chan merges
// round at other places than the reference. So the kernel keeps the
// two-pass formula but reads device memory once: each lane holds the
// values it loaded in registers through the mean's reduction and folds
// the deviations from them.
//
// Design. P lanes of a warp take a row (P a power of two <= 32, rows
// aligned within the warp, several rows a warp at narrow widths), lane q
// taking column groups q, q + P, ... of V adjacent columns: V = 4 where W
// is a multiple of 4 and the pointers are aligned (values as one float4
// or two double2 loads, the mask as one 32-bit word), else V = 1 (the
// scalar path). P is the smallest power of two that leaves each lane at
// most kHeld / V groups, i.e. kHeld = 32 values: W = 1024 gives 32 lanes,
// 256 eight lanes (4 rows a warp), 64 two, 16 one; every width of the
// bucket ladder (models/ragged.py WIDTHS) and any W <= 1024 fits. A lane
// loads all its mask words first, then the value vectors of the words
// that are not zero (the empty tail of a prefix row and a padded row cost
// mask bytes only), all in flight at once, streaming (ld.global.cs). It
// folds count, sum, min and max in column order; xor shuffles within the
// row's P lanes reduce them (every lane ends with the same bits); then the
// lane folds (x - mean)^2 from its registers and a second shuffle tree
// sums the ssd. Registers, not shared memory: 32 values a lane are 64
// registers in f64; 128-thread CTAs, five an SM on the vector path (96
// registers in f64, no spills: 20 warps an SM, each with up to 8 KB of
// loads in flight) and four on the scalar path (at most 128 registers;
// with five its 32 one-byte mask words spill), as nvcc -Xptxas -v shows.
// Five beat four and six (which spills) on the vector path in a timing
// on the H100, most where the mask leaves rows empty. A wider row (W >
// 1024, which the ladder never produces) takes the same fold in batches
// of kHeld values and reads the row a second time for the deviations:
// right, not fast.
//
// Sums are taken in another order than the plain version's: sum, mean and
// ssd agree within rounding, count/min/max exactly. A masked-in +-inf
// makes the mean +-inf or NaN and the ssd NaN, as in the plain version.
// The CPU tests hold a numpy model of this order of additions (lanes from
// W, V columns a step, both shuffle trees) to the plain version
// (tests/test_torch_kernels.py).
#include "ogt_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHeld = 32;  // values a lane holds in registers

// CTAs an SM: at most 102 registers a thread on the vector path, 128 on
// the scalar path
constexpr int ctas_per_sm(int V) { return V == 4 ? 5 : 4; }

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

// xor shuffles within aligned groups of P lanes (a power of two)
template <typename T>
__device__ __forceinline__ T lanes_sum(T x, int P) {
  for (int o = P >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(ogt::kFullMask, x, o);
  return x;
}

template <typename T>
struct Outs {
  int* cnt;
  T* sum;
  T* mean;
  T* mn;
  T* mx;
  T* ssd;
};

// One batch of a lane's column groups: the groups g0, g0 + P, ... (kB of
// them, those below `groups`) of the row at vr/mr, mask words first, then
// the value vectors of the words that are not zero.
template <typename T, int V, int kB>
struct Batch {
  using Word = typename Group<V>::Word;
  Word w[kB];
  T x[kB][V];

  __device__ __forceinline__ void load(const T* vr, const uint8_t* mr,
                                       int g0, int P, int groups, bool live) {
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int g = g0 + u * P;
      w[u] = (live && g < groups) ? __ldcs(reinterpret_cast<const Word*>(mr) + g)
                                  : Word(0);
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (w[u]) {
        load_vals(vr + static_cast<int64_t>(g0 + u * P) * V, x[u]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) x[u][j] = T(0);
      }
    }
  }

  static __device__ __forceinline__ bool on(Word w, int j) {
    return (w >> (8 * j)) & 0xffu;
  }

  __device__ __forceinline__ void fold(int& c, T& s, T& mn, T& mx) const {
#pragma unroll
    for (int u = 0; u < kB; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const bool in = on(w[u], j);
        c += in ? 1 : 0;
        s += in ? x[u][j] : T(0);
        mn = in ? ogt::nan_min(mn, x[u][j]) : mn;
        mx = in ? ogt::nan_max(mx, x[u][j]) : mx;
      }
    }
  }

  __device__ __forceinline__ void fold_dev(T mean, T& d2) const {
#pragma unroll
    for (int u = 0; u < kB; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T d = x[u][j] - mean;
        d2 += on(w[u], j) ? d * d : T(0);
      }
    }
  }
};

// Rows of P lanes; lane q of a row takes column groups q, q + P, ... of V
// columns each. kHold: every group of a lane fits one batch (W / V <= P *
// kHeld / V), which stays in registers for the deviations.
template <typename T, int V, bool kHold>
__global__ void __launch_bounds__(kThreads, ctas_per_sm(V))
bucket_basic_kernel(const T* __restrict__ v, const uint8_t* __restrict__ m,
                    int64_t G, int W, int P, Outs<T> out) {
  constexpr int kB = kHeld / V;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = t / P;
  const int q = static_cast<int>(t - row * P);
  const bool live = row < G;  // dead lanes still join the shuffles
  const int64_t base = (live ? row : 0) * W;
  const T* vr = v + base;
  const uint8_t* mr = m + base;
  const int groups = W / V;

  Batch<T, V, kB> b;
  int c = 0;
  T s = T(0);
  T mn = ogt::pos_inf<T>();
  T mx = -ogt::pos_inf<T>();
  if (kHold) {
    b.load(vr, mr, q, P, groups, live);
    b.fold(c, s, mn, mx);
  } else {
    for (int g0 = q; g0 < groups; g0 += P * kB) {
      b.load(vr, mr, g0, P, groups, live);
      b.fold(c, s, mn, mx);
    }
  }
  c = lanes_sum(c, P);
  s = lanes_sum(s, P);
  for (int o = P >> 1; o > 0; o >>= 1) {
    mn = ogt::nan_min(mn, __shfl_xor_sync(ogt::kFullMask, mn, o));
    mx = ogt::nan_max(mx, __shfl_xor_sync(ogt::kFullMask, mx, o));
  }
  const T mean = s / static_cast<T>(c > 1 ? c : 1);

  T d2 = T(0);
  if (kHold) {
    b.fold_dev(mean, d2);
  } else {
    for (int g0 = q; g0 < groups; g0 += P * kB) {
      b.load(vr, mr, g0, P, groups, live);
      b.fold_dev(mean, d2);
    }
  }
  d2 = lanes_sum(d2, P);

  if (live && q == 0) {
    out.cnt[row] = c;
    out.sum[row] = s;
    out.mean[row] = mean;
    out.mn[row] = mn;
    out.mx[row] = mx;
    out.ssd[row] = d2;
  }
}

template <typename T, int V>
int launch_v(const T* v, const uint8_t* m, long long G, int W,
             const Outs<T>& out, cudaStream_t stream) {
  // lanes per row: the smallest power of two <= 32 that leaves each lane
  // at most kHeld / V column groups
  constexpr int kB = kHeld / V;
  const int groups = W / V;
  int P = 1;
  while (P < 32 && static_cast<long long>(P) * kB < groups) P *= 2;
  const bool hold = static_cast<long long>(P) * kB >= groups;
  const long long blocks = (G * P + kThreads - 1) / kThreads;
  if (hold) {
    bucket_basic_kernel<T, V, true><<<static_cast<unsigned>(blocks), kThreads,
                                      0, stream>>>(v, m, G, W, P, out);
  } else {
    bucket_basic_kernel<T, V, false><<<static_cast<unsigned>(blocks), kThreads,
                                       0, stream>>>(v, m, G, W, P, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* v, const void* m, long long G, int W, void* cnt,
           void* sum, void* mean, void* mn, void* mx, void* ssd,
           void* stream) {
  if (G <= 0 || W < 0) return 0;  // W = 0 still writes the empty rows
  const Outs<T> out{static_cast<int*>(cnt), static_cast<T*>(sum),
                    static_cast<T*>(mean), static_cast<T*>(mn),
                    static_cast<T*>(mx),   static_cast<T*>(ssd)};
  const bool vec = W % 4 == 0 && ogt::aligned(v, 16) && ogt::aligned(m, 4);
  const auto st = static_cast<cudaStream_t>(stream);
  const T* vt = static_cast<const T*>(v);
  const uint8_t* mt = static_cast<const uint8_t*>(m);
  return vec ? launch_v<T, 4>(vt, mt, G, W, out, st)
             : launch_v<T, 1>(vt, mt, G, W, out, st);
}

}  // namespace

extern "C" int ogt_bucket_basic_f32(const void* v, const void* m,
                                    long long G, int W, void* cnt, void* sum,
                                    void* mean, void* mn, void* mx, void* ssd,
                                    void* stream) {
  return launch<float>(v, m, G, W, cnt, sum, mean, mn, mx, ssd, stream);
}

extern "C" int ogt_bucket_basic_f64(const void* v, const void* m,
                                    long long G, int W, void* cnt, void* sum,
                                    void* mean, void* mn, void* mx, void* ssd,
                                    void* stream) {
  return launch<double>(v, m, G, W, cnt, sum, mean, mn, mx, ssd, stream);
}

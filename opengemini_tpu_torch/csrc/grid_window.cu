// Regular-grid window aggregation: values and mask of shape (S, K, W)
// (series rows, samples per window, windows) reduce over the K axis to
// per-(series, window) count, sum, mean = sum / max(count, 1), min (+inf
// when empty) and max (-inf when empty).
//
// Replaces the TPU kernel opengemini_tpu/ops/pallas_segment.py
// grid_window_agg_t -> _grid_call -> _grid_kernel, the dense reduce that
// models/grid.py GridBatch runs for GROUP BY time() over stride-regular
// data (ops/segment.grid_window_agg_t is its plain form).
//
// Bound on the card: bytes. The kernel reads S*K*W*(sizeof(T)+1) once and
// writes S*W*(4+4*sizeof(T)), with a few flops per element.
//
// Design. A thread owns V adjacent windows (V = 16 / sizeof(T): one 16-B
// load of values, the V matching mask bytes as one V-byte word) wherever
// W is a multiple of V and the pointers are aligned; otherwise V = 1 (the
// scalar edge path). Loads go in batches of kUnroll rows: the batch's
// mask words first, then the value vectors of the words that are not
// zero (an empty vector of the padded rows and lanes costs no value
// bytes), all in flight before any is used; every load is streaming
// (ld.global.cs), the inputs are read once. Two regimes, chosen from
// (K, W):
//   - column (large W or small K): one thread per (series, V windows),
//     all K rows in series; neighbouring threads take neighbouring
//     vectors, so a warp's loads of one row are contiguous;
//   - split (W / V <= kThreads / 2 and K * W / V >= kThreads: few
//     windows, many rows, e.g. (5680, 360, 16)): one CTA per series at a
//     time, a grid of as many CTAs as the card holds at once striding
//     over the series. The L = W / V vector lanes of a row and R =
//     kThreads / L rows make up the CTA, so at every step the CTA reads
//     a flat run of R * W values; the R partials of each vector lane are
//     then merged in shared memory by a fixed tree (no atomics: two runs
//     give the same bits).
// Sums are taken in another order than the plain version's: sum and mean
// agree within rounding, count/min/max exactly. NaN propagates as
// ogt::nan_min / nan_max do.
#include "ogt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // rows whose loads are in flight together

template <int V> struct MaskWord;
template <> struct MaskWord<1> { using type = unsigned char; };
template <> struct MaskWord<2> { using type = unsigned short; };
template <> struct MaskWord<4> { using type = unsigned int; };

__device__ __forceinline__ void load_vec(const double* p, double (&x)[2]) {
  const double2 d = __ldcs(reinterpret_cast<const double2*>(p));
  x[0] = d.x;
  x[1] = d.y;
}
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&x)[1]) {
  x[0] = __ldcs(p);
}

__device__ __forceinline__ void store_vec(double* p, const double (&x)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(x[0], x[1]));
}
__device__ __forceinline__ void store_vec(float* p, const float (&x)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
}
__device__ __forceinline__ void store_vec(int* p, const int (&x)[2]) {
  __stcs(reinterpret_cast<int2*>(p), make_int2(x[0], x[1]));
}
__device__ __forceinline__ void store_vec(int* p, const int (&x)[4]) {
  __stcs(reinterpret_cast<int4*>(p), make_int4(x[0], x[1], x[2], x[3]));
}
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&x)[1]) {
  __stcs(p, x[0]);
}

template <typename T>
struct Outs {
  int* cnt;
  T* sum;
  T* mean;
  T* mn;
  T* mx;
};

// Running count/sum/min/max of V adjacent windows.
template <typename T, int V>
struct Acc {
  using Word = typename MaskWord<V>::type;
  int c[V];
  T s[V], mn[V], mx[V];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      c[j] = 0;
      s[j] = T(0);
      mn[j] = ogt::pos_inf<T>();
      mx[j] = -ogt::pos_inf<T>();
    }
  }

  __device__ __forceinline__ void add(unsigned word, const T (&x)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool on = (word >> (8 * j)) & 0xffu;
      c[j] += on ? 1 : 0;
      s[j] += on ? x[j] : T(0);
      mn[j] = on ? ogt::nan_min(mn[j], x[j]) : mn[j];
      mx[j] = on ? ogt::nan_max(mx[j], x[j]) : mx[j];
    }
  }

  __device__ __forceinline__ void merge(const Acc& o) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      c[j] += o.c[j];
      s[j] += o.s[j];
      mn[j] = ogt::nan_min(mn[j], o.mn[j]);
      mx[j] = ogt::nan_max(mx[j], o.mx[j]);
    }
  }

  // Rows k0, k0 + kstep, ... (kUnroll of them, those below K) of one
  // vector lane: v and m point at the lane's first window in row 0, rows
  // lie W elements apart.
  __device__ __forceinline__ void batch(const T* v, const uint8_t* m,
                                        int k0, int kstep, int K, int W) {
    Word w[kUnroll];
    T x[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kstep;
      w[u] = k < K ? __ldcs(reinterpret_cast<const Word*>(
                         m + static_cast<int64_t>(k) * W))
                   : Word(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (w[u]) {
        load_vec(v + static_cast<int64_t>(k0 + u * kstep) * W, x[u]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) x[u][j] = T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add(w[u], x[u]);
  }

  // Windows o .. o + V - 1 of the (S, W) outputs.
  __device__ __forceinline__ void store(const Outs<T>& out, int64_t o) const {
    T mean[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      mean[j] = s[j] / static_cast<T>(c[j] > 1 ? c[j] : 1);
    store_vec(out.cnt + o, c);
    store_vec(out.sum + o, s);
    store_vec(out.mean + o, mean);
    store_vec(out.mn + o, mn);
    store_vec(out.mx + o, mx);
  }
};

// Column regime: thread t takes series t / L, windows (t % L) * V + [0, V).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
grid_window_kernel(const T* __restrict__ v, const uint8_t* __restrict__ m,
                   int64_t S, int K, int W, Outs<T> out) {
  const int L = W / V;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= S * L) return;
  const int64_t s = t / L;
  const int l = static_cast<int>(t - s * L);
  const int64_t base = s * K * W + static_cast<int64_t>(l) * V;
  Acc<T, V> a;
  a.init();
  for (int k0 = 0; k0 < K; k0 += kUnroll)
    a.batch(v + base, m + base, k0, 1, K, W);
  a.store(out, s * W + static_cast<int64_t>(l) * V);
}

// Split regime: thread (r, l) = (tid / L, tid % L) takes rows r, r + R,
// ... of vector lane l of each series its CTA visits.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
grid_window_kernel_split(const T* __restrict__ v, const uint8_t* __restrict__ m,
                         int64_t S, int K, int W, Outs<T> out) {
  __shared__ Acc<T, V> part[kThreads];
  const int L = W / V;
  const int R = kThreads / L;
  const int r = threadIdx.x / L;
  const int l = threadIdx.x - r * L;
  int top = 1;  // the tree's first stride: the largest power of two < R
  while (2 * top < R) top *= 2;
  for (int64_t s = blockIdx.x; s < S; s += gridDim.x) {
    Acc<T, V> a;
    a.init();
    if (r < R) {
      const int64_t base = s * K * W + static_cast<int64_t>(l) * V;
      for (int k0 = r; k0 < K; k0 += R * kUnroll)
        a.batch(v + base, m + base, k0, R, K, W);
    }
    part[threadIdx.x] = a;
    __syncthreads();
    // fixed tree over r: partial r takes r + h for h = top, top / 2, ... 1
    for (int h = top; h > 0; h >>= 1) {
      if (r < h && r + h < R) {
        a.merge(part[threadIdx.x + h * L]);
        part[threadIdx.x] = a;
      }
      __syncthreads();
    }
    if (r == 0) a.store(out, s * W + static_cast<int64_t>(l) * V);
    __syncthreads();  // part is rewritten for the next series
  }
}

template <typename T, int V>
int launch_v(const T* v, const uint8_t* m, long long S, int K, int W,
             const Outs<T>& out, cudaStream_t stream) {
  const int L = W / V;
  if (2 * L <= kThreads && static_cast<long long>(K) * L >= kThreads) {
    static int per_sm = 0;  // CTAs of the split kernel one SM holds
    if (per_sm == 0) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, grid_window_kernel_split<T, V>, kThreads, 0);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (per_sm < 1) per_sm = 1;
    }
    const long long grid = ogt::capped_grid(S, per_sm);
    if (grid < 0) return static_cast<int>(-grid);
    grid_window_kernel_split<T, V><<<static_cast<unsigned>(grid), kThreads, 0,
                                     stream>>>(v, m, S, K, W, out);
  } else {
    const long long blocks = (S * L + kThreads - 1) / kThreads;
    grid_window_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(v, m, S, K, W, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* v, const void* m, long long S, int K, int W,
           void* cnt, void* sum, void* mean, void* mn, void* mx,
           void* stream) {
  if (S * static_cast<long long>(W) <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const Outs<T> out{static_cast<int*>(cnt), static_cast<T*>(sum),
                    static_cast<T*>(mean), static_cast<T*>(mn),
                    static_cast<T*>(mx)};
  const bool vec = W % V == 0 && ogt::aligned(v, 16) && ogt::aligned(m, V) &&
                   ogt::aligned(cnt, 4 * V) && ogt::aligned(sum, 16) &&
                   ogt::aligned(mean, 16) && ogt::aligned(mn, 16) &&
                   ogt::aligned(mx, 16);
  const auto st = static_cast<cudaStream_t>(stream);
  const T* vt = static_cast<const T*>(v);
  const uint8_t* mt = static_cast<const uint8_t*>(m);
  return vec ? launch_v<T, V>(vt, mt, S, K, W, out, st)
             : launch_v<T, 1>(vt, mt, S, K, W, out, st);
}

}  // namespace

extern "C" int ogt_grid_window_agg_f32(const void* v, const void* m,
                                       long long S, int K, int W, void* cnt,
                                       void* sum, void* mean, void* mn,
                                       void* mx, void* stream) {
  return launch<float>(v, m, S, K, W, cnt, sum, mean, mn, mx, stream);
}

extern "C" int ogt_grid_window_agg_f64(const void* v, const void* m,
                                       long long S, int K, int W, void* cnt,
                                       void* sum, void* mean, void* mn,
                                       void* mx, void* stream) {
  return launch<double>(v, m, S, K, W, cnt, sum, mean, mn, mx, stream);
}

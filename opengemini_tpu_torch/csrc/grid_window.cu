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
// writes S*W*(4+4*sizeof(T)), with a few flops per element. Design: one
// thread per (s, w) column looping over k; neighbouring threads take
// neighbouring w, so at every k step a warp's loads are contiguous. No
// shared memory and no cross-thread reduction are needed.
#include "ogt_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
grid_window_kernel(const T* __restrict__ v, const uint8_t* __restrict__ m,
                   int64_t S, int K, int W, int32_t* __restrict__ cnt_out,
                   T* __restrict__ sum_out, T* __restrict__ mean_out,
                   T* __restrict__ min_out, T* __restrict__ max_out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= S * W) return;
  const int64_t s = t / W;
  const int w = static_cast<int>(t - s * W);
  const int64_t base = s * K * W + w;

  int c = 0;
  T sum = T(0);
  T mn = ogt::pos_inf<T>();
  T mx = -ogt::pos_inf<T>();
  for (int k = 0; k < K; ++k) {
    const int64_t off = base + static_cast<int64_t>(k) * W;
    if (m[off]) {
      const T x = v[off];
      c += 1;
      sum += x;
      mn = ogt::nan_min(mn, x);
      mx = ogt::nan_max(mx, x);
    }
  }
  cnt_out[t] = c;
  sum_out[t] = sum;
  mean_out[t] = sum / static_cast<T>(c > 1 ? c : 1);
  min_out[t] = mn;
  max_out[t] = mx;
}

template <typename T>
int launch(const void* v, const void* m, long long S, int K, int W,
           void* cnt, void* sum, void* mean, void* mn, void* mx,
           void* stream) {
  const long long n = S * static_cast<long long>(W);
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  grid_window_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const uint8_t*>(m), S, K, W,
      static_cast<int32_t*>(cnt), static_cast<T*>(sum),
      static_cast<T*>(mean), static_cast<T*>(mn), static_cast<T*>(mx));
  return static_cast<int>(cudaGetLastError());
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

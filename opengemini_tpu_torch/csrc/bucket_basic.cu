// Bucket-row basic statistics: per row of a (G, W) bucket matrix, the
// count, sum, mean = sum / max(count, 1), min (+inf when empty), max
// (-inf when empty) and the sum of squared deviations around the row
// mean.
//
// Replaces the TPU kernel opengemini_tpu/ops/pallas_segment.py
// bucket_stats_basic -> _bucket_basic_call -> _basic_kernel, which
// models/ragged.py BucketedBatch runs for every bucket of a GROUP BY
// tags (no time grouping) aggregate.
//
// Bound on the card: bytes. The kernel reads each value and mask byte
// once from device memory (G*W*(sizeof(T)+1)) and writes G*(4+5*sizeof(T));
// it does a handful of flops per element. Design: one warp per row,
// lanes stride the row so a warp's loads are contiguous; warp-shuffle
// reductions; the second (deviation) pass re-reads the row, which a
// warp just touched, from L1/L2 rather than from device memory. The mean
// used for the deviations is computed in the data type, as the TPU
// kernel does, so the ssd matches it up to summation order.
#include "ogt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bucket_basic_kernel(const T* __restrict__ v, const uint8_t* __restrict__ m,
                    int64_t G, int W, int32_t* __restrict__ cnt_out,
                    T* __restrict__ sum_out, T* __restrict__ mean_out,
                    T* __restrict__ min_out, T* __restrict__ max_out,
                    T* __restrict__ ssd_out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= G) return;  // uniform across the warp: shuffles stay full-mask
  const T* vr = v + row * W;
  const uint8_t* mr = m + row * W;

  int c = 0;
  T s = T(0);
  T mn = ogt::pos_inf<T>();
  T mx = -ogt::pos_inf<T>();
  for (int j = lane; j < W; j += 32) {
    if (mr[j]) {
      const T x = vr[j];
      c += 1;
      s += x;
      mn = ogt::nan_min(mn, x);
      mx = ogt::nan_max(mx, x);
    }
  }
  c = ogt::warp_sum(c);
  s = ogt::warp_sum(s);
  mn = ogt::warp_nan_min(mn);
  mx = ogt::warp_nan_max(mx);
  const T mean = s / static_cast<T>(c > 1 ? c : 1);

  T d2 = T(0);
  for (int j = lane; j < W; j += 32) {
    if (mr[j]) {
      const T d = vr[j] - mean;
      d2 += d * d;
    }
  }
  d2 = ogt::warp_sum(d2);

  if (lane == 0) {
    cnt_out[row] = c;
    sum_out[row] = s;
    mean_out[row] = mean;
    min_out[row] = mn;
    max_out[row] = mx;
    ssd_out[row] = d2;
  }
}

template <typename T>
int launch(const void* v, const void* m, long long G, int W, void* cnt,
           void* sum, void* mean, void* mn, void* mx, void* ssd,
           void* stream) {
  if (G <= 0) return 0;
  const long long blocks = (G + kRowsPerBlock - 1) / kRowsPerBlock;
  bucket_basic_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const uint8_t*>(m), G, W,
      static_cast<int32_t*>(cnt), static_cast<T*>(sum),
      static_cast<T*>(mean), static_cast<T*>(mn), static_cast<T*>(mx),
      static_cast<T*>(ssd));
  return static_cast<int>(cudaGetLastError());
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

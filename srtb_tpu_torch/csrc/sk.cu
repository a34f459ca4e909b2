// K3 and K4: the waterfall tail of the single-pulse search — spectral-
// kurtosis statistics, then the zap and the frequency-summed power time
// series in one more read.
//
// K3 replaces srtb_tpu/ops/pallas_kernels.py sk_zap_timeseries, stats pass
// (pallas_call at :546, body _sk_stats_kernel :443): per row f of the
// complex64 waterfall [F, T], s2 = sum_t |x|^2, s4 = sum_t |x|^4 and the
// first-sample power |x[f, 0]|^2.
// K4 replaces sk_apply_timeseries (pallas_call at :604, body
// _sk_apply_kernel :467): out[f, t] = zap[f] ? 0 : x[f, t] (a select, so a
// zapped row holding NaN or Inf becomes exactly 0) and
// ts[t] = sum_f |out[f, t]|^2.
//
// Bound: bytes.  At the production waterfall [2048, 2^18] K3 reads 4.3 GB
// and K4 reads 4.3 GB and writes 4.3 GB; each does a few flops per value.
// The TPU kernels carried sums across a sequential grid in VMEM scratch and
// left 128-lane partials for XLA to finish.  On Hopper the blocks run in no
// order, so each kernel owns whole reductions instead:
//   K3: one 256-thread block per row strides over T with coalesced 8-byte
//       loads, keeps FP64 partial sums in registers (free at this
//       arithmetic intensity, and their rounding stays far below the
//       float32 result's), and finishes the row in-block with warp
//       shuffles;
//   K4: one thread per time column walks down all F rows, so the column sum
//       stays in a register: no atomics, a fixed summation order and a
//       reproducible time series.  T = 2^18 gives 1024 blocks, enough to
//       fill 132 SMs; neighbouring threads read neighbouring columns.
#include "common.cuh"

namespace {

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(srtb::kThreads)
    sk_stats_kernel(const float2* __restrict__ wf, float* __restrict__ s2,
                    float* __restrict__ s4, float* __restrict__ fs0,
                    long long t_len) {
  const float2* row = wf + static_cast<long long>(blockIdx.x) * t_len;
  double a2 = 0.0;
  double a4 = 0.0;
#pragma unroll 4
  for (long long t = threadIdx.x; t < t_len; t += srtb::kThreads) {
    const double p = srtb::power(row[t]);
    a2 += p;
    a4 += p * p;
  }
  a2 = warp_sum(a2);
  a4 = warp_sum(a4);
  __shared__ double sh2[srtb::kThreads / 32];
  __shared__ double sh4[srtb::kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh2[warp] = a2;
    sh4[warp] = a4;
  }
  __syncthreads();
  if (warp == 0) {
    a2 = lane < srtb::kThreads / 32 ? sh2[lane] : 0.0;
    a4 = lane < srtb::kThreads / 32 ? sh4[lane] : 0.0;
    a2 = warp_sum(a2);
    a4 = warp_sum(a4);
    if (lane == 0) {
      s2[blockIdx.x] = static_cast<float>(a2);
      s4[blockIdx.x] = static_cast<float>(a4);
      fs0[blockIdx.x] = srtb::power(row[0]);
    }
  }
}

__global__ void __launch_bounds__(srtb::kThreads)
    sk_apply_kernel(const float2* __restrict__ wf,
                    const uint8_t* __restrict__ zap,
                    float2* __restrict__ out, float* __restrict__ ts,
                    long long f_len, long long t_len) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= t_len) return;
  double acc = 0.0;
#pragma unroll 4
  for (long long f = 0; f < f_len; ++f) {
    float2 v = wf[f * t_len + t];
    if (__ldg(zap + f)) v = make_float2(0.0f, 0.0f);
    out[f * t_len + t] = v;
    acc += srtb::power(v);
  }
  ts[t] = static_cast<float>(acc);
}

}  // namespace

// wf: complex64 [f_len, t_len] as float2; s2, s4, fs0: float32 [f_len].
SRTB_EXPORT int srtb_sk_stats(const void* wf, void* s2, void* s4, void* fs0,
                              long long f_len, long long t_len,
                              void* stream) {
  if (f_len <= 0 || t_len <= 0) return 0;
  if (f_len > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sk_stats_kernel<<<static_cast<int>(f_len), srtb::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(wf), static_cast<float*>(s2),
      static_cast<float*>(s4), static_cast<float*>(fs0), t_len);
  return static_cast<int>(cudaGetLastError());
}

// wf, out: complex64 [f_len, t_len]; zap: uint8 [f_len] (nonzero = zap);
// ts: float32 [t_len].
SRTB_EXPORT int srtb_sk_apply_timeseries(const void* wf, const void* zap,
                                         void* out, void* ts, long long f_len,
                                         long long t_len, void* stream) {
  if (f_len <= 0 || t_len <= 0) return 0;
  const long long blocks = (t_len + srtb::kThreads - 1) / srtb::kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sk_apply_kernel<<<static_cast<int>(blocks), srtb::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(wf), static_cast<const uint8_t*>(zap),
      static_cast<float2*>(out), static_cast<float*>(ts), f_len, t_len);
  return static_cast<int>(cudaGetLastError());
}

// B8: the whole waterfall tail in one launch (replaces
// srtb_tpu/ops/pallas_fft.py fft_rows_skzap_ri, pallas_call :278): per row
// the B6 inverse FFT, the de-window, the complete SK moments (reduced
// across the cluster before anything is written), the verdict, the zap as
// a select (NaN/Inf rows become exactly 0), the zap flag and the pre-zap
// first-sample power; over rows, the power time series of the kept rows,
// through per-cluster partial series added in a fixed order by a second,
// small kernel.  Design: fft_rows.cuh.
#include "fft_rows.cuh"

namespace {

// ts[t] = sum over clusters g of ts_part[g, t], in g order, in float64.
__global__ void __launch_bounds__(srtb::kThreads)
    ts_reduce_kernel(const float* __restrict__ part, float* __restrict__ ts,
                     long long groups, long long length) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= length) return;
  double acc = 0.0;
  for (long long g = 0; g < groups; ++g) acc += part[g * length + t];
  ts[t] = static_cast<float>(acc);
}

}  // namespace

// in, out: complex64 [batch, length]; tw: complex64 [length]; dw: float32
// [length] reciprocal de-window or null; zapf: uint8 [batch]; fs0: float32
// [batch]; ts_part: float32 [groups, length] scratch; ts: float32
// [length].  Row r belongs to cluster r mod groups.
SRTB_EXPORT int srtb_fft_rows_skzap(const void* in, void* out, const void* tw,
                                    const void* dw, void* zapf, void* fs0,
                                    void* ts_part, void* ts, long long batch,
                                    long long length, int inverse,
                                    long long groups, float thr_low,
                                    float thr_high, void* stream) {
  srtb::fft::Args a = {};
  a.in = static_cast<const float2*>(in);
  a.out = static_cast<float2*>(out);
  a.tw = static_cast<const float2*>(tw);
  a.dw = static_cast<const float*>(dw);
  a.zapf = static_cast<uint8_t*>(zapf);
  a.fs0 = static_cast<float*>(fs0);
  a.ts_part = static_cast<float*>(ts_part);
  a.thr_low = thr_low;
  a.thr_high = thr_high;
  a.batch = batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return 0;
  const int rc = srtb::fft::dispatch<srtb::fft::kSkZap>(a, length, inverse,
                                                         groups, s);
  if (rc != 0) return rc;
  const long long blocks = (length + srtb::kThreads - 1) / srtb::kThreads;
  ts_reduce_kernel<<<static_cast<int>(blocks), srtb::kThreads, 0,
                                s>>>(static_cast<const float*>(ts_part),
                                     static_cast<float*>(ts), groups, length);
  return static_cast<int>(cudaGetLastError());
}

// B3: the coherent-dedispersion chirp multiply alone, phase made in the
// kernel, with the global channel index offset i0.
//
// Replaces the TPU kernel srtb_tpu/ops/pallas_kernels.py dedisperse_df64
// (pallas_call at :421, body _dedisperse_kernel :303), which the
// reference's staged plan without use_pallas runs after an XLA RFI stage 1
// (pipeline/segment.py:982-998).  Per bin i of the complex64 spectrum:
//   out[i] = x[i] * exp(-2 pi i frac(k(i + i0)))
// with k the chirp phase in turns (srtb::chirp in common.cuh, the code K2
// runs, so the two chirps cannot drift apart).
//
// Bound: bytes.  At 2^29 bins it reads 4.3 GB and writes 4.3 GB (8.59e9 B,
// 2.56 ms at 3.35 TB/s); the float64 phase is ~10 operations a bin (5.4e9,
// 0.16 ms at 34 TFLOP/s).  The TPU kernel had no FP64 and rebuilt the
// phase from two-float arithmetic, anchored-Taylor per 128-lane row or
// exact per element (its ``exact`` flag): both are artifacts of that.  Here
// the phase is always the exact one, from the int64 index in float64.  The
// design is a grid-stride loop, one 8-byte load and one 8-byte store per
// bin, consecutive threads on consecutive bins.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(srtb::kThreads)
    dedisperse_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                      long long n, long long i0, double f_min, double df,
                      double f_c, double c_dm) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = srtb::rotate(in[i], srtb::chirp(i + i0, f_min, df, f_c, c_dm));
  }
}

}  // namespace

// in, out: complex64 [n] as float2; bin i takes the chirp of channel i0 + i.
SRTB_EXPORT int srtb_dedisperse(const void* in, void* out, long long n,
                                long long i0, double f_min, double df,
                                double f_c, double c_dm, void* stream) {
  if (n <= 0) return 0;
  dedisperse_kernel<<<srtb::grid_for(n), srtb::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(in), static_cast<float2*>(out), n, i0, f_min,
      df, f_c, c_dm);
  return static_cast<int>(cudaGetLastError());
}

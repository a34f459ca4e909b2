// K2: RFI stage 1 (average-power zap + normalize + manual keep mask) fused
// with the coherent-dedispersion chirp multiply.
//
// Replaces the TPU kernel srtb_tpu/ops/pallas_kernels.py
// rfi_s1_dedisperse_df64 (pallas_call at :383, body _rfi_dedisperse_kernel
// :314).  Per bin i of the complex64 spectrum:
//   keep  = |x|^2 <= thr  (thr = threshold * mean power, a device scalar
//           computed by a prior reduction, so no host sync)
//   scale = keep ? norm : 0, and 0 where the manual keep mask is 0
//   k     = c_dm * (f - f_c)^2 / f,  f = f_min + df * i,
//           c_dm = D * 1e6 * dm / f_c^2          (chirp phase in turns)
//   out   = x * scale * exp(-2 pi i frac(k)),  frac with modf semantics
//
// Bound: bytes.  At 2^29 bins it reads 4.3 GB of spectrum and 0.54 GB of
// keep mask and writes 4.3 GB.  The TPU kernel had no FP64, so it rebuilt
// the phase from two-float (df64) arithmetic with an anchored Taylor
// expansion per 128-lane row.  The H100 has native FP64: the phase is
// computed exactly per bin, from the int64 bin index converted to double,
// with one double division (the quotient form c_dm (f - f_c)^2 / f needs
// one instead of the reference formula's two).  That is ~10 FP64
// operations per bin; at FP64's rate that stays below the memory time, so
// the design keeps the per-bin exact phase and the reduction to one turn
// happens in FP64 before the only float32 step, sincospif of -2 frac(k)
// (srtb::chirp in common.cuh, which B3 shares).  The products that feed
// the keep decision and the rotation use _rn intrinsics, so they round
// exactly as the plain PyTorch version does.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(srtb::kThreads)
    rfi_s1_dedisperse_kernel(const float2* __restrict__ in,
                             const uint8_t* __restrict__ keep,
                             const float* __restrict__ thr,
                             float2* __restrict__ out, long long n,
                             float norm, double f_min, double df, double f_c,
                             double c_dm) {
  const float t = *thr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float2 v = in[i];
    float scale = (srtb::power(v) <= t) ? norm : 0.0f;
    if (keep != nullptr && keep[i] == 0) scale = 0.0f;
    const float2 x = make_float2(__fmul_rn(v.x, scale),
                                 __fmul_rn(v.y, scale));
    out[i] = srtb::rotate(x, srtb::chirp(i, f_min, df, f_c, c_dm));
  }
}

}  // namespace

// in, out: complex64 [n] as float2; keep: uint8 [n] (nonzero = keep) or
// null; thr: float32 [1] on the device.
SRTB_EXPORT int srtb_rfi_s1_dedisperse(const void* in, const void* keep,
                                       const void* thr, void* out,
                                       long long n, float norm, double f_min,
                                       double df, double f_c, double c_dm,
                                       void* stream) {
  if (n <= 0) return 0;
  rfi_s1_dedisperse_kernel<<<srtb::grid_for(n), srtb::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(in), static_cast<const uint8_t*>(keep),
      static_cast<const float*>(thr), static_cast<float2*>(out), n, norm,
      f_min, df, f_c, c_dm);
  return static_cast<int>(cudaGetLastError());
}

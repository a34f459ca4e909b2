// B7: the B6 row FFT with the de-window multiply and the per-row power
// moments sum |x|^2, sum |x|^4 (float64 accumulation rounded to float32,
// as K3 accumulates them) computed while the row is on chip (replaces
// srtb_tpu/ops/pallas_fft.py fft_rows_stats_ri, pallas_call :546).  The
// TPU kernel's [B, 128] lane partials were a layout artifact; here each
// row's sums are complete.  Design: fft_rows.cuh.
#include "fft_rows.cuh"

// in, out: complex64 [batch, length]; tw: complex64 [length]; dw: float32
// [length] reciprocal de-window or null; s2, s4: float32 [batch].
SRTB_EXPORT int srtb_fft_rows_stats(const void* in, void* out, const void* tw,
                                    const void* dw, void* s2, void* s4,
                                    long long batch, long long length,
                                    int inverse, void* stream) {
  srtb::fft::Args a = {};
  a.in = static_cast<const float2*>(in);
  a.out = static_cast<float2*>(out);
  a.tw = static_cast<const float2*>(tw);
  a.dw = static_cast<const float*>(dw);
  a.s2 = static_cast<float*>(s2);
  a.s4 = static_cast<float*>(s4);
  a.batch = batch;
  return srtb::fft::run_stats(a, length, inverse,
                              static_cast<cudaStream_t>(stream));
}

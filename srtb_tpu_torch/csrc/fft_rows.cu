// B6: batched unnormalized C2C row FFT, forward or inverse, rows of
// L = 2^12 ... 2^16 (replaces srtb_tpu/ops/pallas_fft.py fft_rows_ri,
// pallas_call :496).  The design, and the B7/B8 epilogues that share it,
// are described in fft_rows.cuh.
#include "fft_rows.cuh"

// in, out: complex64 [batch, length] as float2; tw: complex64 [length],
// exp(-2 pi i m / length).
SRTB_EXPORT int srtb_fft_rows(const void* in, void* out, const void* tw,
                              long long batch, long long length, int inverse,
                              void* stream) {
  srtb::fft::Args a = {};
  a.in = static_cast<const float2*>(in);
  a.out = static_cast<float2*>(out);
  a.tw = static_cast<const float2*>(tw);
  a.batch = batch;
  return srtb::fft::dispatch<srtb::fft::kPlain>(
      a, length, inverse, batch, static_cast<cudaStream_t>(stream));
}

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

// B10: pass 2 of the two-pass four-step C2C (replaces
// srtb_tpu/ops/pallas_fft2.py pass2_2d, pallas_call :571): the row FFT
// over j2 of pass 1's [n1, n2] intermediate, rows of n2 = 2^12 ... 2^16,
// output C[k1, k2] in the same k1-major layout (the transform's index is
// k2 n1 + k1).  It is B6's function, so it runs B6's kernel (it is here,
// not in fft2.cu, so that the kernel's instantiations live in one
// object), under its own entry point and launch counter.
// in, out: complex64 [rows, n2] as float2; tw: complex64 [n2].
SRTB_EXPORT int srtb_fft2_pass2(const void* in, void* out, const void* tw,
                                long long rows, long long n2, int inverse,
                                void* stream) {
  return srtb_fft_rows(in, out, tw, rows, n2, inverse, stream);
}

// B9: pass 1 of the two-pass four-step C2C, for transforms of length
// m = n1 n2 (n1 = 4096 or 8192, n2 = 2^12 ... 2^16, so m = 2^24 ... 2^29).
//
// Replaces the TPU kernel srtb_tpu/ops/pallas_fft2.py pass1_2d
// (pallas_call at :531, body _pass1_kernel :441).  The column FFT and
// four-step twiddle of every column of the [n1, n2] view, the body shared
// with B11 (fft2.cuh, where the design is described), fed complex64
// values.  Pass 2 (B10) is the row FFT over j2 of B: srtb_fft2_pass2 in
// fft_rows.cu, B6's kernel on rows of n2.  Then X[k1 + n1 k2] = C[k1, k2],
// and a transpose restores natural order.
//
// Bound: bytes, 8 B read and 8 B written a value (the 2^27 path's two
// planes of 2^25: 1.07e9 B, 0.32 ms at 3.35 TB/s); the column FFT is
// ~5 log2(n1) flops a value and the twiddle one sincospif, far below the
// float32 rate.
#include "fft2.cuh"

// in, out: complex64 [batch, n1, n2] as float2; tw: complex64 [n1],
// exp(-2 pi i j / n1).  n1 = 4096 or 8192, n2 a power of two in
// [4096, 65536].
SRTB_EXPORT int srtb_fft2_pass1(const void* in, void* out, const void* tw,
                                long long batch, long long n1, long long n2,
                                int inverse, void* stream) {
  const srtb::fft::ComplexLoader load{static_cast<const float2*>(in),
                                      n1 * n2};
  return srtb::fft::dispatch_column_pass<false>(
      load, static_cast<float2*>(out), static_cast<const float2*>(tw), batch,
      n1, n2, inverse, nullptr, static_cast<cudaStream_t>(stream));
}

// B6 and B10: batched unnormalized C2C row FFTs, forward or inverse, rows
// of L = 2^12 ... 2^16, on the Hopper row-FFT core of
// fft_rows_sm90.cuh (its note gives the design and the TPU kernels it
// replaces).  Both entry points live here so that the core's
// instantiations are compiled into one object.
#include "fft_rows_sm90.cuh"

// The launch geometry of rows of ``length``: int32 [8] = C (CTAs a
// cluster), N (values a CTA), threads, CTAs an SM, resident CTAs (C = 1)
// or clusters the card holds at once, registers a thread, local (spilled)
// bytes a thread, dynamic shared bytes a CTA.
SRTB_EXPORT int srtb_fft_rows_geometry(long long length, void* geo) {
  return srtb::rows::geometry(length, static_cast<int*>(geo));
}

// B6 (replaces srtb_tpu/ops/pallas_fft.py fft_rows_ri, pallas_call :496).
// in, out: complex64 [batch, length] as float2, ``in`` 16-byte aligned
// (TMA).
SRTB_EXPORT int srtb_fft_rows(const void* in, void* out, long long batch,
                              long long length, int inverse, void* stream) {
  const srtb::rows::RowArgs a = {static_cast<const float2*>(in),
                                 static_cast<float2*>(out), batch};
  return srtb::rows::run(a, length, inverse,
                         static_cast<cudaStream_t>(stream));
}

// B10: pass 2 of the two-pass four-step C2C (replaces
// srtb_tpu/ops/pallas_fft2.py pass2_2d, pallas_call :571): the row FFT
// over j2 of pass 1's [n1, n2] intermediate, rows of n2 = 2^12 ... 2^16,
// output C[k1, k2] in the same k1-major layout (the transform's index is
// k2 n1 + k1).  B6's function on B6's core, under its own entry point and
// launch counter.
SRTB_EXPORT int srtb_fft2_pass2(const void* in, void* out, long long rows,
                                long long n2, int inverse, void* stream) {
  return srtb_fft_rows(in, out, rows, n2, inverse, stream);
}

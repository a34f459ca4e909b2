// B9: pass 1 of the two-pass four-step C2C, for transforms of length
// m = n1 n2 (n1 = 4096 or 8192, n2 = 2^12 ... 2^16, so m = 2^24 ... 2^29).
//
// Replaces the TPU kernel srtb_tpu/ops/pallas_fft2.py pass1_2d
// (pallas_call at :531, body _pass1_kernel :441).  The column FFT and
// four-step twiddle of every column of the [n1, n2] view, on the
// clustered column body shared with B11 (fft2.cuh, where the design is
// described), fed complex64 values by 2-D TMA tensor copies.  Pass 2
// (B10) is the row FFT over j2 of B: srtb_fft2_pass2 in fft_rows.cu, B6's
// core on rows of n2.  Then X[k1 + n1 k2] = C[k1, k2], and a transpose
// restores natural order.
//
// Bound: bytes, 8 B read and 8 B written a value: the 2^27 path's two
// planes of 2^25, 1.07e9 B, 0.321 ms, and the 2^30 staged pallas2 path's
// [8192, 65536], 8.59e9 B, 2.564 ms, at an H100's 3.35 TB/s.  The first
// column body (two or four columns a CTA, one CTA an SM) took 0.784 and
// 12.56 ms there on an H100 80GB HBM3 at 700 W, the clustered one 0.54
// and 4.52-4.58 ms.
#include "fft2.cuh"

// in, out: complex64 [batch, n1, n2] as float2, ``in`` 16-byte aligned
// (TMA); tw: complex64 [n1], exp(-2 pi i j / n1).  n1 = 4096 or 8192, n2
// a power of two in [4096, 65536].
SRTB_EXPORT int srtb_fft2_pass1(const void* in, void* out, const void* tw,
                                long long batch, long long n1, long long n2,
                                int inverse, void* stream) {
  auto make_load = [&](int ctas, int& rc) {
    srtb::cols::TmaLoader load;
    rc = srtb::cols::make_tma_loader(load, in, batch * n1, n2, 1024 / ctas);
    return load;
  };
  return srtb::cols::run<false>(make_load, static_cast<float2*>(out),
                                static_cast<const float2*>(tw), nullptr,
                                batch, n1, n2, inverse,
                                static_cast<cudaStream_t>(stream));
}

// The launch geometry of B9's column body at n1: int32 [9] = CTAs a
// cluster, columns a cluster, rows a CTA, threads, CTAs an SM, resident
// clusters (the occupancy query), registers a thread, local (spilled)
// bytes a thread, dynamic shared bytes a CTA.
SRTB_EXPORT int srtb_fft2_pass1_geometry(long long n1, void* geo) {
  return srtb::cols::geometry<false, srtb::cols::TmaLoader>(
      n1, static_cast<int*>(geo));
}

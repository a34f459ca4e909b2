// B11: the front-fused pass 1 of the staged plan: the raw baseband bytes of
// a segment in, the four-step intermediate of its packed half-size C2C and
// the pieces of the RFI stage-1 mean power out.
//
// Replaces the TPU kernel srtb_tpu/ops/pallas_fft2.py pass1_front
// (pallas_call at :864, body _pass1_front_kernel :734, unpack
// _front_unpack :707).  For each stream s of the segment (m = n1 n2
// packed values a stream):
//   z[p] = x[2p] w[2p] + i x[2p+1] w[2p+1]      (unpack, window, even/odd
//                                                 pack of ops/fft.py)
//   B[k1, j2] = the column C2C and four-step twiddle of z viewed [n1, n2]
//               (B9's function, on B9's body: fft2.cuh)
//   part = per CTA sum |B|^2, Re and Im of sum_j2 B[0, j2]   (float64)
// The wrapper adds the partials in float64; front_mean_power turns them
// into (n2 sum |B|^2 + 2 F0r F0i) / m, Parseval along the row transform.
//
// The samples: "simple" at 1/2/4 bits (MSB-first fields, sample t at bit
// t |b| of the byte stream), 8 bits unsigned and -8 bits signed
// (v - 2 (v & 0x80)), and "interleaved_samples_2" at 8/-8 bits, two
// streams "1212" byte-interleaved: z_s[p] = x[4p + s] + i x[4p + 2 + s].
// Every unpacked value is a small exact integer and the window one
// float32 multiply, so the loader's values are K1's bit for bit, and on
// them B11 computes B9's bits.
//
// Bound: bytes.  At the 2^30-sample 2-bit segment (m = 2^29, (n1, n2) =
// (8192, 65536)) it reads 2^28 B of raw bytes and writes 4 GiB: 4.56e9 B,
// 1.36 ms at 3.35 TB/s (a window adds two float32 [n1, n2] reads).  The
// design question is the byte read: at n1 = 8192 a CTA's tile is 2
// columns, which at 2 bits is one byte a row, 32 KiB apart, so each row
// of the tile touches its own 32-byte sector that 32 neighbouring CTAs
// share.  The CTAs of one wave sweep neighbouring columns at the same
// time, and the sectors of a wave (~3 a row, 0.8 MB) stay in L2, so the
// device memory reads each sector about once; the extra cost is L2
// traffic, sector-sized requests for single bytes.  CHUNK loads a thread
// stay in flight as in B9.
#include "fft2.cuh"

namespace srtb {
namespace fft {
namespace {

struct FrontLoader {
  const uint8_t* raw;
  const float* w_even;  // window of the even samples, [m], or null
  const float* w_odd;   // of the odd samples
  int nbits;            // |bits|: 1, 2, 4 or 8
  int is_signed;        // -8 bits: int8 values
  int group;            // 8 bits: bytes a packed value of all streams

  __device__ __forceinline__ float2 operator()(long long s,
                                               long long p) const {
    int v0, v1;
    if (nbits == 8) {
      const long long at = group * p + s;
      v0 = __ldg(raw + at);
      v1 = __ldg(raw + at + group / 2);
      if (is_signed) {
        v0 -= 2 * (v0 & 0x80);
        v1 -= 2 * (v1 & 0x80);
      }
    } else {
      const long long bit = 2 * p * nbits;
      const int byte = __ldg(raw + (bit >> 3));
      const int shift = 8 - nbits - static_cast<int>(bit & 7);
      const int mask = (1 << nbits) - 1;
      v0 = (byte >> shift) & mask;
      v1 = (byte >> (shift - nbits)) & mask;
    }
    float re = static_cast<float>(v0);
    float im = static_cast<float>(v1);
    if (w_even != nullptr) {
      re = __fmul_rn(re, __ldg(w_even + p));
      im = __fmul_rn(im, __ldg(w_odd + p));
    }
    return make_float2(re, im);
  }
};

}  // namespace
}  // namespace fft
}  // namespace srtb

// raw: uint8, the segment's bytes (streams * 2 m |nbits| / 8); w_even,
// w_odd: float32 [n1, n2] or null; out: complex64 [streams, n1, n2] as
// float2; tw: complex64 [n1], exp(-2 pi i j / n1); part: float64
// [streams * n2 / COLS, 3], COLS = 16384 / n1.  nbits in {1, 2, 4, 8, -8};
// streams 1, or 2 at 8/-8 bits (the "1212" interleave).
SRTB_EXPORT int srtb_fft2_pass1_front(const void* raw, const void* w_even,
                                      const void* w_odd, void* out,
                                      const void* tw, void* part,
                                      long long streams, long long n1,
                                      long long n2, int nbits, int inverse,
                                      void* stream) {
  const int bits = nbits < 0 ? -nbits : nbits;
  const bool ok = (nbits == 1 || nbits == 2 || nbits == 4 || bits == 8) &&
                  (streams == 1 || (streams == 2 && bits == 8));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const srtb::fft::FrontLoader load{
      static_cast<const uint8_t*>(raw), static_cast<const float*>(w_even),
      static_cast<const float*>(w_odd), bits, nbits < 0 ? 1 : 0,
      static_cast<int>(2 * streams)};
  return srtb::fft::dispatch_column_pass<true>(
      load, static_cast<float2*>(out), static_cast<const float2*>(tw),
      streams, n1, n2, inverse, static_cast<double*>(part),
      static_cast<cudaStream_t>(stream));
}

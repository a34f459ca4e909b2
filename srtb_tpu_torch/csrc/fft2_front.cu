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
// 1.36 ms at an H100's 3.35 TB/s (a window adds two float32 [n1, n2]
// reads).  On the first column body (two columns a CTA, one CTA an SM)
// it took 13.32 ms there on an H100 80GB HBM3 at 700 W, what B9 took on
// the same shape: the tile, not the byte reads, bounded both.  On the
// clustered body (fft2.cuh: 8 columns, 64-byte row segments, two CTAs an
// SM) the loader reads its bytes with ordinary loads straight into
// registers: at 2 bits a row segment of the 8 packed values is 4 bytes,
// under TMA's 16-byte box.  A thread fetches the words of all its 32
// values before it unpacks any (one load each; unpacking as it loaded
// took 7.55 ms, fetching first 5.37 ms).  A row's 4 bytes are 32 KiB
// from the next row's, and the 8 clusters that share a 32-byte sector
// run at about the same time, so the sector stays in L2; each load has
// L2 fetch the 256 bytes around it for the clusters after them (1.8% on
// that card).  Loading the raw rows by TMA instead (a uint8 tensor map,
// 16-byte boxes, which must start on 16-byte boundaries) was 5% slower.
#include "fft2.cuh"

namespace srtb {
namespace cols {
namespace {

// A read-only load that has L2 fetch the 256 bytes around the address.
template <class T>
__device__ __forceinline__ uint32_t load_l2_256(const uint8_t* at) {
  uint32_t v;
  if constexpr (sizeof(T) == 4) {
    asm("ld.global.nc.L2::256B.u32 %0, [%1];" : "=r"(v) : "l"(at));
  } else {
    unsigned short h;
    if constexpr (sizeof(T) == 2) {
      asm("ld.global.nc.L2::256B.u16 %0, [%1];" : "=h"(h) : "l"(at));
    } else {
      asm("ld.global.nc.L2::256B.u8 %0, [%1];" : "=h"(h) : "l"(at));
    }
    v = h;
  }
  return v;
}

struct FrontLoader {
  static constexpr bool kTma = false;
  const uint8_t* raw;
  const float* w_even;  // window of the even samples, [m], or null
  const float* w_odd;   // of the odd samples
  int nbits;            // |bits|: 1, 2, 4 or 8
  int is_signed;        // -8 bits: int8 values
  int group;            // 8 bits: bytes a packed value of all streams

  // The raw bits of packed value p of stream s, one load: the byte of a
  // sub-byte pair, the 2 (simple) or 4 ("1212") bytes of an 8-bit group.
  // The body fetches all of a thread's words before it unpacks any.  Each
  // load has L2 fetch the 256 bytes around it: the clusters of the next
  // columns, which read the rest of those bytes, run soon after.
  __device__ __forceinline__ uint32_t fetch(long long s, long long p) const {
    if (nbits == 8 && group == 4) {
      return load_l2_256<uint32_t>(raw + 4 * p);
    }
    if (nbits == 8) return load_l2_256<uint16_t>(raw + 2 * p);
    return load_l2_256<uint8_t>(raw + ((2 * p * nbits) >> 3));
  }
  // z[p] of stream s from its fetched word: the two samples, as K1 reads
  // them, times the window
  __device__ __forceinline__ float2 value(uint32_t word, long long s,
                                          long long p) const {
    int v0, v1;
    if (nbits == 8) {
      v0 = (word >> (8 * s)) & 0xff;
      v1 = (word >> (8 * (s + group / 2))) & 0xff;
      if (is_signed) {
        v0 -= 2 * (v0 & 0x80);
        v1 -= 2 * (v1 & 0x80);
      }
    } else {
      const int shift =
          8 - nbits - static_cast<int>((2 * p * nbits) & 7);
      const int mask = (1 << nbits) - 1;
      v0 = (word >> shift) & mask;
      v1 = (word >> (shift - nbits)) & mask;
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
}  // namespace cols
}  // namespace srtb

// raw: uint8, the segment's bytes (streams * 2 m |nbits| / 8), 4-byte
// aligned (an 8-bit group is read as one 2- or 4-byte word); w_even,
// w_odd: float32 [n1, n2] or null; out: complex64 [streams, n1, n2] as
// float2; tw: complex64 [n1], exp(-2 pi i j / n1); part: float64
// [streams * (n2 / W) * C, 3], one row a CTA, with W columns and C CTAs
// a cluster as srtb_fft2_pass1_front_geometry reports them (8 and n1 /
// 1024), so that the caller sizes it from this file's Geometry.  nbits in {1, 2,
// 4, 8, -8}; streams 1, or 2 at 8/-8 bits (the "1212" interleave).
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
  const srtb::cols::FrontLoader load{
      static_cast<const uint8_t*>(raw), static_cast<const float*>(w_even),
      static_cast<const float*>(w_odd), bits, nbits < 0 ? 1 : 0,
      static_cast<int>(2 * streams)};
  auto make_load = [&](int, int&) { return load; };
  return srtb::cols::run<true>(make_load, static_cast<float2*>(out),
                               static_cast<const float2*>(tw),
                               static_cast<double*>(part), streams, n1, n2,
                               inverse, static_cast<cudaStream_t>(stream));
}

// The launch geometry of B11's column body at n1, B9's fields
// (srtb_fft2_pass1_geometry).
SRTB_EXPORT int srtb_fft2_pass1_front_geometry(long long n1, void* geo) {
  return srtb::cols::geometry<true, srtb::cols::FrontLoader>(
      n1, static_cast<int*>(geo));
}

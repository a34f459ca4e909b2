// B12: the front-fused pass 2 of the staged plan: the row FFT of the
// four-step intermediate with the whole spectrum tail as its epilogue.
//
// Replaces the TPU kernel srtb_tpu/ops/pallas_fft2.py pass2_spectrum
// (pallas_call at :1046, body _pass2_spec_kernel :895).  Input: one
// stream's intermediate B[k1, j2] complex64 [n1, n2] (B9 or B11), the
// stage-1 threshold thr = threshold * mean power (a device scalar), and
// optionally the blocked keep mask and either the blocked premul pair
// (c, cw) or the chirp's constants.  Output: the dedispersed drop-Nyquist
// spectrum S[k1, k2] [n1, n2], k1-major blocked (bin k = k2 n1 + k1).
// Per row k1:
//   Z[k2] = sum_j2 B[k1, j2] exp(-2 pi i j2 k2 / n2)   = F[k2 n1 + k1]
// and per bin k the Hermitian R2C post-process from the mirror bin
//   M = F[(m - k) mod m]: row n1 - k1, column n2 - 1 - k2 for k1 >= 1;
//   row 0, column (n2 - k2) mod n2 for k1 = 0,
//   E = (Z + conj M) / 2,  O = -i (Z - conj M) / 2,
//   X = E + exp(-i pi k / m) O       (or X = c E + cw O with the premul)
// then RFI stage 1 and the manual mask as K2 spells them (zap where
// |X|^2 > thr, scale by norm, 0 where keep is 0) and the exact chirp of
// bin k (srtb::chirp, float64 phase from the int64 index, shared with K2
// and B3).
//
// Bound: bytes.  At the 2^30-sample segment ((n1, n2) = (8192, 65536)) it
// reads the 4 GiB intermediate and the 0.5 GiB keep mask once and writes
// 4 GiB: 9.13e9 B, 2.72 ms at 3.35 TB/s, K2's bound (B12 takes K2's
// pass).  The float64 chirp is ~10 operations a bin, 0.16 ms at FP64's
// rate.
//
// Design: an epilogue of the row-FFT core (fft_rows_sm90.cuh, B6/B10's:
// rows loaded by TMA, three in-place Stockham passes with sincospif
// twiddles, the cross-CTA radix-C step and the final DSMEM exchange after
// which CTA p holds the contiguous block X[pN, (p + 1)N) of its row).  The
// TPU kernel transforms each block of rows and also its mirror rows,
// reading the intermediate twice.  Here one cluster of 2C CTAs holds the
// row pair {w, n1 - w}: ranks [0, C) row w, ranks [C, 2C) row n1 - w, each
// half the core on its own row.  For k1 >= 1 the mirror of block p is
// block q = C - 1 - p of the other row, reversed (mirror(pN + j) = qN + N -
// 1 - j), so after one more cluster barrier CTA p reads its mirrors from
// one partner CTA through distributed shared memory, and each pair of
// values gives two bins: CTA p writes the first half of its block and the
// second half of the partner's, the partner the rest of both (one DSMEM
// read for two bins).  The self-paired rows 0 and n1/2 are written by the
// first half of their cluster alone: row n1/2 the same way, CTA p its
// block's first half and block q's second; row 0's mirror column (n2 -
// k2) mod n2 reaches into the neighbouring block by one value, so it takes
// its partner per value.  The keep bytes of the values a CTA writes come
// in by TMA with the row.  Geometry: N = 2^13 values and 256 threads a
// CTA, two CTAs an SM, C = 1, 1, 2, 4 at n2 = 2^12 ... 2^15 (pair
// clusters of 2, 2, 4, 8); at n2 = 2^16, N = 2^14 values and 512 threads a
// CTA, one CTA an SM, C = 4, so that a pair cluster is 8 CTAs.  The core's
// own C = 8 there (pair clusters of 16, above the portable 8) was slower
// (PERF.md).  The epilogue reads its own values back from shared memory
// rather than keeping the last pass's registers live, so that the float64
// chirp does not spill.
#include "fft_rows_sm90.cuh"

namespace srtb {
namespace rows {
namespace {

struct SpectrumArgs {
  const float2* in;      // B [n1, n2], 16-byte aligned (TMA)
  float2* out;           // S [n1, n2]
  const float* thr;      // [1] on the device
  const uint8_t* keep;   // [n1, n2] (nonzero = keep) or null
  const float2* pm_c;    // premul c [n1, n2] or null
  const float2* pm_cw;   // premul cw [n1, n2]
  float norm;
  int chirp;             // 1: multiply by the chirp of bin k
  double f_min, df, f_c, c_dm;
  int n1;
  long long m;
};

// Bin (row, k2) of the spectrum from its own value z and its mirror's zm:
// the Hermitian post, stage 1 against t, the keep mask and the chirp
// (from its argument ``carg``), or the premul pair at ``at``.
__device__ __forceinline__ float2 spectrum_value(const SpectrumArgs& a,
                                                 float2 z, float2 zm,
                                                 int row, int k2,
                                                 long long at, bool kept,
                                                 float carg, float t,
                                                 float inv_m) {
  // E = (Z + conj M) / 2, O = -i (Z - conj M) / 2
  const float2 e = make_float2(0.5f * (z.x + zm.x), 0.5f * (z.y - zm.y));
  const float2 o = make_float2(0.5f * (z.y + zm.y), -0.5f * (z.x - zm.x));
  const long long bin = static_cast<long long>(k2) * a.n1 + row;
  float2 x;
  if (a.pm_c != nullptr) {
    x = cadd(cmul(__ldg(a.pm_c + at), e), cmul(__ldg(a.pm_cw + at), o));
  } else {
    float sn, cs;
    sincospif(-__ll2float_rn(bin) * inv_m, &sn, &cs);
    x = cadd(e, cmul(make_float2(cs, sn), o));
  }
  const float scale = (kept && srtb::power(x) <= t) ? a.norm : 0.0f;
  x = make_float2(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale));
  if (a.chirp) x = srtb::rotate(x, srtb::chirp_of_arg(carg));
  return x;
}

// the row buffer, then the keep bytes and the chirp arguments of the N
// bins a CTA writes
template <int LOG_N, int C, int T>
constexpr size_t spectrum_smem() {
  return Geometry<LOG_N, C, T>::SMEM + Geometry<LOG_N, C, T>::N * 5;
}

template <int LOG_N, int C, int T>
__global__ void __launch_bounds__(T, Geometry<LOG_N, C, T>::CTAS_PER_SM)
    spectrum_kernel(SpectrumArgs a) {
  using G = Geometry<LOG_N, C, T>;
  constexpr int N = G::N;
  constexpr int L = G::L;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float2* const buf = reinterpret_cast<float2*>(smem_raw);
  uint8_t* const keep = smem_raw + G::SMEM;               // [N]
  float* const carg = reinterpret_cast<float*>(keep + N);  // [N]
  __shared__ __align__(8) uint64_t full;
  auto cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int crank = static_cast<int>(blockIdx.x % (2 * C));
  const int half = crank / C;  // 0: row w, 1: its mirror row
  const int p = crank % C;     // rank within the row
  const int q = C - 1 - p;     // the partner's rank in the other half
  const int w = static_cast<int>(blockIdx.x / (2 * C));  // 0 ... n1 / 2
  const int row = half == 0 ? w : (a.n1 - w) % a.n1;
  const int mrow = (a.n1 - row) % a.n1;  // the other half's row
  const long long base = static_cast<long long>(row) * L + p * N;
  const long long mbase = static_cast<long long>(mrow) * L + q * N;
  // epilogue slot j: value j of this block, or (paired, j >= N/2) value
  // j of the partner's block
  const bool paired = row != 0;
  const bool masked = a.keep != nullptr;
  if (tid == 0) {
    mbar_init(&full, masked ? 2 : 1);
    mbar_init_fence();
    if (masked) {
      mbar_expect_tx(&full, N);
      if (paired) {
        bulk_load(keep, a.keep + base, N / 2, &full);
        bulk_load(keep + N / 2, a.keep + mbase + N / 2, N / 2, &full);
      } else {
        bulk_load(keep, a.keep + base, N, &full);
      }
    }
    issue_row_load<G>(buf, a.in + static_cast<long long>(row) * L, p, &full);
  }
  // while the row loads: the float64 chirp arguments of the slots
  if (a.chirp) {
    for (int j = tid; j < N; j += G::THREADS) {
      const bool own = !paired || j < N / 2;
      const long long bin =
          static_cast<long long>((own ? p : q) * N + j) * a.n1 +
          (own ? row : mrow);
      carg[j] = srtb::chirp_arg(bin, a.f_min, a.df, a.f_c, a.c_dm);
    }
  }
  __syncthreads();
  // this CTA's buffer in every CTA of its half
  float2* rbuf[C];
#pragma unroll
  for (int r = 0; r < C; ++r) rbuf[r] = cluster.map_shared_rank(buf, half * C + r);
  mbar_wait(&full, 0);
  if constexpr (C > 1) cross_step<G, false>(buf, rbuf, p);
  LastPass<G> u2;
  local_fft<G, false>(buf, u2);
  if constexpr (C == 1) {
    __syncthreads();  // every pass-2 read precedes the writes
    store_natural<G>(buf, u2);
  } else {
    cluster.sync();  // every CTA has read its buffer
    exchange<G>(rbuf, p, u2);
  }
  cluster.sync();  // every CTA holds its block X[pN, (p + 1)N)

  const int other = (1 - half) * C;
  const float t = __ldg(a.thr);
  const float inv_m = 1.0f / static_cast<float>(a.m);  // a power of two
  const float2* const mirror = cluster.map_shared_rank(buf, other + q);
  if (half == 1 && (w == 0 || 2 * w == a.n1)) {
    // a self-paired row: the first half writes it
  } else if (paired) {
    // value i < N/2 of this block and its mirror, value N - 1 - i of the
    // partner's block, give both of their bins
#pragma unroll 2
    for (int i = tid; i < N / 2; i += G::THREADS) {
      const float2 z = buf[block_pos<G>(i)];
      const float2 zm = mirror[block_pos<G>(N - 1 - i)];
      a.out[base + i] =
          spectrum_value(a, z, zm, row, p * N + i, base + i,
                         !masked || keep[i] != 0, carg[i], t, inv_m);
      const int j = N - 1 - i;
      a.out[mbase + j] =
          spectrum_value(a, zm, z, mrow, q * N + j, mbase + j,
                         !masked || keep[j] != 0, carg[j], t, inv_m);
    }
  } else {
    // row 0: its mirror column (n2 - k2) mod n2 reaches into the
    // neighbouring block at i = 0, so the partner is found per value
    for (int i = tid; i < N; i += G::THREADS) {
      const int k2 = p * N + i;
      const int mc = (L - k2) & (L - 1);
      const float2 zm = cluster.map_shared_rank(buf, other + (mc >> LOG_N))
                            [block_pos<G>(mc & (N - 1))];
      a.out[base + i] =
          spectrum_value(a, buf[block_pos<G>(i)], zm, row, k2, base + i,
                         !masked || keep[i] != 0, carg[i], t, inv_m);
    }
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

template <int LOG_N, int C, int T>
int configure_spectrum(int* geo) {
  using G = Geometry<LOG_N, C, T>;
  const auto kernel = &spectrum_kernel<LOG_N, C, T>;
  constexpr size_t smem = spectrum_smem<LOG_N, C, T>();
  const int rc = prepare(kernel, smem);
  if (rc != 0 || geo == nullptr) return rc;
  return query(kernel, 2 * C, G::N, G::THREADS, smem, geo);
}

template <int LOG_N, int C, int T>
int run_spectrum(const SpectrumArgs& a, cudaStream_t stream) {
  const int rc = configure_spectrum<LOG_N, C, T>(nullptr);
  if (rc != 0) return rc;
  // one pair {w, n1 - w} a cluster, w = 0 ... n1 / 2
  return launch_on_clusters(&spectrum_kernel<LOG_N, C, T>,
                            (a.n1 / 2 + 1) * 2LL * C, 2 * C, T,
                            spectrum_smem<LOG_N, C, T>(), stream, a);
}

// The geometries by row length: the core's (2^13 values and 256 threads a
// CTA, two CTAs an SM; C = 1, 1, 2, 4 at n2 = 2^12 ... 2^15), and at n2 =
// 2^16 2^14 values and 512 threads a CTA, one CTA an SM, C = 4, so that a
// pair cluster is 8 CTAs (the core's C = 8 would make it 16).
template <class F>
int spectrum_by_length(long long n2, F&& f) {
  if (n2 == (1 << 16)) {
    return f(std::integral_constant<int, 14>{},
             std::integral_constant<int, 4>{},
             std::integral_constant<int, 512>{});
  }
  return by_length(n2, [&](auto log_n, auto c) {
    return f(log_n, c, std::integral_constant<int, 256>{});
  });
}

}  // namespace
}  // namespace rows
}  // namespace srtb

// The launch geometry of B12 at rows of n2 (int32 [8], the fields of
// srtb_fft_rows_geometry): CTAs a pair cluster (2 C), values a CTA,
// threads, CTAs an SM, pair clusters the card holds at once, registers,
// local bytes, dynamic shared bytes.
SRTB_EXPORT int srtb_fft2_pass2_spectrum_geometry(long long n2, void* geo) {
  return srtb::rows::spectrum_by_length(n2, [&](auto log_n, auto c, auto t) {
    return srtb::rows::configure_spectrum<decltype(log_n)::value,
                                          decltype(c)::value,
                                          decltype(t)::value>(
        static_cast<int*>(geo));
  });
}

// in, out: complex64 [n1, n2] as float2, ``in`` 16-byte aligned (TMA);
// thr: float32 [1]; keep: uint8 [n1, n2] or null; pm_c, pm_cw: complex64
// [n1, n2] or both null; chirp: 1 to multiply by the chirp (c_dm = D 1e6
// dm / f_c^2).  n1 = 4096 or 8192, n2 a power of two in [4096, 65536].
SRTB_EXPORT int srtb_fft2_pass2_spectrum(
    const void* in, void* out, const void* thr, const void* keep,
    const void* pm_c, const void* pm_cw, long long n1, long long n2,
    float norm, int chirp, double f_min, double df, double f_c, double c_dm,
    void* stream) {
  if (n1 != (1 << 12) && n1 != (1 << 13)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  srtb::rows::SpectrumArgs a = {};
  a.in = static_cast<const float2*>(in);
  a.out = static_cast<float2*>(out);
  a.thr = static_cast<const float*>(thr);
  a.keep = static_cast<const uint8_t*>(keep);
  a.pm_c = static_cast<const float2*>(pm_c);
  a.pm_cw = static_cast<const float2*>(pm_cw);
  a.norm = norm;
  a.chirp = chirp;
  a.f_min = f_min;
  a.df = df;
  a.f_c = f_c;
  a.c_dm = c_dm;
  a.n1 = static_cast<int>(n1);
  a.m = n1 * n2;
  const auto s = static_cast<cudaStream_t>(stream);
  return srtb::rows::spectrum_by_length(n2, [&](auto log_n, auto c, auto t) {
    return srtb::rows::run_spectrum<decltype(log_n)::value,
                                    decltype(c)::value,
                                    decltype(t)::value>(a, s);
  });
}

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
// Design: paired rows.  The TPU kernel transforms each block of rows and
// also its mirror rows, which reads the intermediate twice and does the
// row FFTs twice.  Here one thread-block cluster holds the row pair
// {k1, n1 - k1} (rows 0 and n1/2 pair with themselves): each half of the
// cluster is B6's row FFT (fft_rows.cuh) on C = n2 / N CTAs (N = min(n2,
// 2^14) values a CTA; C = 1, 2 or 4), so the cluster has 2C CTAs, 8 at
// n2 = 65536 (the portable maximum).  After the last Stockham pass each
// CTA puts its outputs Z[C k + q] (q its rank in the row) into its own
// shared memory; after a cluster barrier each thread reads the mirror
// value of each of its bins from the other half's shared memory
// (distributed shared memory: for k1 >= 1, CTA C - 1 - q of the mirror row
// at local index N - 1 - k), assembles X and writes it.  Each row is read
// and transformed once.  The two self-paired rows are transformed by both
// halves, and only the first half writes.  The epilogue reads its own
// values back from shared memory rather than keeping the last pass's
// registers live, so that the float64 chirp does not spill.
#include "fft_rows.cuh"

namespace srtb {
namespace fft {
namespace {

struct SpectrumArgs {
  const float2* in;      // B [n1, n2]
  float2* out;           // S [n1, n2]
  const float2* tw;      // exp(-2 pi i j / n2), j < n2
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

template <int LOG_N, int C>
__global__ void __launch_bounds__(Plan<LOG_N, C>::THREADS,
                                  Plan<LOG_N, C>::MIN_CTAS)
    fft2_spectrum_kernel(SpectrumArgs a) {
  using P = Plan<LOG_N, C>;
  constexpr int N = P::N;
  constexpr int L = P::L;
  constexpr int THREADS = P::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s = reinterpret_cast<float2*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int crank = static_cast<int>(blockIdx.x % (2 * C));
  const int half = crank / C;  // 0: row w, 1: its mirror row
  const int q = crank % C;     // rank within the row
  const int w = static_cast<int>(blockIdx.x / (2 * C));  // 0 ... n1 / 2
  const int row = half == 0 ? w : (a.n1 - w) % a.n1;
  const float2* in = a.in + static_cast<long long>(row) * L;

  if constexpr (C > 1) {
    // B6's cross stage within this half: positions j of this CTA's range
    // [q N/C, (q+1) N/C), y_p[j] = w_L^{pj} sum_r x[j + rN] w_C^{pr} into
    // CTA p of the half
    constexpr int J = N / C;
    float2* rem[C];
#pragma unroll
    for (int p = 0; p < C; ++p) rem[p] = cluster.map_shared_rank(s, half * C + p);
#pragma unroll
    for (int jj = 0; jj < J / THREADS; ++jj) {
      const int j = q * J + tid + jj * THREADS;
      float2 x[C];
#pragma unroll
      for (int r = 0; r < C; ++r) x[r] = in[j + r * N];
#pragma unroll
      for (int p = 0; p < C; ++p) {
        float2 acc = x[0];
#pragma unroll
        for (int r = 1; r < C; ++r) {
          acc = cadd(acc, cmul(x[r], root16<false>((p * r % C) * (16 / C))));
        }
        rem[p][pad(j)] = p == 0 ? acc : cmul(acc, twiddle<false>(a.tw, p * j));
      }
    }
    cluster.sync();
  }
  // the local transform; with C = 1 the first pass reads the row itself
  P::template passes<0, false>(s, a.tw, C == 1 ? in : nullptr);
  {
    float2 u[P::LAST_BPT][P::LAST_R];
    P::template load_dft<P::PASSES - 1, false>(s, a.tw, nullptr, u);
    __syncthreads();  // every read of the last pass precedes the writes
#pragma unroll
    for (int b = 0; b < P::LAST_BPT; ++b) {
#pragma unroll
      for (int r = 0; r < P::LAST_R; ++r) {
        s[pad(tid + b * THREADS + r * P::LAST_T)] = u[b][r];
      }
    }
  }
  cluster.sync();  // every CTA's Z[C k + q] is in its shared memory

  if (half == 0 || (w != 0 && 2 * w != a.n1)) {
    const float t = __ldg(a.thr);
    const int other = (1 - half) * C;
    const long long base = static_cast<long long>(row) * L;
    const float inv_m = 1.0f / static_cast<float>(a.m);  // a power of two
#pragma unroll 2
    for (int k = tid; k < N; k += THREADS) {
      const int k2 = C * k + q;
      const int mc = row == 0 ? ((L - k2) & (L - 1)) : (L - 1 - k2);
      const float2 z = s[pad(k)];
      const float2 zm =
          cluster.map_shared_rank(s, other + mc % C)[pad(mc / C)];
      // E = (Z + conj M) / 2, O = -i (Z - conj M) / 2
      const float2 e = make_float2(0.5f * (z.x + zm.x), 0.5f * (z.y - zm.y));
      const float2 o = make_float2(0.5f * (z.y + zm.y), -0.5f * (z.x - zm.x));
      const long long bin = static_cast<long long>(k2) * a.n1 + row;
      float2 x;
      if (a.pm_c != nullptr) {
        x = cadd(cmul(__ldg(a.pm_c + base + k2), e),
                 cmul(__ldg(a.pm_cw + base + k2), o));
      } else {
        float sn, cs;
        sincospif(-__ll2float_rn(bin) * inv_m, &sn, &cs);
        x = cadd(e, cmul(make_float2(cs, sn), o));
      }
      float scale = (srtb::power(x) <= t) ? a.norm : 0.0f;
      if (a.keep != nullptr && a.keep[base + k2] == 0) scale = 0.0f;
      x = make_float2(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale));
      if (a.chirp) {
        x = srtb::rotate(x, srtb::chirp(bin, a.f_min, a.df, a.f_c, a.c_dm));
      }
      a.out[base + k2] = x;
    }
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

template <int LOG_N, int C>
int run_spectrum(const SpectrumArgs& a, cudaStream_t stream) {
  using P = Plan<LOG_N, C>;
  auto kernel = fft2_spectrum_kernel<LOG_N, C>;
  constexpr size_t smem = P::SMEM_VALUES * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((a.n1 / 2 + 1) * 2 * C));
  cfg.blockDim = dim3(P::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2 * C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fft
}  // namespace srtb

// in, out: complex64 [n1, n2] as float2; tw: complex64 [n2],
// exp(-2 pi i j / n2); thr: float32 [1]; keep: uint8 [n1, n2] or null;
// pm_c, pm_cw: complex64 [n1, n2] or both null; chirp: 1 to multiply by
// the chirp (c_dm = D 1e6 dm / f_c^2).  n1 = 4096 or 8192, n2 a power of
// two in [4096, 65536].
SRTB_EXPORT int srtb_fft2_pass2_spectrum(
    const void* in, void* out, const void* tw, const void* thr,
    const void* keep, const void* pm_c, const void* pm_cw, long long n1,
    long long n2, float norm, int chirp, double f_min, double df, double f_c,
    double c_dm, void* stream) {
  if (n1 != (1 << 12) && n1 != (1 << 13)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  srtb::fft::SpectrumArgs a = {};
  a.in = static_cast<const float2*>(in);
  a.out = static_cast<float2*>(out);
  a.tw = static_cast<const float2*>(tw);
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
  switch (n2) {
    case 1 << 12: return srtb::fft::run_spectrum<12, 1>(a, s);
    case 1 << 13: return srtb::fft::run_spectrum<13, 1>(a, s);
    case 1 << 14: return srtb::fft::run_spectrum<14, 1>(a, s);
    case 1 << 15: return srtb::fft::run_spectrum<14, 2>(a, s);
    case 1 << 16: return srtb::fft::run_spectrum<14, 4>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B7: the B6 row FFT with the de-window multiply and the per-row power
// moments sum |x|^2, sum |x|^4 (float64 accumulation rounded to float32,
// as K3 and B8 accumulate them), computed while the row is on chip
// (replaces srtb_tpu/ops/pallas_fft.py fft_rows_stats_ri, pallas_call
// :546).  The TPU kernel's [B, 128] lane partials were a layout artifact;
// here each row's sums are complete.
//
// Bound: bytes.  The rows are read once and written once, 16 B a value,
// plus 8 B of sums a row ([2^11, 2^15] on unfused_2^27: 1.07e9 B, 0.321
// ms at 3.35 TB/s); the float64 moments are 3 operations a value.
//
// Design: an epilogue of the row-FFT core (fft_rows_sm90.cuh, B6/B10's
// kernels with one more step): 2^13 values a CTA, C = L / 2^13 CTAs a row
// on a cluster (one CTA at 2^12 and 2^13), 256 threads, two CTAs an SM,
// the row loaded by TMA, the cross-CTA radix-C step, three in-place
// Stockham passes with sincospif twiddles.  A row's sums do not gate its
// write, so unlike B8 no CTA persists: one row a CTA or a cluster, as B6
// launches it.  The epilogue runs on pass 2's registers (X[C k + rank]):
// the de-window and the float64 moments (dewindow_moments, B8's too),
// then the fixed-order CTA reduction.  At C = 1 the row is stored
// straight from the registers and thread 0 writes the sums.  At C > 1
// each CTA pushes its two sums into rank 0's shared memory through DSMEM
// before the barrier that precedes the exchange, and rank 0 adds the C of
// them in rank order after the barrier that closes it: no extra cluster
// barrier, no float atomics; then every CTA stores its contiguous block.
// The cross step keeps the core's product twiddles (w_L^{pj} as powers of
// w_L^j): B7's sums are over a whole row, so the twiddles' rounding
// averages out where B8's per-bin time series did not (PERF.md).
#include "fft_rows_sm90.cuh"

namespace srtb {
namespace rows {

namespace {

using fft::block_sum2;
using fft::cluster_smem;

struct StatsArgs {
  const float2* in;  // [batch, L], 16-byte aligned (TMA)
  float2* out;
  const float* dw;   // reciprocal de-window [L] or null
  float* s2;         // per-row sums, float32 [batch]
  float* s4;
};

// Row blockIdx.x / C on C CTAs (a cluster when C > 1).
template <int LOG_N, int C, bool INV>
__global__ void __launch_bounds__(256, Geometry<LOG_N, C>::CTAS_PER_SM)
    stats_kernel(StatsArgs a) {
  using G = Geometry<LOG_N, C>;
  using P2 = typename G::template Pass<2>;
  constexpr int N = G::N;
  constexpr int THREADS = G::THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float2* const buf = reinterpret_cast<float2*>(smem_raw);
  __shared__ __align__(8) uint64_t full;
  __shared__ double red[2 * (THREADS / 32)];
  __shared__ double parts[C][2];  // the row's CTAs' sums, pushed to rank 0
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(blockIdx.x % C);
  const long long row = blockIdx.x / C;
  if (tid == 0) {
    mbar_init(&full, 1);
    mbar_init_fence();
    issue_row_load<G>(buf, a.in + row * G::L, rank, &full);
  }
  __syncthreads();
  float2* rbuf[C];
#pragma unroll
  for (int p = 0; p < C; ++p) rbuf[p] = cluster_smem<C>(buf, p);
  mbar_wait(&full, 0);
  if constexpr (C > 1) {
    cross_step<G, INV>(buf, rbuf, rank);
  }
  LastPass<G> u2;
  local_fft<G, INV>(buf, u2);
  double p2;
  double p4;
  dewindow_moments<G>(u2, a.dw, rank, p2, p4);
  float2* const out = a.out + row * G::L + rank * N;
  if constexpr (C == 1) {
#pragma unroll
    for (int b = 0; b < P2::BPT; ++b) {
#pragma unroll
      for (int r = 0; r < P2::R; ++r) {
        out[tid + b * THREADS + r * P2::T] = u2[b][r];
      }
    }
    block_sum2<THREADS>(p2, p4, red);
    if (tid == 0) {
      a.s2[row] = static_cast<float>(p2);
      a.s4[row] = static_cast<float>(p4);
    }
  } else {
    block_sum2<THREADS>(p2, p4, red);
    if (tid == 0) {
      double* const part = cluster_smem<C>(&parts[0][0], 0) + 2 * rank;
      part[0] = p2;
      part[1] = p4;
    }
    // every CTA of the row has read its buffer, and its sums are posted
    cg::this_cluster().sync();
    exchange<G>(rbuf, rank, u2);
    // every output block is assembled; after this barrier no CTA touches
    // another's shared memory, so each may leave when its stores are
    // issued
    cg::this_cluster().sync();
    if (rank == 0 && tid == 0) {
      double s2 = 0.0;
      double s4 = 0.0;
#pragma unroll
      for (int q = 0; q < C; ++q) {  // fixed order
        s2 += parts[q][0];
        s4 += parts[q][1];
      }
      a.s2[row] = static_cast<float>(s2);
      a.s4[row] = static_cast<float>(s4);
    }
#pragma unroll 4
    for (int i = tid; i < N; i += THREADS) out[i] = buf[block_pos<G>(i)];
  }
}

template <int LOG_N, int C>
int configure_stats(int* geo) {
  using G = Geometry<LOG_N, C>;
  for (auto k : {&stats_kernel<LOG_N, C, false>,
                 &stats_kernel<LOG_N, C, true>}) {
    const int rc = prepare(k, G::SMEM);
    if (rc != 0) return rc;
  }
  if (geo == nullptr) return 0;
  return query(&stats_kernel<LOG_N, C, true>, C, G::N, G::THREADS, G::SMEM,
               geo);
}

template <int LOG_N, int C, bool INV>
int run_stats(const StatsArgs& a, long long batch, cudaStream_t stream) {
  using G = Geometry<LOG_N, C>;
  const int rc = configure_stats<LOG_N, C>(nullptr);
  if (rc != 0) return rc;
  // one row a CTA or a cluster
  return launch_on_clusters(&stats_kernel<LOG_N, C, INV>, batch * C, C,
                            G::THREADS, G::SMEM, stream, a);
}

}  // namespace
}  // namespace rows
}  // namespace srtb

// The launch geometry of B7 at rows of ``length`` (int32 [8], the fields
// of srtb_fft_rows_geometry): CTAs a cluster, values a CTA, threads, CTAs
// an SM, CTAs (C = 1) or clusters the card holds at once, registers,
// local bytes, dynamic shared bytes.
SRTB_EXPORT int srtb_fft_rows_stats_geometry(long long length, void* geo) {
  return srtb::rows::by_length(length, [&](auto log_n, auto c) {
    return srtb::rows::configure_stats<decltype(log_n)::value,
                                       decltype(c)::value>(
        static_cast<int*>(geo));
  });
}

// in, out: complex64 [batch, length], ``in`` 16-byte aligned (TMA); dw:
// float32 [length] reciprocal de-window or null; s2, s4: float32 [batch].
SRTB_EXPORT int srtb_fft_rows_stats(const void* in, void* out, const void* dw,
                                    void* s2, void* s4, long long batch,
                                    long long length, int inverse,
                                    void* stream) {
  if (batch <= 0) return 0;
  srtb::rows::StatsArgs a = {};
  a.in = static_cast<const float2*>(in);
  a.out = static_cast<float2*>(out);
  a.dw = static_cast<const float*>(dw);
  a.s2 = static_cast<float*>(s2);
  a.s4 = static_cast<float*>(s4);
  const auto s = static_cast<cudaStream_t>(stream);
  return srtb::rows::by_length(length, [&](auto log_n, auto c) {
    constexpr int LN = decltype(log_n)::value;
    constexpr int CC = decltype(c)::value;
    return inverse ? srtb::rows::run_stats<LN, CC, true>(a, batch, s)
                   : srtb::rows::run_stats<LN, CC, false>(a, batch, s);
  });
}

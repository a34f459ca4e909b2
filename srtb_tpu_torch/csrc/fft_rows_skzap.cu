// B8: the whole waterfall tail in one launch (replaces
// srtb_tpu/ops/pallas_fft.py fft_rows_skzap_ri, pallas_call :278): per row
// the row FFT (inverse on the waterfall), the de-window, the complete SK
// moments (reduced across the cluster before anything is written), the
// verdict, the zap as a select (NaN/Inf rows become exactly 0), the zap
// flag and the pre-zap first-sample power; over rows, the power time
// series of the kept rows.
//
// Bound: bytes.  The rows are read once and written once (16 B a value;
// [2^11, 2^15] on the fused 2^27 paths: 1.07e9 B, 0.321 ms at 3.35 TB/s).
//
// Design: an epilogue of the row-FFT core (fft_rows_sm90.cuh, B6/B10's:
// 2^13 values a CTA, C = L / 2^13 CTAs a row (one at 2^12 and 2^13), 256
// threads, two CTAs an SM, rows loaded by TMA, three in-place Stockham
// passes with sincospif twiddles, the cross-CTA radix-C step and the
// final DSMEM exchange).  The time series has to be summed in a fixed
// order without float atomics, and the core is one row a cluster: kept
// so, the per-row partial series would be [rows, L] floats (256 MiB at
// [2^11, 2^15]) written and read again.  So the clusters are persistent
// and loop over their rows (row = group, group + groups, ...), each row
// loaded by TMA into the buffer the previous row's epilogue has finished
// with; groups is the number of clusters the card holds at once (the
// occupancy query, srtb_fft_rows_skzap_geometry), so that one wave covers
// every row, and the other cluster on the same SMs works while one loads.
// A thread owns the same output positions of its CTA in every row (C = 1:
// k = tid + r T of pass 2's registers; C > 1: X[rank N + i], i = tid + k
// THREADS, of the exchanged block), and keeps their float32 partial
// series in shared memory (N floats, so 100 KB a CTA at N = 2^13: still
// two CTAs an SM).  The row's moments come from pass 2's registers (the
// row's values X[Ck + rank], de-windowed there; dewindow_moments, B7's
// too) in float64 and a fixed-order CTA reduction; each CTA pushes its sums into every CTA of
// the row through DSMEM before the barrier that precedes the exchange, and
// every CTA adds the C of them in rank order after the one that closes
// it.  At the end each cluster writes its partial series to
// ts_part[group] and a second, small kernel adds the groups in group
// order in float64.  The cross step makes each twiddle w_L^{pj} by one
// sincospif of its exact argument rather than as a power of w_L^j: the
// core's products lose enough to move the time series by 1e-6 relative
// at 2^15 and 2^16 (PERF.md).
#include "fft_rows_sm90.cuh"

namespace srtb {
namespace rows {

namespace {

using fft::block_sum2;
using fft::cluster_barrier;
using fft::cluster_smem;

struct SkZapArgs {
  const float2* in;   // [batch, L], 16-byte aligned (TMA)
  float2* out;
  const float* dw;    // reciprocal de-window [L] or null
  uint8_t* zapf;      // per-row zap flag [batch]
  float* fs0;         // per-row pre-zap first-sample power [batch]
  float* ts_part;     // per-group partial series [groups, L]
  float thr_low;      // SK acceptance bounds
  float thr_high;
  long long batch;
};

template <int LOG_N, int C, bool INV>
__global__ void __launch_bounds__(256, Geometry<LOG_N, C>::CTAS_PER_SM)
    skzap_kernel(SkZapArgs a) {
  using G = Geometry<LOG_N, C>;
  using P2 = typename G::template Pass<2>;
  constexpr int N = G::N;
  constexpr int L = G::L;
  constexpr int THREADS = G::THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float2* const buf = reinterpret_cast<float2*>(smem_raw);
  float* const tsl = reinterpret_cast<float*>(buf + G::BUF_VALUES);  // [N]
  __shared__ __align__(8) uint64_t full;
  __shared__ double red[2 * (THREADS / 32)];
  __shared__ double parts[C][2];  // the row's CTAs' sums, pushed here
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(blockIdx.x % C);
  const long long group = blockIdx.x / C;
  const long long groups = gridDim.x / C;
#pragma unroll 4
  for (int i = tid; i < N; i += THREADS) tsl[i] = 0.0f;
  if (tid == 0) {
    mbar_init(&full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  float2* rbuf[C];
#pragma unroll
  for (int q = 0; q < C; ++q) rbuf[q] = cluster_smem<C>(buf, q);
  unsigned parity = 0;
  for (long long row = group; row < a.batch; row += groups, parity ^= 1) {
    // every read of the buffer for the previous row is done (the barrier
    // closing that row); its generic-proxy writes precede the TMA's
    if (tid == 0) {
      fence_proxy_async();
      issue_row_load<G>(buf, a.in + row * L, rank, &full);
    }
    mbar_wait(&full, parity);
    if constexpr (C > 1) {
      cross_step<G, INV, true>(buf, rbuf, rank);
    }
    LastPass<G> u2;
    local_fft<G, INV>(buf, u2);
    double p2;
    double p4;
    dewindow_moments<G>(u2, a.dw, rank, p2, p4);
    block_sum2<THREADS>(p2, p4, red);
    if (tid == 0) {
#pragma unroll
      for (int q = 0; q < C; ++q) {
        double* const part = cluster_smem<C>(&parts[0][0], q) + 2 * rank;
        part[0] = p2;
        part[1] = p4;
      }
    }
    // C = 1: the sums are posted and every pass-2 read is done; C > 1:
    // besides, every CTA of the row has read its buffer
    cluster_barrier<C>();
    if constexpr (C > 1) {
      exchange<G>(rbuf, rank, u2);
      cg::this_cluster().sync();  // every block is assembled
    }
    double s2 = 0.0;
    double s4 = 0.0;
#pragma unroll
    for (int q = 0; q < C; ++q) {  // fixed order: every CTA agrees
      s2 += parts[q][0];
      s4 += parts[q][1];
    }
    const float s2f = static_cast<float>(s2);
    const float s4f = static_cast<float>(s4);
    // the verdict as rfi.sk_zap_decision spells it in float32
    const float sk = __fdiv_rn(__fmul_rn(static_cast<float>(L), s4f),
                               __fmul_rn(s2f, s2f));
    const bool zap = (sk > a.thr_high) || (sk < a.thr_low);
    float2* const out = a.out + row * L + rank * N;
    float2 first = make_float2(0.0f, 0.0f);  // X[0] at rank 0, thread 0
    if constexpr (C == 1) {
#pragma unroll
      for (int b = 0; b < P2::BPT; ++b) {
#pragma unroll
        for (int r = 0; r < P2::R; ++r) {
          const int k = tid + b * THREADS + r * P2::T;
          const float2 x = u2[b][r];
          out[k] = zap ? make_float2(0.0f, 0.0f) : x;
          tsl[k] = __fadd_rn(tsl[k], zap ? 0.0f : srtb::power(x));
        }
      }
      first = u2[0][0];
    } else {
#pragma unroll 4
      for (int i = tid; i < N; i += THREADS) {
        const float2 x = buf[block_pos<G>(i)];
        out[i] = zap ? make_float2(0.0f, 0.0f) : x;
        tsl[i] = __fadd_rn(tsl[i], zap ? 0.0f : srtb::power(x));
      }
      first = buf[0];
    }
    if (rank == 0 && tid == 0) {
      a.zapf[row] = zap ? 1 : 0;
      a.fs0[row] = srtb::power(first);  // output 0, before the zap
    }
    __syncthreads();  // every read of the buffer precedes the next load
  }
#pragma unroll 4
  for (int i = tid; i < N; i += THREADS) {
    a.ts_part[group * L + rank * N + i] = tsl[i];
  }
  // no CTA leaves while another may still read its shared memory
  cluster_barrier<C>();
}

// ts[t] = sum over groups g of ts_part[g, t], in g order, in float64.
__global__ void __launch_bounds__(srtb::kThreads)
    ts_reduce_kernel(const float* __restrict__ part, float* __restrict__ ts,
                     long long groups, long long length) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= length) return;
  double acc = 0.0;
  for (long long g = 0; g < groups; ++g) acc += part[g * length + t];
  ts[t] = static_cast<float>(acc);
}

template <int LOG_N, int C>
constexpr size_t skzap_smem() {
  return Geometry<LOG_N, C>::SMEM + Geometry<LOG_N, C>::N * sizeof(float);
}

template <int LOG_N, int C>
int configure_skzap(int* geo) {
  constexpr size_t smem = skzap_smem<LOG_N, C>();
  for (auto k : {&skzap_kernel<LOG_N, C, false>,
                 &skzap_kernel<LOG_N, C, true>}) {
    const int rc = prepare(k, smem);
    if (rc != 0) return rc;
  }
  if (geo == nullptr) return 0;
  return query(&skzap_kernel<LOG_N, C, true>, C, Geometry<LOG_N, C>::N,
               Geometry<LOG_N, C>::THREADS, smem, geo);
}

template <int LOG_N, int C, bool INV>
int run_skzap(const SkZapArgs& a, long long groups, cudaStream_t stream) {
  const int rc = configure_skzap<LOG_N, C>(nullptr);
  if (rc != 0) return rc;
  return launch_on_clusters(&skzap_kernel<LOG_N, C, INV>, groups * C, C,
                            Geometry<LOG_N, C>::THREADS,
                            skzap_smem<LOG_N, C>(), stream, a);
}

}  // namespace
}  // namespace rows
}  // namespace srtb

// The launch geometry of B8 at rows of ``length`` (int32 [8], the fields
// of srtb_fft_rows_geometry): CTAs a cluster, values a CTA, threads, CTAs
// an SM, CTAs (C = 1) or clusters the card holds at once — the number of
// groups to launch — registers, local bytes, dynamic shared bytes.
SRTB_EXPORT int srtb_fft_rows_skzap_geometry(long long length, void* geo) {
  return srtb::rows::by_length(length, [&](auto log_n, auto c) {
    return srtb::rows::configure_skzap<decltype(log_n)::value,
                                       decltype(c)::value>(
        static_cast<int*>(geo));
  });
}

// in, out: complex64 [batch, length], ``in`` 16-byte aligned (TMA); dw:
// float32 [length] reciprocal de-window or null; zapf: uint8 [batch];
// fs0: float32 [batch]; ts_part: float32 [groups, length] scratch; ts:
// float32 [length].  Row r belongs to group r mod groups, 1 <= groups <=
// batch.
SRTB_EXPORT int srtb_fft_rows_skzap(const void* in, void* out, const void* dw,
                                    void* zapf, void* fs0, void* ts_part,
                                    void* ts, long long batch,
                                    long long length, int inverse,
                                    long long groups, float thr_low,
                                    float thr_high, void* stream) {
  if (batch <= 0) return 0;
  if (groups <= 0 || groups > batch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  srtb::rows::SkZapArgs a = {};
  a.in = static_cast<const float2*>(in);
  a.out = static_cast<float2*>(out);
  a.dw = static_cast<const float*>(dw);
  a.zapf = static_cast<uint8_t*>(zapf);
  a.fs0 = static_cast<float*>(fs0);
  a.ts_part = static_cast<float*>(ts_part);
  a.thr_low = thr_low;
  a.thr_high = thr_high;
  a.batch = batch;
  const auto s = static_cast<cudaStream_t>(stream);
  const int rc = srtb::rows::by_length(length, [&](auto log_n, auto c) {
    constexpr int LN = decltype(log_n)::value;
    constexpr int CC = decltype(c)::value;
    return inverse ? srtb::rows::run_skzap<LN, CC, true>(a, groups, s)
                   : srtb::rows::run_skzap<LN, CC, false>(a, groups, s);
  });
  if (rc != 0) return rc;
  const long long blocks = (length + srtb::kThreads - 1) / srtb::kThreads;
  srtb::rows::ts_reduce_kernel<<<static_cast<int>(blocks), srtb::kThreads,
                                 0, s>>>(static_cast<const float*>(ts_part),
                                         static_cast<float*>(ts), groups,
                                         length);
  return static_cast<int>(cudaGetLastError());
}

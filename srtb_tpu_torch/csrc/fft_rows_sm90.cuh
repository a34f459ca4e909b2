// B6 and B10: the plain batched row FFT (complex64 [batch, L], L = 2^12
// ... 2^16, forward or inverse, unnormalized), written for Hopper.
//
// Replaces the TPU kernels
//   B6  srtb_tpu/ops/pallas_fft.py:485  fft_rows_ri  (pallas_call :496)
//   B10 srtb_tpu/ops/pallas_fft2.py:542 pass2_2d     (pallas_call :571)
// which compute the same function (B10 on pass 1's [n1, n2] rows).  Its
// phases (the TMA row load, the cross step, the local FFT, the exchange)
// are also the transform of B7 (fft_rows_stats.cu), B8
// (fft_rows_skzap.cu) and B12 (fft2_spectrum.cu), which add their
// epilogues on pass 2's registers and the exchanged blocks.
//
// Bound: bytes.  Each point is read once and written once, 16 B a point
// (2^29 points: 8.59 GB, 2.56 ms at 3.35 TB/s); the ~5 log2(L) float32
// operations a point are a tenth of that time.  The first design (a
// Stockham kernel of radix 16/8 with a twiddle table, since retired)
// reached 71-78% of the bound at 2^12-2^13 and 24% at 2^16.  What held
// it back, and what this kernel does instead:
//
// 1. Load, passes and store ran in sequence in every CTA, one row a CTA
//    and one CTA an SM at most lengths, the first pass reading device
//    memory itself.  Here a row (or a cluster's slice of it) comes into
//    shared memory by TMA bulk copies (cp.async.bulk ... mbarrier::
//    complete_tx::bytes, one a row or a slice) tracked by an mbarrier, and
//    every length runs two CTAs an SM (one padded buffer a CTA, 68 KB at
//    most, the passes in place; 128 registers for 32 values a thread), so
//    that one CTA's load overlaps the other's passes and stores.  The
//    first design kept persistent CTAs and clusters with a ring of two
//    TMA-filled stage buffers (one CTA an SM); on an H100 it was slower at
//    every length, at C = 1 even when it only copied the rows.
// 2. Four shared-memory passes a row.  Here the local transform of N =
//    min(L, 2^13) values is three Stockham passes, radix 16·16·16 (N =
//    2^12) or 16·16·32 (N = 2^13), 256 threads holding 16 or 32 values
//    each; the first pass reads the TMA-filled buffer in natural order
//    (contiguous, so no padding is needed there), the passes' writes use
//    the padded layout (one value in 16).  Every register index is a
//    compile-time constant.
// 3. Clusters stored at a stride of C.  Rows of 2^14 ... 2^16 run on
//    clusters of C = 2, 4, 8 CTAs, 2^13 values a CTA.  The cross-CTA
//    radix-C step stays first (decimation in frequency: CTA r TMA-loads
//    the C contiguous slices x[qN + rN/C, qN + (r+1)N/C), forms y_p[j] =
//    w_L^{pj} sum_q x[j + qN] w_C^{pq} in registers and, once every CTA
//    has read its slices, pushes it into CTA p's buffer, whose local FFT
//    gives X[Ck + p]); after the last pass every CTA pushes its outputs
//    through distributed shared memory into the buffer of the CTA that
//    owns them, laid out p-major with a row stride of N/C + 4 values (so
//    both the pushes and the reads are free of bank conflicts), and CTA p
//    stores the contiguous block X[pN, (p+1)N) with coalesced stores.
//    Four cluster barriers a row, the last before any CTA may leave; the
//    other cluster on the same SMs works while one waits.  The DSMEM
//    all-to-all costs about what the HBM traffic costs, so the clusters
//    stay further from the bound than C = 1.
// 4. Twiddles from an L-entry table, four loads a butterfly.  Here no
//    table: a pass's twiddles depend on the thread, not the row, so each
//    thread computes its base powers just before the pass (three
//    sincospif of exact arguments and four products) and forms w^r with
//    at most two more products; the cross step's w_L^{j} is one sincospif
//    of the exact 2 j / L a position, its powers by products.
#pragma once

#include <cooperative_groups.h>

#include <initializer_list>
#include <type_traits>

#include "fft_rows.cuh"

namespace srtb {
namespace rows {

namespace cg = cooperative_groups;
using fft::cadd;
using fft::cmul;
using fft::csub;
using fft::log2c;
using fft::pad;

// exp(-2 pi i k / 32), k = 0..15 (float32, correctly rounded)
static __constant__ float2 kRoot32[16] = {
    {1.0f, 0.0f},
    {9.807852507e-01f, -1.950903237e-01f},
    {9.238795042e-01f, -3.826834261e-01f},
    {8.314695954e-01f, -5.555702448e-01f},
    {7.071067691e-01f, -7.071067691e-01f},
    {5.555702448e-01f, -8.314695954e-01f},
    {3.826834261e-01f, -9.238795042e-01f},
    {1.950903237e-01f, -9.807852507e-01f},
    {0.0f, -1.0f},
    {-1.950903237e-01f, -9.807852507e-01f},
    {-3.826834261e-01f, -9.238795042e-01f},
    {-5.555702448e-01f, -8.314695954e-01f},
    {-7.071067691e-01f, -7.071067691e-01f},
    {-8.314695954e-01f, -5.555702448e-01f},
    {-9.238795042e-01f, -3.826834261e-01f},
    {-9.807852507e-01f, -1.950903237e-01f},
};

// One radix-2 stage of span S on the bit-reversed array: butterflies
// (J0 + K, J0 + K + S) with the twiddle exp(-+2 pi i K / 2S); every index
// a compile-time constant.
template <int R, bool INV, int S, int J0 = 0, int K = 0>
__device__ __forceinline__ void dit_stage(float2 (&u)[R]) {
  if constexpr (J0 < R) {
    if constexpr (K < S) {
      constexpr int E = K * (32 / (2 * S));
      float2 b = u[J0 + K + S];
      if constexpr (E == 8) {
        b = INV ? make_float2(-b.y, b.x) : make_float2(b.y, -b.x);
      } else if constexpr (E != 0) {
        const float2 w = kRoot32[E];
        b = cmul(b, INV ? make_float2(w.x, -w.y) : w);
      }
      const float2 a = u[J0 + K];
      u[J0 + K] = cadd(a, b);
      u[J0 + K + S] = csub(a, b);
      dit_stage<R, INV, S, J0, K + 1>(u);
    } else {
      dit_stage<R, INV, S, J0 + 2 * S, 0>(u);
    }
  }
}

template <int R, bool INV, int S = 1>
__device__ __forceinline__ void dit_stages(float2 (&u)[R]) {
  if constexpr (S < R) {
    dit_stage<R, INV, S>(u);
    dit_stages<R, INV, 2 * S>(u);
  }
}

// In-register R-point DFT (R = 2 ... 32), natural order in and out.
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&u)[R]) {
  fft::bit_reverse_permute<R, log2c(R)>(u);
  dit_stages<R, INV>(u);
}

// exp(-+2 pi i num / den) for an integer num and a power-of-two den: the
// argument 2 num / den of sincospif is exact.
template <bool INV>
__device__ __forceinline__ float2 root(int num, int den) {
  float s, c;
  sincospif(static_cast<float>(num) * ((INV ? 2.0f : -2.0f) /
                                       static_cast<float>(den)),
            &s, &c);
  return make_float2(c, s);
}

// The twiddles w^r (r < R) of one thread's butterflies in a pass, w =
// exp(-+2 pi i k / PR): w^r = lo[r mod 4] mid[(r / 4) mod 4] hi[r / 16],
// at most two products a twiddle; w, w^4 and w^16 by sincospif, w^2, w^3,
// w^8 and w^12 by one or two products of those.
template <int R, bool INV>
struct PassTwiddle {
  float2 lo[4];
  float2 mid[4];
  float2 hi;

  __device__ __forceinline__ void init(int k, int pr) {
    lo[0] = mid[0] = make_float2(1.0f, 0.0f);
    lo[1] = root<INV>(k, pr);
    lo[2] = cmul(lo[1], lo[1]);
    lo[3] = cmul(lo[2], lo[1]);
    mid[1] = root<INV>(4 * k, pr);
    mid[2] = cmul(mid[1], mid[1]);
    mid[3] = cmul(mid[2], mid[1]);
    hi = R > 16 ? root<INV>(16 * k, pr) : lo[0];
  }

  __device__ __forceinline__ void apply(float2 (&u)[R]) const {
#pragma unroll
    for (int r = 1; r < R; ++r) {
      float2 w = (r & 3) == 0 ? mid[(r >> 2) & 3]
                 : ((r >> 2) & 3) == 0 ? lo[r & 3]
                                       : cmul(lo[r & 3], mid[(r >> 2) & 3]);
      if (r >= 16) w = (r & 15) == 0 ? hi : cmul(w, hi);
      u[r] = cmul(u[r], w);
    }
  }
};

// The geometry of rows of L = C N: N = 2^LOG_N values a CTA, C CTAs a
// cluster (one row a cluster), 256 threads and two CTAs an SM (B12 also
// takes N = 2^14 with 512 threads, one CTA an SM), one padded buffer a
// CTA that a TMA bulk copy fills and the passes transform in place.
template <int LOG_N, int C, int THREADS_ = 256>
struct Geometry {
  static constexpr int N = 1 << LOG_N;
  static constexpr int CTAS = C;                  // a row's CTAs
  static constexpr int L = N * C;
  static constexpr int THREADS = THREADS_;
  static constexpr int CTAS_PER_SM = THREADS_ == 256 ? 2 : 1;
  static constexpr int J = N / C;                 // positions a CTA owns
  static constexpr int SX = J + 4;                // exchange row stride
  static constexpr int BUF_VALUES = N + N / 16;   // padded
  static constexpr size_t SMEM = BUF_VALUES * sizeof(float2);
  static constexpr unsigned ROW_BYTES = N * sizeof(float2);  // a CTA's
  static constexpr int PASSES = 3;

  // radix bits of pass i, the larger radix last (16·16·16, 16·16·32)
  __host__ __device__ static constexpr int bits(int i) {
    return LOG_N / PASSES + (i >= PASSES - LOG_N % PASSES ? 1 : 0);
  }
  __host__ __device__ static constexpr int prefix(int i) {
    int s = 0;
    for (int j = 0; j < i; ++j) s += bits(j);
    return s;
  }
  template <int I>
  struct Pass {
    static constexpr int R = 1 << bits(I);
    static constexpr int P = 1 << prefix(I);  // Stockham stride
    static constexpr int T = N / R;           // butterflies
    static constexpr int BPT = T / THREADS;   // butterflies a thread
    static_assert(BPT >= 1 && T % THREADS == 0, "butterflies a thread");
    static_assert(P <= THREADS, "i mod P must not depend on the butterfly");
  };
  static_assert(LOG_N >= 12 && LOG_N <= 14, "local lengths 2^12 ... 2^14");
  static_assert(C == 1 || C == 2 || C == 4 || C == 8, "cluster sizes");
  static_assert(J % THREADS == 0, "cross step positions a thread");
  static_assert(C * SX <= BUF_VALUES, "the exchange fits the buffer");
  static_assert(ROW_BYTES < (1u << 20), "mbarrier tx count");
};

// ---- TMA bulk copies and mbarriers (PTX) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// global -> this CTA's shared memory, completion counted on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy accesses of shared memory before async-proxy (TMA) ones
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Pass I's reads into registers, twiddle and DFT: butterfly i = tid + b
// THREADS reads src[i + r T] (padded indices unless the buffer still
// holds what TMA or the cross step wrote, in natural order).
template <class G, int I, bool INV, bool PADDED>
__device__ __forceinline__ void pass_load(
    const float2* src, const PassTwiddle<G::template Pass<I>::R, INV>& tw,
    float2 (&u)[G::template Pass<I>::BPT][G::template Pass<I>::R]) {
  using Q = typename G::template Pass<I>;
#pragma unroll
  for (int b = 0; b < Q::BPT; ++b) {
    const int i = threadIdx.x + b * G::THREADS;
#pragma unroll
    for (int r = 0; r < Q::R; ++r) {
      const int at = i + r * Q::T;
      u[b][r] = src[PADDED ? pad(at) : at];
    }
    if constexpr (Q::P > 1) tw.apply(u[b]);
    dft<Q::R, INV>(u[b]);
  }
}

// Pass I's writes: s[(i - i mod P) R + i mod P + r P], padded.
template <class G, int I>
__device__ __forceinline__ void pass_store(
    float2* s,
    const float2 (&u)[G::template Pass<I>::BPT][G::template Pass<I>::R]) {
  using Q = typename G::template Pass<I>;
#pragma unroll
  for (int b = 0; b < Q::BPT; ++b) {
    const int i = threadIdx.x + b * G::THREADS;
    const int k = i & (Q::P - 1);
    const int j = (i - k) * Q::R + k;
#pragma unroll
    for (int r = 0; r < Q::R; ++r) s[pad(j + r * Q::P)] = u[b][r];
  }
}

// ---- the core's phases, shared by B6/B10 and the epilogue kernels (B7 in
// fft_rows_stats.cu, B8 in fft_rows_skzap.cu, B12 in fft2_spectrum.cu) ----

// Thread 0: TMA for this CTA's share of ``row`` (the whole row at C = 1;
// at C > 1 the C slices x[qN + rank J, qN + (rank + 1) J) of it, into
// buf[qJ, (q + 1) J)), completion counted on ``bar``.
template <class G>
__device__ __forceinline__ void issue_row_load(float2* buf, const float2* row,
                                               int rank, uint64_t* bar) {
  mbar_expect_tx(bar, G::ROW_BYTES);
  if constexpr (G::CTAS == 1) {
    bulk_load(buf, row, G::ROW_BYTES, bar);
  } else {
    const float2* src = row + rank * G::J;
#pragma unroll
    for (int q = 0; q < G::CTAS; ++q) {
      bulk_load(buf + q * G::J, src + q * G::N, G::ROW_BYTES / G::CTAS, bar);
    }
  }
}

// C > 1, after the load: the cross step, in registers.  Positions j =
// rank J + jj, x[j + qN] at buf[qJ + jj]; y[t][p] = w_L^{pj} sum_q x[j +
// qN] w_C^{pq}, pushed into row CTA p's buffer (``rbuf[p]``) at j, whose
// local FFT then gives X[Ck + p].  Two cluster barriers: every CTA has
// read its slices before any push, every push lands before any pass.
// w_L^{pj} is w_L^j's p-th power by products, or with EXACT_TW one
// sincospif of the exact argument each (C - 1 of them a position: fewer
// roundings, more time).
template <class G, bool INV, bool EXACT_TW = false>
__device__ __forceinline__ void cross_step(const float2* buf,
                                           float2* const (&rbuf)[G::CTAS],
                                           int rank) {
  constexpr int C = G::CTAS;
  constexpr int J = G::J;
  constexpr int THREADS = G::THREADS;
  constexpr int JT = J / THREADS;  // cross-step positions a thread
  const int tid = threadIdx.x;
  float2 y[JT][C];
#pragma unroll
  for (int t = 0; t < JT; ++t) {
    const int jj = tid + t * THREADS;
#pragma unroll
    for (int q = 0; q < C; ++q) y[t][q] = buf[q * J + jj];
    dft<C, INV>(y[t]);
    if constexpr (EXACT_TW) {
#pragma unroll
      for (int p = 1; p < C; ++p) {
        y[t][p] = cmul(y[t][p], root<INV>(p * (rank * J + jj), G::L));
      }
    } else {
      const float2 w1 = root<INV>(rank * J + jj, G::L);
      float2 w = w1;
#pragma unroll
      for (int p = 1; p < C; ++p) {
        y[t][p] = cmul(y[t][p], w);
        w = cmul(w, w1);
      }
    }
  }
  cg::this_cluster().sync();  // every CTA has read its slices
#pragma unroll
  for (int t = 0; t < JT; ++t) {
#pragma unroll
    for (int p = 0; p < C; ++p) {
      rbuf[p][rank * J + tid + t * THREADS] = y[t][p];
    }
  }
  cg::this_cluster().sync();  // every buffer holds its y_p
}

template <class G>
using LastPass = float2[G::template Pass<2>::BPT][G::template Pass<2>::R];

// The local N-point FFT of the buffer (natural order in): passes 0 and 1
// in place, pass 2's reads, twiddles and DFTs into ``u2``, whose
// butterfly i = tid + b THREADS holds outputs k = i + r T.  The caller
// orders any later write of the buffer after every thread's reads.  The
// twiddles of a pass are made just before it, so that 128 registers hold
// a thread's 32 values without spilling.
template <class G, bool INV>
__device__ __forceinline__ void local_fft(float2* buf, LastPass<G>& u2) {
  using P0 = typename G::template Pass<0>;
  using P1 = typename G::template Pass<1>;
  using P2 = typename G::template Pass<2>;
  const int tid = threadIdx.x;
  const PassTwiddle<P0::R, INV> tw0 = {};  // unused: P = 1
  float2 u0[P0::BPT][P0::R];
  pass_load<G, 0, INV, false>(buf, tw0, u0);
  __syncthreads();
  pass_store<G, 0>(buf, u0);
  __syncthreads();
  float2 u1[P1::BPT][P1::R];
  {
    PassTwiddle<P1::R, INV> tw1;
    tw1.init(tid & (P1::P - 1), P1::P * P1::R);
    pass_load<G, 1, INV, true>(buf, tw1, u1);
  }
  __syncthreads();
  pass_store<G, 1>(buf, u1);
  __syncthreads();
  {
    PassTwiddle<P2::R, INV> tw2;
    tw2.init(tid & (P2::P - 1), P2::P * P2::R);
    pass_load<G, 2, INV, true>(buf, tw2, u2);
  }
}

// C > 1, once every CTA of the row has read its buffer: output k = tid +
// r T of CTA ``rank`` (X[Ck + rank]) goes to the CTA k / J that owns it,
// at position (k mod J) C + rank of that CTA's block, stored p-major with
// a row stride of SX (block_pos).  A cluster barrier must follow before
// any block is read.
template <class G>
__device__ __forceinline__ void exchange(float2* const (&rbuf)[G::CTAS],
                                         int rank, const LastPass<G>& u2) {
  using P2 = typename G::template Pass<2>;
  static_assert(P2::BPT == 1 && P2::T == G::THREADS, "last pass layout");
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < P2::R; ++r) {
    const int o = (r * P2::T) / G::J;  // compile-time: tid < T <= J
    rbuf[o][rank * G::SX + tid + r * P2::T - o * G::J] = u2[0][r];
  }
}

// Where value i of the CTA's output block X[rank N + i] lies in its buffer
// after the exchange (C > 1), or after the epilogue kernels' natural-order
// write of pass 2's registers (C = 1).
template <class G>
__device__ __forceinline__ int block_pos(int i) {
  if constexpr (G::CTAS == 1) {
    return i;
  } else {
    return (i % G::CTAS) * G::SX + i / G::CTAS;
  }
}

// C = 1, pass 2's registers into the buffer in natural order (after a
// barrier that follows every thread's pass-2 reads).
template <class G>
__device__ __forceinline__ void store_natural(float2* buf,
                                              const LastPass<G>& u2) {
  using P2 = typename G::template Pass<2>;
#pragma unroll
  for (int b = 0; b < P2::BPT; ++b) {
#pragma unroll
    for (int r = 0; r < P2::R; ++r) {
      buf[threadIdx.x + b * G::THREADS + r * P2::T] = u2[b][r];
    }
  }
}

// B7's and B8's epilogue on pass 2's registers, u2[b][r] = X[C k + rank]
// (k = tid + b THREADS + r T): each value times the reciprocal de-window
// dw[C k + rank] when dw is given (__fmul_rn, as the plain version
// rounds), and this thread's share of the power moments sum |x|^2, sum
// |x|^4 in float64 (block_sum2 then adds the CTA's in a fixed order).
template <class G>
__device__ __forceinline__ void dewindow_moments(LastPass<G>& u2,
                                                 const float* __restrict__ dw,
                                                 int rank, double& p2,
                                                 double& p4) {
  using P2 = typename G::template Pass<2>;
  p2 = 0.0;
  p4 = 0.0;
#pragma unroll
  for (int b = 0; b < P2::BPT; ++b) {
#pragma unroll
    for (int r = 0; r < P2::R; ++r) {
      if (dw != nullptr) {
        const float d = __ldg(
            dw + G::CTAS * (threadIdx.x + b * G::THREADS + r * P2::T) + rank);
        u2[b][r] = make_float2(__fmul_rn(u2[b][r].x, d),
                               __fmul_rn(u2[b][r].y, d));
      }
      const double pw = srtb::power(u2[b][r]);
      p2 += pw;
      p4 += pw * pw;
    }
  }
}

struct RowArgs {
  const float2* in;
  float2* out;
  long long batch;
};

// C = 1: row blockIdx.x, in place in the CTA's buffer, stored straight
// from pass 2's registers.
template <int LOG_N, bool INV>
__global__ void __launch_bounds__(256, Geometry<LOG_N, 1>::CTAS_PER_SM)
    row_fft_kernel(RowArgs a) {
  using G = Geometry<LOG_N, 1>;
  using P2 = typename G::template Pass<2>;
  constexpr int N = G::N;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float2* const buf = reinterpret_cast<float2*>(smem_raw);
  __shared__ __align__(8) uint64_t full;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  if (tid == 0) {
    mbar_init(&full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) issue_row_load<G>(buf, a.in + row * N, 0, &full);
  mbar_wait(&full, 0);
  LastPass<G> u2;
  local_fft<G, INV>(buf, u2);
  float2* const out = a.out + row * N;
#pragma unroll
  for (int b = 0; b < P2::BPT; ++b) {
#pragma unroll
    for (int r = 0; r < P2::R; ++r) {
      out[tid + b * G::THREADS + r * P2::T] = u2[b][r];
    }
  }
}

// C > 1: row blockIdx.x / C on a cluster of C CTAs; CTA ``rank`` ends
// holding, and stores, the contiguous block X[rank N, (rank + 1) N).
template <int LOG_N, int C, bool INV>
__global__ void __launch_bounds__(256, Geometry<LOG_N, C>::CTAS_PER_SM)
    cluster_fft_kernel(RowArgs a) {
  static_assert(C > 1, "rows of one CTA run row_fft_kernel");
  using G = Geometry<LOG_N, C>;
  constexpr int N = G::N;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float2* const buf = reinterpret_cast<float2*>(smem_raw);
  __shared__ __align__(8) uint64_t full;
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(blockIdx.x % C);
  const long long row = blockIdx.x / C;
  auto cluster = cg::this_cluster();
  if (tid == 0) {
    mbar_init(&full, 1);
    mbar_init_fence();
    issue_row_load<G>(buf, a.in + row * G::L, rank, &full);
  }
  __syncthreads();
  // this CTA's buffer in every CTA of the cluster
  float2* rbuf[C];
#pragma unroll
  for (int p = 0; p < C; ++p) rbuf[p] = cluster.map_shared_rank(buf, p);
  mbar_wait(&full, 0);
  cross_step<G, INV>(buf, rbuf, rank);
  LastPass<G> u2;
  local_fft<G, INV>(buf, u2);
  cluster.sync();  // every CTA has read its buffer
  exchange<G>(rbuf, rank, u2);
  // every output block is assembled; after this barrier no CTA touches
  // another's shared memory, so each may leave when its stores are issued
  cluster.sync();
  float2* const out = a.out + row * G::L + rank * N;
#pragma unroll 4
  for (int i = tid; i < N; i += G::THREADS) out[i] = buf[block_pos<G>(i)];
}

template <int LOG_N, int C, bool INV>
inline auto kernel_of() {
  if constexpr (C == 1) {
    return row_fft_kernel<LOG_N, INV>;
  } else {
    return cluster_fft_kernel<LOG_N, C, INV>;
  }
}

// ---- launching ----

// Geometry of a launch: [CTAs a cluster, N, threads, CTAs an SM, resident
// (CTAs for a cluster of 1, else clusters, that the card holds at once),
// registers, local bytes, shared bytes].
constexpr int kGeometryFields = 8;

// Opt ``kernel`` into ``smem`` bytes of dynamic shared memory.
template <class K>
int prepare(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Fill ``geo`` for ``kernel`` (prepared) on clusters of ``cluster`` CTAs
// of ``values`` values each: the occupancy queries' CTAs an SM and
// resident CTAs or clusters, the compiler's registers and local bytes.
// Fails when the card holds none.
template <class K>
int query(K kernel, int cluster, int values, int threads, size_t smem,
          int* geo) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = per_sm * sms;
  if (cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster * sms);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaFuncAttributes fa = {};
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[kGeometryFields] = {cluster, values, threads, per_sm,
                                     resident, fa.numRegs,
                                     static_cast<int>(fa.localSizeBytes),
                                     static_cast<int>(smem)};
  for (int i = 0; i < kGeometryFields; ++i) geo[i] = vals[i];
  return resident > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// Launch ``kernel`` (prepared) as ``blocks`` CTAs on clusters of
// ``cluster``.
template <class K, class A>
int launch_on_clusters(K kernel, long long blocks, int cluster, int threads,
                       size_t smem, cudaStream_t stream, const A& args) {
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG_N, int C>
int configure(int* geo) {
  using G = Geometry<LOG_N, C>;
  for (auto k : {kernel_of<LOG_N, C, false>(), kernel_of<LOG_N, C, true>()}) {
    const int rc = prepare(k, G::SMEM);
    if (rc != 0) return rc;
  }
  if (geo == nullptr) return 0;
  return query(kernel_of<LOG_N, C, false>(), C, G::N, G::THREADS, G::SMEM,
               geo);
}

template <int LOG_N, int C, bool INV>
int launch(const RowArgs& a, cudaStream_t stream) {
  using G = Geometry<LOG_N, C>;
  const int rc = configure<LOG_N, C>(nullptr);
  if (rc != 0) return rc;
  // one row a CTA or a cluster
  return launch_on_clusters(kernel_of<LOG_N, C, INV>(), a.batch * C, C,
                            G::THREADS, G::SMEM, stream, a);
}

// Rows of 2^12 and 2^13 on one CTA, 2^14 ... 2^16 on clusters of 2, 4, 8
// CTAs of 2^13 values each.
template <class F>
int by_length(long long length, F&& f) {
  switch (length) {
    case 1 << 12: return f(std::integral_constant<int, 12>{},
                           std::integral_constant<int, 1>{});
    case 1 << 13: return f(std::integral_constant<int, 13>{},
                           std::integral_constant<int, 1>{});
    case 1 << 14: return f(std::integral_constant<int, 13>{},
                           std::integral_constant<int, 2>{});
    case 1 << 15: return f(std::integral_constant<int, 13>{},
                           std::integral_constant<int, 4>{});
    case 1 << 16: return f(std::integral_constant<int, 13>{},
                           std::integral_constant<int, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline int geometry(long long length, int* geo) {
  return by_length(length, [&](auto log_n, auto c) {
    return configure<decltype(log_n)::value, decltype(c)::value>(geo);
  });
}

inline int run(const RowArgs& a, long long length, int inverse,
               cudaStream_t stream) {
  if (a.batch <= 0) return 0;
  return by_length(length, [&](auto log_n, auto c) {
    constexpr int LN = decltype(log_n)::value;
    constexpr int CC = decltype(c)::value;
    return inverse ? launch<LN, CC, true>(a, stream)
                   : launch<LN, CC, false>(a, stream);
  });
}

}  // namespace rows
}  // namespace srtb

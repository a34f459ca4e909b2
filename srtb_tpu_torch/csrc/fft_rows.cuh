// B7: batched row FFTs of length L = 2^12 ... 2^16 held in shared memory,
// with the de-window and the per-row power moments as their epilogue; and
// the radix-2 building blocks the Hopper kernels share.
//
// The plain mode (B6, and B10 on the same function) moved to the TMA-fed
// row-FFT core of fft_rows_sm90.cuh, and so did B8 (fft_rows_skzap.cu)
// and B12 (fft2_spectrum.cu) as that core's epilogue kernels.  B7's
// kernel stays here, with Plan and its passes.  B9/B11's column pass runs
// on its own clustered body (fft2.cuh).
//
// Replaces the TPU kernel of srtb_tpu/ops/pallas_fft.py:
//   B7 fft_rows_stats_ri  (pallas_call :546, body _fft_rows_stats_kernel
//                          :145): the row FFT, de-window multiply, per-row
//                          sum |x|^2 and sum |x|^4.
// All transforms are unnormalized in both directions (cuFFT conventions,
// like the TPU kernels).
//
// What the TPU kernel did and what carries over.  It ran each row as two
// DFT-matrix matmuls (L = 128 x L/128) on the MXU because matmul FLOPs
// were the cheap resource there and lane-dim reshapes were not; none of
// that carries over.  What does carry over is the contract: one read and
// one write of each row in device memory, with the whole row resident on
// chip while it is transformed, so the moments are complete before
// anything is written.
//
// Design on Hopper.  Bound: bytes (8 B read + 8 B written per point; a
// radix-16 FFT is ~5 log2(L) flops per point, far below the float32
// rate).  A CTA holds N = min(L, 2^14) complex64 values of a row in shared
// memory (up to 136 KB, opted in past 48 KB).  Rows of 2^15 and 2^16 do
// not fit one SM, so a thread-block cluster of C = L / N = 2 or 4 CTAs
// holds the row, and the CTAs exchange through distributed shared memory:
//   1. cross stage (C > 1): y_p[j] = w_L^{pj} sum_q x[j + qN] w_C^{pq}
//      into CTA p's shared memory, so that FFT_N(y_p)[k] = X[Ck + p] (one
//      radix-C decimation-in-frequency step).  CTA r computes it for the
//      positions j of its own range [rN/C, (r+1)N/C), reading x from
//      device memory (each value once) and writing one value into every
//      CTA of the cluster per position;
//   2. local FFT of length N in the CTA's shared memory: Stockham
//      autosort passes of radix 16/8 (register DFTs, natural-order
//      output, no bit reversal), N / 16 threads each holding 16 values;
//      with C = 1 the first pass reads the row from device memory;
//   3. the last pass stays in registers: the epilogue (de-window, power
//      moments after a cluster-wide reduction) runs there and CTA p writes
//      its outputs X[Ck + p] straight to device memory.
// Twiddles come from a table exp(-2 pi i m / L), m < L, built in float64
// by the wrapper (conjugated for the inverse; four table reads per
// butterfly, the other powers by products); the register DFTs use the
// 16th roots as constants.  Every index into a register array is a
// compile-time constant (the DFT's stages are template recursions): a
// runtime index moves the array to local memory, which made these kernels
// two to three times slower on an H100.  Shared-memory indices are padded
// by one value per 16 (pad()), so the first pass's stride-16 writes do
// not conflict.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace srtb {
namespace fft {

namespace cg = cooperative_groups;

// exp(-2 pi i k / 16), k = 0..15 (float32, correctly rounded)
static __constant__ float2 kRoot16[16] = {
    {1.0f, 0.0f},
    {9.238795042e-01f, -3.826834261e-01f},
    {7.071067691e-01f, -7.071067691e-01f},
    {3.826834261e-01f, -9.238795042e-01f},
    {0.0f, -1.0f},
    {-3.826834261e-01f, -9.238795042e-01f},
    {-7.071067691e-01f, -7.071067691e-01f},
    {-9.238795042e-01f, -3.826834261e-01f},
    {-1.0f, 0.0f},
    {-9.238795042e-01f, 3.826834261e-01f},
    {-7.071067691e-01f, 7.071067691e-01f},
    {-3.826834261e-01f, 9.238795042e-01f},
    {0.0f, 1.0f},
    {3.826834261e-01f, 9.238795042e-01f},
    {7.071067691e-01f, 7.071067691e-01f},
    {9.238795042e-01f, 3.826834261e-01f},
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

template <bool INV>
__device__ __forceinline__ float2 root16(int k) {
  const float2 w = kRoot16[k & 15];
  return INV ? make_float2(w.x, -w.y) : w;
}

template <bool INV>
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                          int m) {
  const float2 w = __ldg(tw + m);
  return INV ? make_float2(w.x, -w.y) : w;
}

__host__ __device__ constexpr int log2c(int r) {
  return r <= 1 ? 0 : 1 + log2c(r >> 1);
}

__host__ __device__ constexpr int bit_reverse(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// The bit-reversal permutation of u, with every index a compile-time
// constant (a runtime index would put u in local memory).
template <int R, int B, int I = 0>
__device__ __forceinline__ void bit_reverse_permute(float2 (&u)[R]) {
  if constexpr (I < R) {
    constexpr int J = bit_reverse(I, B);
    if constexpr (J > I) {
      const float2 t = u[I];
      u[I] = u[J];
      u[J] = t;
    }
    bit_reverse_permute<R, B, I + 1>(u);
  }
}

// One radix-2 stage of span S, butterflies (J0 + K, J0 + K + S) with the
// twiddle exp(-+2 pi i K / 2S); every index a compile-time constant.
template <int R, bool INV, int S, int J0 = 0, int K = 0>
__device__ __forceinline__ void dit_stage(float2 (&u)[R]) {
  if constexpr (J0 < R) {
    if constexpr (K < S) {
      constexpr int E = K * (16 / (2 * S));
      float2 b = u[J0 + K + S];
      if constexpr (E == 4) {
        b = INV ? make_float2(-b.y, b.x) : make_float2(b.y, -b.x);
      } else if constexpr (E != 0) {
        b = cmul(b, root16<INV>(E));
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

// In-register R-point DFT (R = 2, 4, 8, 16), forward exp(-2 pi i jk/R) or
// inverse: radix-2 decimation in time on the bit-reversed array.
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&u)[R]) {
  bit_reverse_permute<R, log2c(R)>(u);
  dit_stages<R, INV>(u);
}

// u[r] *= w^r, r < R, for w = exp(-+2 pi i m / L) = tw[m] (conjugated for
// the inverse): four table reads (w, w^2, w^4, w^8) and w^r =
// w^(r mod 4) w^(r - r mod 4), at most three roundings from the table.
template <int R, bool INV>
__device__ __forceinline__ void twiddle_row(float2 (&u)[R],
                                            const float2* __restrict__ tw,
                                            int m) {
  const float2 one = make_float2(1.0f, 0.0f);
  const float2 w1 = twiddle<INV>(tw, m);
  const float2 w2 = R > 2 ? twiddle<INV>(tw, 2 * m) : one;
  const float2 lo[4] = {one, w1, w2, R > 2 ? cmul(w2, w1) : one};
  const float2 w4 = R > 4 ? twiddle<INV>(tw, 4 * m) : one;
  const float2 w8 = R > 8 ? twiddle<INV>(tw, 8 * m) : one;
  const float2 hi[4] = {one, w4, w8, R > 8 ? cmul(w8, w4) : one};
#pragma unroll
  for (int r = 1; r < R; ++r) {
    const float2 w = (r & 3) == 0 ? hi[r >> 2]
                     : (r >> 2) == 0 ? lo[r & 3]
                                     : cmul(lo[r & 3], hi[r >> 2]);
    u[r] = cmul(u[r], w);
  }
}

// The local transform of N = 2^LOG_N values in one CTA's shared memory,
// within rows of length L = C * N (the twiddle table has L entries).
template <int LOG_N, int C>
struct Plan {
  static constexpr int N = 1 << LOG_N;
  static constexpr int L = N * C;
  // 16 values per thread (one radix-16 or two radix-8 butterflies a
  // pass), 1024 threads an SM: at most 64 registers a thread
  static constexpr int THREADS = N / 16;
  static constexpr int MIN_CTAS = 1024 / THREADS;
  static constexpr int PASSES = (LOG_N + 3) / 4;
  static constexpr int SMEM_VALUES = N + N / 16;  // padded

  // radix bits of pass i: LOG_N spread over PASSES passes, larger first
  __host__ __device__ static constexpr int bits(int i) {
    return LOG_N / PASSES + (i < LOG_N % PASSES ? 1 : 0);
  }
  __host__ __device__ static constexpr int prefix(int i) {
    int s = 0;
    for (int j = 0; j < i; ++j) s += bits(j);
    return s;
  }

  // One Stockham pass (radix R = 2^bits(I), stride p = 2^prefix(I)):
  // butterfly i reads s[i + r N/R], twiddles by w_{pR}^{r (i mod p)} and
  // DFTs; every pass but the last then writes s[(i - i mod p) R + i mod p
  // + r p].  In place: all reads land in registers before the barrier, all
  // writes after it.  The first pass may read the row from device memory
  // (``src``, C = 1: coalesced, consecutive threads read consecutive i).
  template <int I, bool INV>
  static __device__ __forceinline__ void load_dft(
      const float2* s, const float2* __restrict__ tw,
      const float2* __restrict__ src, float2 (&u)[N / (1 << bits(I)) /
                                                  THREADS][1 << bits(I)]) {
    constexpr int R = 1 << bits(I);
    constexpr int P = 1 << prefix(I);
    constexpr int T = N / R;
    constexpr int BPT = T / THREADS;
#pragma unroll
    for (int b = 0; b < BPT; ++b) {
      const int i = threadIdx.x + b * THREADS;
      if (I == 0 && src != nullptr) {
#pragma unroll
        for (int r = 0; r < R; ++r) u[b][r] = src[i + r * T];
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) u[b][r] = s[pad(i + r * T)];
      }
      if constexpr (P > 1) {
        twiddle_row<R, INV>(u[b], tw, (i & (P - 1)) * (L / (P * R)));
      }
      dft<R, INV>(u[b]);
    }
  }

  template <int I, bool INV>
  static __device__ __forceinline__ void pass(float2* s,
                                              const float2* __restrict__ tw,
                                              const float2* __restrict__ src) {
    constexpr int R = 1 << bits(I);
    constexpr int P = 1 << prefix(I);
    constexpr int BPT = N / R / THREADS;
    float2 u[BPT][R];
    load_dft<I, INV>(s, tw, src, u);
    __syncthreads();
#pragma unroll
    for (int b = 0; b < BPT; ++b) {
      const int i = threadIdx.x + b * THREADS;
      const int k = i & (P - 1);
      const int j = (i - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) s[pad(j + r * P)] = u[b][r];
    }
    __syncthreads();
  }

  // Every pass but the last, which stays in registers for the caller.
  template <int I, bool INV>
  static __device__ __forceinline__ void passes(float2* s,
                                                const float2* __restrict__ tw,
                                                const float2* __restrict__ src) {
    if constexpr (I < PASSES - 1) {
      pass<I, INV>(s, tw, src);
      passes<I + 1, INV>(s, tw, src);
    }
  }

  // The last pass's radix and butterflies per thread: its butterfly i
  // holds outputs k = i + r N/R (r < R) of the local transform.
  static constexpr int LAST_R = 1 << bits(PASSES - 1);
  static constexpr int LAST_BPT = N / LAST_R / THREADS;
  static constexpr int LAST_T = N / LAST_R;
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum of (a, b) over the CTA in a fixed order (warp shuffles, then warp
// partials in warp order); the result is valid in thread 0.
template <int THREADS>
__device__ __forceinline__ void block_sum2(double& a, double& b,
                                           double* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    scratch[2 * warp] = a;
    scratch[2 * warp + 1] = b;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int W = THREADS / 32;
    a = lane < W ? scratch[2 * lane] : 0.0;
    b = lane < W ? scratch[2 * lane + 1] : 0.0;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

template <int C>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (C > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// This CTA's shared-memory address ``s`` in CTA ``rank`` of the cluster.
template <int C, typename T>
__device__ __forceinline__ T* cluster_smem(T* s, int rank) {
  if constexpr (C > 1) {
    return cg::this_cluster().map_shared_rank(s, rank);
  } else {
    return s;
  }
}

struct Args {
  const float2* in;
  float2* out;
  const float2* tw;   // exp(-2 pi i m / L), m < L
  const float* dw;    // reciprocal de-window [L] or null
  float* s2;          // per-row sums, float32 [batch]
  float* s4;
  long long batch;
};

// Row blockIdx.x / C on C CTAs (a cluster when C > 1).
template <int LOG_N, int C, bool INV>
__global__ void __launch_bounds__(Plan<LOG_N, C>::THREADS,
                                  Plan<LOG_N, C>::MIN_CTAS)
    fft_rows_stats_kernel(Args a) {
  using P = Plan<LOG_N, C>;
  constexpr int N = P::N;
  constexpr int L = P::L;
  constexpr int THREADS = P::THREADS;
  constexpr int R = P::LAST_R;
  constexpr int BPT = P::LAST_BPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s = reinterpret_cast<float2*>(smem_raw);
  __shared__ double red[2 * (THREADS / 32)];
  __shared__ double cta_part[2];

  const int tid = threadIdx.x;
  const int rank = C > 1 ? static_cast<int>(blockIdx.x % C) : 0;
  const long long row = blockIdx.x / C;
  const long long base = row * L;
  const float2* in = a.in + base;
  if constexpr (C > 1) {
    // every CTA of the cluster has started
    cluster_barrier<C>();
    // cross stage: this CTA takes positions j of its own range
    // [rank N/C, (rank+1) N/C), reads x[j + qN] (q < C) from device
    // memory and writes y_p[j] = w_L^{pj} sum_q x[j + qN] w_C^{pq} into
    // CTA p's shared memory at j
    constexpr int J = N / C;
    float2* rem[C];
#pragma unroll
    for (int p = 0; p < C; ++p) rem[p] = cluster_smem<C>(s, p);
#pragma unroll
    for (int jj = 0; jj < J / THREADS; ++jj) {
      const int j = rank * J + tid + jj * THREADS;
      float2 x[C];
#pragma unroll
      for (int q = 0; q < C; ++q) x[q] = in[j + q * N];
#pragma unroll
      for (int p = 0; p < C; ++p) {
        float2 acc = x[0];
#pragma unroll
        for (int q = 1; q < C; ++q) {
          acc = cadd(acc, cmul(x[q], root16<INV>((p * q % C) * (16 / C))));
        }
        rem[p][pad(j)] = p == 0 ? acc : cmul(acc, twiddle<INV>(a.tw, p * j));
      }
    }
    cluster_barrier<C>();
  }
  // one CTA a row (C = 1): the first pass reads the row itself
  P::template passes<0, INV>(s, a.tw, C == 1 ? in : nullptr);
  float2 u[BPT][R];
  P::template load_dft<P::PASSES - 1, INV>(s, a.tw, nullptr, u);
  // u[b][r] is output X[g] for g = C k + rank, k = tid + b THREADS +
  // r N/R: de-window, write, and the power moments
  double p2 = 0.0;
  double p4 = 0.0;
#pragma unroll
  for (int b = 0; b < BPT; ++b) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int g = C * (tid + b * THREADS + r * P::LAST_T) + rank;
      if (a.dw != nullptr) {
        const float d = __ldg(a.dw + g);
        u[b][r] = make_float2(__fmul_rn(u[b][r].x, d),
                              __fmul_rn(u[b][r].y, d));
      }
      const double pw = srtb::power(u[b][r]);
      p2 += pw;
      p4 += pw * pw;
      a.out[base + g] = u[b][r];
    }
  }
  block_sum2<THREADS>(p2, p4, red);
  if (tid == 0) {
    cta_part[0] = p2;
    cta_part[1] = p4;
  }
  cluster_barrier<C>();
  if (rank == 0 && tid == 0) {
    double s2 = 0.0;
    double s4 = 0.0;
#pragma unroll
    for (int q = 0; q < C; ++q) {  // fixed order
      const double* part = cluster_smem<C>(cta_part, q);
      s2 += part[0];
      s4 += part[1];
    }
    a.s2[row] = static_cast<float>(s2);
    a.s4[row] = static_cast<float>(s4);
  }
  // no CTA leaves while another may still read its shared memory
  cluster_barrier<C>();
}

template <int LOG_N, int C, bool INV>
int run_stats(const Args& a, cudaStream_t stream) {
  using P = Plan<LOG_N, C>;
  auto kernel = fft_rows_stats_kernel<LOG_N, C, INV>;
  constexpr size_t smem = P::SMEM_VALUES * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.batch * C));
  cfg.blockDim = dim3(P::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on the row length: N = min(L, 2^14) values per CTA, C = L / N.
template <bool INV>
int stats_dir(const Args& a, long long length, cudaStream_t stream) {
  switch (length) {
    case 1 << 12: return run_stats<12, 1, INV>(a, stream);
    case 1 << 13: return run_stats<13, 1, INV>(a, stream);
    case 1 << 14: return run_stats<14, 1, INV>(a, stream);
    case 1 << 15: return run_stats<14, 2, INV>(a, stream);
    case 1 << 16: return run_stats<14, 4, INV>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline int run_stats(const Args& a, long long length, int inverse,
                     cudaStream_t stream) {
  if (a.batch <= 0) return 0;
  if (a.batch * 4 > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return inverse ? stats_dir<true>(a, length, stream)
                 : stats_dir<false>(a, length, stream);
}

}  // namespace fft
}  // namespace srtb

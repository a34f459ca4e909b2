// The building blocks the Hopper FFT kernels share: complex arithmetic,
// the padded shared-memory index, the compile-time bit reversal of a
// register array, the fixed-order float64 CTA reduction and the cluster
// helpers.  The row-FFT core (fft_rows_sm90.cuh: B6, B7, B8, B10, B12)
// and the clustered column body (fft2.cuh: B9, B11) build on them.
//
// Every index into a register array is a compile-time constant (the
// permutations are template recursions): a runtime index moves the array
// to local memory, which made the first row FFTs two to three times
// slower on an H100.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace srtb {
namespace fft {

namespace cg = cooperative_groups;

// Shared-memory indices padded by one value per 16, so that stride-16
// accesses do not conflict.
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

}  // namespace fft
}  // namespace srtb

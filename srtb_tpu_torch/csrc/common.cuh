// Shared launch helpers for the port's hand-written Hopper kernels.
//
// Every kernel of this directory is exported through a plain C function
// (no PyTorch headers, so nvcc builds the whole library in seconds) that
// takes raw device pointers and the caller's CUDA stream, launches, and
// returns cudaGetLastError() so the Python wrapper can raise on a launch
// the CUDA runtime refused.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define SRTB_EXPORT extern "C" __attribute__((visibility("default")))

namespace srtb {

constexpr int kThreads = 256;

// Grid for a grid-stride loop over `work` items: one thread per item up to
// a cap of 32 resident-size waves of 256-thread blocks (132 SMs x 8 blocks
// x 32 = 33792 blocks), past which each thread loops.
inline int grid_for(long long work) {
  const long long cap = 132LL * 8 * 32;
  long long g = (work + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  return static_cast<int>(g < cap ? g : cap);
}

// |x|^2 with each product and the sum rounded separately (no FMA
// contraction), so it is bit-identical to the plain PyTorch spelling
// `re * re + im * im` — decisions that compare it with a threshold must
// not flip between the kernel and its plain version.
__device__ __forceinline__ float power(float2 v) {
  return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

// The coherent-dedispersion chirp of spectrum bin i, shared by K2
// (rfi_chirp.cu) and B3 (dedisperse.cu) so the two cannot drift apart:
//   k = c_dm (f - f_c)^2 / f,  f = f_min + df i,  c_dm = D 1e6 dm / f_c^2
// in turns, exact in native float64 from the int64 index (one division),
// reduced to frac(k) with modf semantics before the only float32 step,
// sincospif of -2 frac(k).  Returns (cos, sin) of -2 pi frac(k); the _rn
// intrinsics keep nvcc from contracting into FMAs, so the phase is the
// plain version's (ops/dedisperse.chirp_turns) exactly.
// chirp_arg is the float32 argument -2 frac(k) of that sincospif, the
// float64 part alone (B12 makes it ahead of its epilogue).
__device__ __forceinline__ float chirp_arg(long long i, double f_min,
                                          double df, double f_c,
                                          double c_dm) {
  const double f = __dadd_rn(f_min, __dmul_rn(df, static_cast<double>(i)));
  const double d = __dsub_rn(f, f_c);
  const double k = __ddiv_rn(__dmul_rn(c_dm, __dmul_rn(d, d)), f);
  const double frac = __dsub_rn(k, trunc(k));  // sign of k, like modf
  return __double2float_rn(-2.0 * frac);
}

__device__ __forceinline__ float2 chirp_of_arg(float arg) {
  float s, c;
  sincospif(arg, &s, &c);
  return make_float2(c, s);
}

__device__ __forceinline__ float2 chirp(long long i, double f_min, double df,
                                        double f_c, double c_dm) {
  return chirp_of_arg(chirp_arg(i, f_min, df, f_c, c_dm));
}

// x * (c + i s) with every product and sum rounded separately, as the
// plain PyTorch spelling (re c - im s, re s + im c) rounds.
__device__ __forceinline__ float2 rotate(float2 x, float2 cs) {
  return make_float2(__fsub_rn(__fmul_rn(x.x, cs.x), __fmul_rn(x.y, cs.y)),
                     __fadd_rn(__fmul_rn(x.x, cs.y), __fmul_rn(x.y, cs.x)));
}

}  // namespace srtb

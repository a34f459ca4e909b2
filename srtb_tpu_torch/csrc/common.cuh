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

}  // namespace srtb

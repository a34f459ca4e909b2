// K1: MSB-first 1/2/4-bit sub-byte unpack fused with the FFT window, and
// B13, the same unpack into blocked planes written as packed complex.
//
// Replaces the TPU kernel srtb_tpu/ops/pallas_kernels.py
// unpack_subbyte_window (pallas_call at :679, body _unpack_subbyte_kernel
// :631).  uint8 [m] -> float32 [(8/b) m]: sample (8/b) i + j is field j of
// byte i, counted from the most significant bits, times window[(8/b) i + j]
// when a window is given.
//
// Bound: bytes.  At the production segment (2^30 2-bit samples) it reads
// 0.27 GB of bytes and writes 4.3 GB of floats (plus 4.3 GB of window when
// one is given) and does one shift-and-mask per output, so the write
// stream is the whole cost.  The TPU kernel could not be lowered on a real
// chip (a lane interleave Mosaic refuses); on Hopper the interleave is free:
// one thread per input byte keeps all (8/b) fields in registers and stores
// them as one 16-byte vector (8 or 16 bytes for 4/1 bits), so a warp writes
// 512 contiguous bytes per store instruction and the byte loads coalesce
// into 32-byte sectors.
#include "common.cuh"

namespace {

template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[N]) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      *reinterpret_cast<float4*>(dst + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* src, float (&v)[N]) {
  if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(src + k);
      v[k] = a.x;
      v[k + 1] = a.y;
      v[k + 2] = a.z;
      v[k + 3] = a.w;
    }
  }
}

template <int NBITS>
__global__ void __launch_bounds__(srtb::kThreads)
    unpack_subbyte_window_kernel(const uint8_t* __restrict__ in,
                                 const float* __restrict__ window,
                                 float* __restrict__ out, long long m) {
  constexpr int kPer = 8 / NBITS;
  constexpr unsigned kMask = (1u << NBITS) - 1u;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < m; i += stride) {
    const unsigned b = in[i];
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = static_cast<float>((b >> (8 - NBITS * (j + 1))) & kMask);
    }
    if (window != nullptr) {
      float w[kPer];
      load_vec<kPer>(window + i * kPer, w);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[j] *= w[j];
    }
    store_vec<kPer>(out + i * kPer, v);
  }
}


// B13 replaces srtb_tpu/ops/pallas_kernels.py unpack_subbyte_planes_window
// (pallas_call at :763, body _unpack_planes_kernel :706): uint8 [m] ->
// blocked field planes [count, m] (count = 8/b, plane k = field k of every
// byte, MSB-first) times the blocked window planes.  Its only consumer
// pairs the planes into the packed half-size sequence of the R2C,
// z[k', i] = plane[2k'][i] + i plane[2k'+1][i] (ops/fft.py
// subbyte_planes_to_packed), so the kernel writes z, complex64
// [count/2, m], directly and saves that pass.
//
// Bound: bytes.  At 2^25 bytes (2^27 2-bit samples) it reads 32 MiB and
// writes 512 MiB (plus 512 MiB of window planes when one is given); one
// shift-and-mask per output.  One thread per byte keeps its fields in
// registers; for each plane pair a warp stores 32 consecutive float2
// (256 contiguous bytes), and the window planes are read the same way.
template <int NBITS>
__global__ void __launch_bounds__(srtb::kThreads)
    unpack_subbyte_planes_kernel(const uint8_t* __restrict__ in,
                                 const float* __restrict__ window,
                                 float2* __restrict__ out, long long m) {
  constexpr int kCount = 8 / NBITS;
  constexpr unsigned kMask = (1u << NBITS) - 1u;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < m; i += stride) {
    const unsigned b = in[i];
    float f[kCount];
#pragma unroll
    for (int j = 0; j < kCount; ++j) {
      f[j] = static_cast<float>((b >> (8 - NBITS * (j + 1))) & kMask);
      if (window != nullptr) f[j] = __fmul_rn(f[j], window[j * m + i]);
    }
#pragma unroll
    for (int k = 0; k < kCount / 2; ++k) {
      out[k * m + i] = make_float2(f[2 * k], f[2 * k + 1]);
    }
  }
}

}  // namespace

// in: uint8 [m]; window: float32 [(8/nbits) m] or null; out: float32
// [(8/nbits) m].  window and out must be 16-byte aligned.
SRTB_EXPORT int srtb_unpack_subbyte_window(const void* in, const void* window,
                                           void* out, long long m, int nbits,
                                           void* stream) {
  if (m <= 0) return 0;
  const int grid = srtb::grid_for(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  const float* win = static_cast<const float*>(window);
  float* dst = static_cast<float*>(out);
  switch (nbits) {
    case 1:
      unpack_subbyte_window_kernel<1><<<grid, srtb::kThreads, 0, s>>>(
          src, win, dst, m);
      break;
    case 2:
      unpack_subbyte_window_kernel<2><<<grid, srtb::kThreads, 0, s>>>(
          src, win, dst, m);
      break;
    case 4:
      unpack_subbyte_window_kernel<4><<<grid, srtb::kThreads, 0, s>>>(
          src, win, dst, m);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// in: uint8 [m]; window: float32 [8/nbits, m] blocked planes or null; out:
// complex64 [4/nbits, m] as float2 (for nbits in {1, 2, 4}).
SRTB_EXPORT int srtb_unpack_subbyte_planes_window(const void* in,
                                                  const void* window,
                                                  void* out, long long m,
                                                  int nbits, void* stream) {
  if (m <= 0) return 0;
  const int grid = srtb::grid_for(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  const float* win = static_cast<const float*>(window);
  float2* dst = static_cast<float2*>(out);
  switch (nbits) {
    case 1:
      unpack_subbyte_planes_kernel<1><<<grid, srtb::kThreads, 0, s>>>(
          src, win, dst, m);
      break;
    case 2:
      unpack_subbyte_planes_kernel<2><<<grid, srtb::kThreads, 0, s>>>(
          src, win, dst, m);
      break;
    case 4:
      unpack_subbyte_planes_kernel<4><<<grid, srtb::kThreads, 0, s>>>(
          src, win, dst, m);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// cudaGetErrorName of a launch function's return code, for the Python
// wrappers' KernelLaunchError (the error taxonomy classifies by name).
SRTB_EXPORT const char* srtb_cuda_error_name(int rc) {
  return cudaGetErrorName(static_cast<cudaError_t>(rc));
}

// The column pass of the two-pass four-step C2C, shared by B9 (fft2.cu,
// complex64 input) and B11 (fft2_front.cu, raw baseband bytes): one body,
// two loaders, so that on the same values the two kernels compute the
// same bits.
//
// The transform of length m = n1 n2 (n1 = 4096 or 8192, n2 = 2^12 ...
// 2^16) is viewed as x[j1, j2] = x[j1 n2 + j2], a [n1, n2] row-major block
// (a batch of such blocks, one per plane).  For every column j2 the kernel
// runs the n1-point C2C over j1 and multiplies by the four-step twiddle:
//   B[k1, j2] = exp(s 2 pi i k1 j2 / m) sum_j1 x[j1, j2] exp(s 2 pi i j1 k1
//               / n1),  s = -1 forward, +1 inverse (unnormalized),
// written in the same [n1, n2] layout.
//
// Design.  The column reads are strided by n2, so the layout of a tile is
// the whole question.  A CTA takes COLS adjacent columns (4 at n1 = 4096,
// so that every row segment of complex64 it reads or writes is one whole
// 32-byte sector; 2 at n1 = 8192, 16-byte half sectors, whose other halves
// the neighbouring CTA touches at about the same time, usually from L2) and
// stages the [n1, COLS] tile in shared memory, column-major, each column a
// padded contiguous run: 136 KB either way, one CTA and 1024 threads an
// SM.  Loads and stores are cooperative: consecutive threads take
// consecutive columns of one row, then the next row, CHUNK loads in
// flight a thread.  Each column is then transformed in place by
// fft_rows.cuh's Stockham passes (Plan<log2 n1, 1>, radix 16/8, N/16
// threads a column, threadIdx.y picks the column); the last pass stays in
// registers, where the twiddle is applied before the tile goes back to
// shared memory for the coalesced store.  The twiddle comes from the exact
// integer residue k1 j2 (< m, so no modulo), folded to (-m/2, m/2], and
// one float32 sincospif of 2 r / m: no m-sized table, which at this size
// would double the pass's traffic.  The column stride in shared memory is
// padded so a half warp's 8-byte stores of one row's COLS values fall in
// distinct banks.
//
// STATS (B11) adds the pieces of the RFI stage-1 mean power, in a fixed
// order and without atomics: each CTA sums |B|^2 over its tile in float64
// (warp shuffles, then the warps in order) and Re, Im of B[0, j2] over its
// columns in column order, and writes the three to part[block]; the
// wrapper adds the partials of a plane in float64.
#pragma once

#include "fft_rows.cuh"

namespace srtb {
namespace fft {

template <int LOG_N1>
struct ColumnTile {
  using P = Plan<LOG_N1, 1>;
  static constexpr int N1 = P::N;
  static constexpr int COLS = (1 << 14) / N1;
  static constexpr int COL_THREADS = P::THREADS;     // threads a column
  static constexpr int THREADS = COL_THREADS * COLS;  // 1024
  // column stride in float2: the padded column plus 16 / COLS values, so
  // the COLS columns of one row start 32 / COLS banks apart
  static constexpr int STRIDE = P::SMEM_VALUES + 16 / COLS;
  static constexpr size_t SMEM = size_t(STRIDE) * COLS * sizeof(float2);
  static constexpr int PER_THREAD = N1 * COLS / THREADS;  // 16
  static constexpr int ROWS_STEP = THREADS / COLS;  // rows a sweep covers
  static constexpr int CHUNK = 8;  // loads in flight a thread (64 KB an SM)
};

// B9's loader: complex64 planes [batch, m]; value p = j1 n2 + j2 of plane.
struct ComplexLoader {
  const float2* in;
  long long m;
  __device__ __forceinline__ float2 operator()(long long plane,
                                               long long p) const {
    return in[plane * m + p];
  }
};

template <int LOG_N1, bool INV, bool STATS, class Load>
__global__ void __launch_bounds__(ColumnTile<LOG_N1>::THREADS, 1)
    column_pass_kernel(Load load, float2* __restrict__ out,
                       const float2* __restrict__ tw, int n2, long long m,
                       double* __restrict__ part) {
  using T = ColumnTile<LOG_N1>;
  using P = typename T::P;
  constexpr int COLS = T::COLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* tile = reinterpret_cast<float2*>(smem_raw);
  const int tid = threadIdx.y * P::THREADS + threadIdx.x;
  const int tiles = n2 / COLS;  // column tiles a plane
  const long long plane = blockIdx.x / tiles;
  const int j2_0 = static_cast<int>(blockIdx.x % tiles) * COLS;
  // thread tid moves column tid % COLS of rows tid / COLS + i ROWS_STEP
  const int col = tid % COLS;
  const int row0 = tid / COLS;
  const long long step = static_cast<long long>(T::ROWS_STEP) * n2;
  const long long first = static_cast<long long>(row0) * n2 + j2_0 + col;
  float2* tcol = tile + col * T::STRIDE;

  // tile[col][row] <- x[row, j2_0 + col], CHUNK loads in flight a thread
#pragma unroll 1
  for (int c0 = 0; c0 < T::PER_THREAD; c0 += T::CHUNK) {
    float2 v[T::CHUNK];
#pragma unroll
    for (int i = 0; i < T::CHUNK; ++i) v[i] = load(plane, first + (c0 + i) * step);
#pragma unroll
    for (int i = 0; i < T::CHUNK; ++i) {
      tcol[pad(row0 + (c0 + i) * T::ROWS_STEP)] = v[i];
    }
  }
  __syncthreads();

  // the n1-point FFT of column threadIdx.y, in place
  float2* s = tile + threadIdx.y * T::STRIDE;
  P::template passes<0, INV>(s, tw, nullptr);
  float2 u[P::LAST_BPT][P::LAST_R];
  P::template load_dft<P::PASSES - 1, INV>(s, tw, nullptr, u);
  __syncthreads();  // every column's last reads precede the writes below

  // the four-step twiddle exp(s 2 pi i k1 j2 / m) of output k1
  const long long j2 = j2_0 + threadIdx.y;
  const float scale = (INV ? 2.0f : -2.0f) / static_cast<float>(m);
  double s2 = 0.0;
  __shared__ double warp_s2[T::THREADS / 32];
  __shared__ float2 dc[COLS];
#pragma unroll
  for (int b = 0; b < P::LAST_BPT; ++b) {
#pragma unroll
    for (int r = 0; r < P::LAST_R; ++r) {
      const int k1 = threadIdx.x + b * P::THREADS + r * P::LAST_T;
      long long res = k1 * j2;
      if (2 * res > m) res -= m;
      float sn, cs;
      sincospif(__ll2float_rn(res) * scale, &sn, &cs);
      const float2 y = cmul(u[b][r], make_float2(cs, sn));
      s[pad(k1)] = y;
      if constexpr (STATS) {
        s2 += static_cast<double>(y.x) * y.x +
              static_cast<double>(y.y) * y.y;
        if (b == 0 && r == 0 && threadIdx.x == 0) dc[threadIdx.y] = y;
      }
    }
  }
  if constexpr (STATS) {
    s2 = warp_sum(s2);
    if ((tid & 31) == 0) warp_s2[tid >> 5] = s2;
  }
  __syncthreads();
  if constexpr (STATS) {
    if (tid == 0) {
      double total = 0.0;
#pragma unroll 1
      for (int w = 0; w < T::THREADS / 32; ++w) total += warp_s2[w];
      double f0r = 0.0;
      double f0i = 0.0;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        f0r += dc[c].x;
        f0i += dc[c].y;
      }
      part[3 * static_cast<long long>(blockIdx.x)] = total;
      part[3 * static_cast<long long>(blockIdx.x) + 1] = f0r;
      part[3 * static_cast<long long>(blockIdx.x) + 2] = f0i;
    }
  }

  // B[row, j2_0 + col] <- tile[col][row]
  float2* o = out + plane * m;
#pragma unroll 1
  for (int c0 = 0; c0 < T::PER_THREAD; c0 += T::CHUNK) {
    float2 v[T::CHUNK];
#pragma unroll
    for (int i = 0; i < T::CHUNK; ++i) {
      v[i] = tcol[pad(row0 + (c0 + i) * T::ROWS_STEP)];
    }
#pragma unroll
    for (int i = 0; i < T::CHUNK; ++i) o[first + (c0 + i) * step] = v[i];
  }
}

// Launch the column pass on `planes` planes of [n1, n2] (one CTA a column
// tile of a plane).
template <int LOG_N1, bool INV, bool STATS, class Load>
int run_column_pass(const Load& load, float2* out, const float2* tw,
                    long long planes, int n2, double* part,
                    cudaStream_t stream) {
  using T = ColumnTile<LOG_N1>;
  auto kernel = column_pass_kernel<LOG_N1, INV, STATS, Load>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = planes * (n2 / T::COLS);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), dim3(T::COL_THREADS, T::COLS),
           T::SMEM, stream>>>(load, out, tw, n2,
                              static_cast<long long>(T::N1) * n2, part);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on n1 (4096 or 8192) and the direction.
template <bool STATS, class Load>
int dispatch_column_pass(const Load& load, float2* out, const float2* tw,
                         long long planes, long long n1, long long n2,
                         int inverse, double* part, cudaStream_t stream) {
  if (planes <= 0) return 0;
  if (n2 < (1 << 12) || n2 > (1 << 16) || (n2 & (n2 - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n2i = static_cast<int>(n2);
  switch (n1) {
    case 1 << 12:
      return inverse ? run_column_pass<12, true, STATS>(load, out, tw, planes,
                                                        n2i, part, stream)
                     : run_column_pass<12, false, STATS>(load, out, tw,
                                                         planes, n2i, part,
                                                         stream);
    case 1 << 13:
      return inverse ? run_column_pass<13, true, STATS>(load, out, tw, planes,
                                                        n2i, part, stream)
                     : run_column_pass<13, false, STATS>(load, out, tw,
                                                         planes, n2i, part,
                                                         stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace fft
}  // namespace srtb

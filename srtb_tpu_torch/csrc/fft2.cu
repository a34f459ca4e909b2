// B9: pass 1 of the two-pass four-step C2C, for transforms of length
// m = n1 n2 (n1 = 4096 or 8192, n2 = 2^12 ... 2^16, so m = 2^24 ... 2^29).
//
// Replaces the TPU kernel srtb_tpu/ops/pallas_fft2.py pass1_2d
// (pallas_call at :531, body _pass1_kernel :441).  The transform is viewed
// as x[j1, j2] = x[j1 n2 + j2], a [n1, n2] row-major block (a batch of
// such blocks, one per plane).  For every column j2 the kernel runs the
// n1-point C2C over j1 and multiplies by the four-step twiddle:
//   B[k1, j2] = exp(s 2 pi i k1 j2 / m) sum_j1 x[j1, j2] exp(s 2 pi i j1 k1
//               / n1),  s = -1 forward, +1 inverse (unnormalized),
// written in the same [n1, n2] layout.  Pass 2 (B10) is the row FFT over
// j2 of B: srtb_fft2_pass2 in fft_rows.cu, B6's kernel on rows of n2.
// Then X[k1 + n1 k2] = C[k1, k2], and a transpose restores natural order.
//
// Bound: bytes, 8 B read and 8 B written a value (the 2^27 path's two
// planes of 2^25: 1.07e9 B, 0.32 ms at 3.35 TB/s); the column FFT is
// ~5 log2(n1) flops a value and the twiddle one sincospif, far below the
// float32 rate.
//
// Design.  The column reads are strided by n2, so the layout of a tile is
// the whole question.  A CTA takes COLS adjacent columns (4 at n1 = 4096,
// so that every row segment it reads or writes is one whole 32-byte
// sector; 2 at n1 = 8192, 16-byte half sectors, whose other halves the
// neighbouring CTA touches at about the same time, usually from L2) and
// stages the [n1, COLS] tile in shared memory, column-major, each column a
// padded contiguous run: 136 KB either way, one CTA and 1024 threads an
// SM.  Loads and stores are cooperative: consecutive threads take
// consecutive columns of one row, then the next row.  Each column is then
// transformed in place by fft_rows.cuh's Stockham passes (Plan<log2 n1,
// 1>, radix 16/8, N/16 threads a column, threadIdx.y picks the column);
// the last pass stays in registers, where the twiddle is applied before
// the tile goes back to shared memory for the coalesced store.  The
// twiddle comes from the exact integer residue k1 j2 (< m, so no modulo),
// folded to (-m/2, m/2], and one float32 sincospif of 2 r / m: no
// m-sized table, which at this size would double the pass's traffic (the
// reference builds it in the kernel too, from a hi/lo phase split).  The
// column stride in shared memory is padded so a half warp's 8-byte
// stores of one row's COLS values fall in distinct banks.
#include "fft_rows.cuh"

namespace srtb {
namespace fft {
namespace {

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

template <int LOG_N1, bool INV>
__global__ void __launch_bounds__(ColumnTile<LOG_N1>::THREADS, 1)
    fft2_pass1_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                      const float2* __restrict__ tw, int n2, long long m) {
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
  const long long first = plane * m + static_cast<long long>(row0) * n2 +
                          j2_0 + col;
  float2* tcol = tile + col * T::STRIDE;

  // tile[col][row] <- x[row, j2_0 + col], CHUNK loads in flight a thread
#pragma unroll 1
  for (int c0 = 0; c0 < T::PER_THREAD; c0 += T::CHUNK) {
    float2 v[T::CHUNK];
#pragma unroll
    for (int i = 0; i < T::CHUNK; ++i) v[i] = in[first + (c0 + i) * step];
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
#pragma unroll
  for (int b = 0; b < P::LAST_BPT; ++b) {
#pragma unroll
    for (int r = 0; r < P::LAST_R; ++r) {
      const int k1 = threadIdx.x + b * P::THREADS + r * P::LAST_T;
      long long res = k1 * j2;
      if (2 * res > m) res -= m;
      float sn, cs;
      sincospif(__ll2float_rn(res) * scale, &sn, &cs);
      s[pad(k1)] = cmul(u[b][r], make_float2(cs, sn));
    }
  }
  __syncthreads();

  // B[row, j2_0 + col] <- tile[col][row]
#pragma unroll 1
  for (int c0 = 0; c0 < T::PER_THREAD; c0 += T::CHUNK) {
    float2 v[T::CHUNK];
#pragma unroll
    for (int i = 0; i < T::CHUNK; ++i) {
      v[i] = tcol[pad(row0 + (c0 + i) * T::ROWS_STEP)];
    }
#pragma unroll
    for (int i = 0; i < T::CHUNK; ++i) out[first + (c0 + i) * step] = v[i];
  }
}

template <int LOG_N1, bool INV>
int run_pass1(const float2* in, float2* out, const float2* tw,
              long long batch, int n2, cudaStream_t stream) {
  using T = ColumnTile<LOG_N1>;
  cudaError_t err = cudaFuncSetAttribute(
      fft2_pass1_kernel<LOG_N1, INV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = batch * (n2 / T::COLS);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fft2_pass1_kernel<LOG_N1, INV>
      <<<static_cast<unsigned>(blocks), dim3(T::COL_THREADS, T::COLS),
         T::SMEM, stream>>>(in, out, tw, n2,
                            static_cast<long long>(T::N1) * n2);
  return static_cast<int>(cudaGetLastError());
}

template <bool INV>
int dispatch_pass1(const float2* in, float2* out, const float2* tw,
                   long long batch, long long n1, long long n2,
                   cudaStream_t stream) {
  const int n2i = static_cast<int>(n2);
  switch (n1) {
    case 1 << 12: return run_pass1<12, INV>(in, out, tw, batch, n2i, stream);
    case 1 << 13: return run_pass1<13, INV>(in, out, tw, batch, n2i, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace fft
}  // namespace srtb

// in, out: complex64 [batch, n1, n2] as float2; tw: complex64 [n1],
// exp(-2 pi i j / n1).  n1 = 4096 or 8192, n2 a power of two in
// [4096, 65536].
SRTB_EXPORT int srtb_fft2_pass1(const void* in, void* out, const void* tw,
                                long long batch, long long n1, long long n2,
                                int inverse, void* stream) {
  if (batch <= 0) return 0;
  if (n2 < (1 << 12) || n2 > (1 << 16) || (n2 & (n2 - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* x = static_cast<const float2*>(in);
  auto* y = static_cast<float2*>(out);
  const auto* t = static_cast<const float2*>(tw);
  const auto s = static_cast<cudaStream_t>(stream);
  return inverse ? srtb::fft::dispatch_pass1<true>(x, y, t, batch, n1, n2, s)
                 : srtb::fft::dispatch_pass1<false>(x, y, t, batch, n1, n2,
                                                    s);
}

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
// Bound: bytes, 8 B read and 8 B written a value (the 2^30 segment's
// [8192, 65536] plane: 8.59e9 B, 2.564 ms at the H100's 3.35 TB/s); the
// column FFT is ~5 log2(n1) float32 operations a value, a tenth of that.
//
// What the first design cost.  A CTA held the whole column of COLS =
// 16384 / n1 adjacent columns (2 at n1 = 8192): every row segment it read
// or wrote was 16 B, half a 32-byte sector, and its 136 KB tile with 1024
// threads kept one CTA an SM, so load, passes and store ran one after
// another.  On an H100 80GB HBM3 at 700 W it took 12.56 ms at [8192,
// 65536] (20% of the bound; B11 13.32 ms) and 0.784 ms at [2, 4096, 8192]
// (41%).  This body takes 4.52-4.58, 0.54 and 5.0-5.2 ms there (56-57%,
// 59-60%; the same card and limit, timed in turns with cuFFT's column
// FFT over several runs).
//
// This design: a column tile of W = 8 columns (64-byte row segments, two
// whole sectors) on a thread-block cluster of C = n1 / 1024 CTAs (4 or 8),
// each CTA 1024 rows x 8 columns in one 66 KB buffer, 256 threads, 32
// values a thread, two CTAs an SM (the row-FFT core's geometry,
// fft_rows_sm90.cuh), the grid planes x n2 / W clusters:
// 1. Load.  B9: CTA r brings the C slices x[qN + rJ, qN + (r+1)J) (N =
//    1024, J = N / C rows, q < C) of its 8 columns into its buffer with C
//    2-D TMA tensor copies (a [planes n1, 2 n2] float32 tensor map, box J
//    rows x 16 floats, L2 promotion 256 bytes), tracked by one mbarrier:
//    no registers spent on the load.  B11 reads its raw bytes with
//    ordinary loads straight into registers (a 2-bit row segment of 8
//    packed values is 4 bytes, under TMA's 16-byte box), one word a
//    value, all 32 of a thread fetched before step 2 unpacks them as K1
//    does.
// 2. The radix-C step first (decimation in frequency), as the row core's
//    clusters do: y_p[j] = w_n1^{pj} sum_q x[j + qN] w_C^{pq} for the J
//    rows j = rJ + jj the CTA owns (w_n1^j from the wrapper's n1-entry
//    table, its powers by products), one position at a time in registers
//    and back in place: y_p into the rows pJ + jj that x's slice q = p
//    held.  The FFT over j of y_p is X[Ck + p].
// 3. A local 1024-point Stockham transform of each of the 8 columns: two
//    radix-32 passes, thread (col, i) = (tid mod 8, tid / 8) holding
//    butterfly i of column col (the second pass's twiddle bases from the
//    same table), every register index a compile-time constant.  After a
//    cluster barrier the first pass pulls its 32 values of y_p through
//    distributed shared memory from the CTAs that made them (all threads
//    of a warp from one CTA at a time, 256 contiguous bytes), and a
//    second barrier lets every CTA overwrite its buffer.  Pulling keeps
//    only C values live in the radix-C step; pushing them, the first
//    version of this body, held all 32 across the barrier and spilled.
//    Both barriers are split into arrive and wait, with work of the CTA's
//    own between: step 4's twiddle bases at the first, the first pass's
//    DFT at the second (the slowest CTA of the cluster sets when a
//    barrier opens; on that card the split took B9 from 5.11 to 4.58 ms
//    at [8192, 65536]).  The passes' buffer layout is row-major
//    [row][col] like the plane, with one padding row in 32, so a warp's
//    32 accesses (8 columns x 4 rows) are contiguous or, in the first
//    pass's stride-32 writes, two wavefronts: free of bank conflicts.
// 4. The four-step twiddle of output k1 = C (i + 32 r) + p in registers
//    after the last pass: four sincospif a thread of exact integer
//    residues folded to (-m/2, m/2] (base k1 j2 and steps 32 C j2 times 1,
//    4, 16), made at the first barrier, the others by at most two
//    products; no m-sized table.  Then each value goes straight to its
//    place: a warp stores 4 whole 64-byte row segments an instruction, so
//    no second exchange is needed.
// A persistent form (one cluster walking many tiles, the next tile's TMA
// issued once the last pass had read the buffer) spilled and took 8.6 ms
// on that card.
//
// STATS (B11) adds the pieces of the RFI stage-1 mean power, in a fixed
// order and without atomics: each CTA sums |B|^2 over its 1024 x 8 outputs
// in float64 (warp shuffles, then the warps in order) and Re, Im of B[0,
// j2] over its columns in column order (only rank 0 holds row 0), and
// writes the three to part[block]; the wrapper adds a plane's partials in
// float64.
#pragma once

#include <cuda.h>

#include "fft_rows_sm90.cuh"

namespace srtb {
namespace cols {

namespace cg = cooperative_groups;
using fft::cmul;
using rows::dft;
using rows::mbar_expect_tx;
using rows::mbar_init;
using rows::mbar_init_fence;
using rows::mbar_wait;
using rows::PassTwiddle;
using rows::smem_u32;

// The geometry of columns of n1 = 2^LOG_N1: C CTAs a cluster, each N =
// 1024 rows of W = 8 columns.
template <int LOG_N1>
struct Geometry {
  static constexpr int N1 = 1 << LOG_N1;
  static constexpr int N = 1024;         // rows a CTA transforms
  static constexpr int C = N1 / N;       // CTAs a cluster
  static constexpr int W = 8;            // columns a cluster
  static constexpr int THREADS = 256;
  static constexpr int CTAS_PER_SM = 2;
  static constexpr int J = N / C;        // rows of each slice a CTA loads
  static constexpr int R = 32;           // radix of both local passes
  static constexpr int T = N / R;        // butterflies a column, a pass
  static constexpr int S = J / T;        // radix-C positions a thread
  static constexpr size_t SMEM = (N + N / 32) * W * sizeof(float2);
  static constexpr unsigned LOAD_BYTES = N * W * sizeof(float2);
  static_assert(C == 4 || C == 8, "clusters of 4 or 8 CTAs");
  static_assert(T * W == THREADS && R * T == N, "one butterfly a thread");
  static_assert(S * C == R, "32 values a thread in the radix-C step");
  static_assert(LOAD_BYTES < (1u << 20), "mbarrier tx count");
};

// A cluster barrier in two halves, so that a CTA does work of its own
// between arriving (its earlier shared-memory accesses released to the
// cluster) and waiting for the others.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Buffer index of (row, col): one padding row in 32.
__device__ __forceinline__ int at(int row, int col) {
  return (row + (row >> 5)) * 8 + col;
}

// exp(-+2 pi i e / m) for an integer e >= 0 and a power of two m: the
// residue e mod m folded to (-m/2, m/2] and one float32 sincospif of
// 2 r / m (a power-of-two scale, exact after r's rounding to float).
template <bool INV>
__device__ __forceinline__ float2 root_mod(long long e, long long m) {
  long long r = e & (m - 1);
  if (2 * r > m) r -= m;
  float s, c;
  sincospif(__ll2float_rn(r) * ((INV ? 2.0f : -2.0f) /
                                static_cast<float>(m)),
            &s, &c);
  return make_float2(c, s);
}

struct Args {
  float2* out;       // [planes, n1, n2]
  const float2* tw;  // exp(-2 pi i j / n1), j < n1
  double* part;      // STATS: [blocks, 3]
  int n2;
};

// exp(-+2 pi i j / n1) from the table (conjugated for the inverse)
template <bool INV>
__device__ __forceinline__ float2 table_root(const float2* tw, int j) {
  const float2 w = __ldg(tw + j);
  return INV ? make_float2(w.x, -w.y) : w;
}

// B9's loader: a 2-D tensor map over the complex64 planes as float32
// [planes n1, 2 n2], box J rows x 16 floats (8 complex values); the body
// reads what it brought from shared memory.
struct TmaLoader {
  static constexpr bool kTma = true;
  CUtensorMap map;

  // rows [row, row + box rows) of columns [j2, j2 + 8) into dst
  __device__ __forceinline__ void issue(float2* dst, int row, int j2,
                                        uint64_t* bar) const {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(2 * j2), "r"(row),
        "r"(smem_u32(bar))
        : "memory");
  }
};

template <int LOG_N1, bool INV, bool STATS, class Load>
__global__ void __launch_bounds__(256, Geometry<LOG_N1>::CTAS_PER_SM)
    column_kernel(const __grid_constant__ Load load, Args a) {
  using G = Geometry<LOG_N1>;
  constexpr int C = G::C;
  constexpr int N = G::N;
  constexpr int J = G::J;
  constexpr int W = G::W;
  constexpr int S = G::S;
  constexpr int R = G::R;
  // 128-byte aligned for the tensor copies; taken as it is, so that the
  // compiler sees shared memory (an integer round trip would hide it:
  // generic accesses, and global loads ordered behind buffer stores)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float2* const buf = reinterpret_cast<float2*>(smem_raw);
  __shared__ __align__(8) uint64_t full;
  const int tid = threadIdx.x;
  const int col = tid & (W - 1);
  const int i = tid / W;  // butterfly of the column; radix-C row offset
  const int rank = static_cast<int>(blockIdx.x % C);
  const long long cluster_id = blockIdx.x / C;
  const int groups = a.n2 / W;  // column tiles a plane
  const long long plane = cluster_id / groups;
  const int j2_0 = static_cast<int>(cluster_id % groups) * W;
  const long long m = static_cast<long long>(G::N1) * a.n2;
  auto cluster = cg::this_cluster();

  // 1. B9: the C slices by TMA into rows [qJ, (q+1)J) of the buffer
  if constexpr (Load::kTma) {
    if (tid == 0) {
      mbar_init(&full, 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(&full, G::LOAD_BYTES);
      const int row0 = static_cast<int>(plane * G::N1) + rank * J;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        load.issue(buf + q * J * W, row0 + q * N, j2_0, &full);
      }
    }
    mbar_wait(&full, 0);
  }

  // B11: every raw word of the thread's positions first, all in flight
  const long long first =
      static_cast<long long>(rank * J + i) * a.n2 + j2_0 + col;
  auto at_x = [&](int s, int q) {
    return first + static_cast<long long>(q * N + 32 * s) * a.n2;
  };
  uint32_t word[Load::kTma ? 1 : S][C];
  if constexpr (!Load::kTma) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int q = 0; q < C; ++q) word[s][q] = load.fetch(plane, at_x(s, q));
    }
  }

  // 2. the radix-C step, in place one position (jj, col) at a time, jj = i
  // + 32 s: y_p[j] = w_n1^{pj} sum_q x[j + qN] w_C^{pq} of j = rank J + jj
  // from x[qN + j] (B9: buffer row qJ + jj; B11: its words) into buffer
  // row pJ + jj, where CTA p pulls it after the barrier
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int jj = i + 32 * s;
    float2 y[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if constexpr (Load::kTma) {
        y[q] = buf[(q * J + jj) * W + col];
      } else {
        y[q] = load.value(word[s][q], plane, at_x(s, q));
      }
    }
    dft<C, INV>(y);
    const float2 w1 = table_root<INV>(a.tw, rank * J + jj);
    float2 w = w1;
#pragma unroll
    for (int p = 1; p < C; ++p) {
      y[p] = cmul(y[p], w);
      w = cmul(w, w1);
    }
#pragma unroll
    for (int p = 0; p < C; ++p) buf[(p * J + jj) * W + col] = y[p];
  }
  // the barrier: every CTA's y_p in place.  While waiting, the bases of
  // step 4's four-step twiddle exp(s 2 pi i k1 j2 / m) of this thread's
  // k1 = k0 + r e: w(r) = lo[r mod 4] mid[(r / 4) mod 4] hi^(r / 16)
  cluster_arrive();
  const long long j2 = j2_0 + col;
  const long long k0 = C * i + rank;
  const long long e = 32LL * C * j2;
  float2 lo[4], mid[4];
  lo[0] = root_mod<INV>(k0 * j2, m);
  {
    const float2 p1 = root_mod<INV>(e, m);
    const float2 p2 = cmul(p1, p1);
    lo[1] = cmul(lo[0], p1);
    lo[2] = cmul(lo[0], p2);
    lo[3] = cmul(lo[0], cmul(p2, p1));
  }
  mid[0] = make_float2(1.0f, 0.0f);
  mid[1] = root_mod<INV>(4 * e, m);
  mid[2] = cmul(mid[1], mid[1]);
  mid[3] = cmul(mid[2], mid[1]);
  const float2 hi = root_mod<INV>(16 * e, m);
  cluster_wait();

  // 3. the 1024-point FFT of each column, two radix-32 Stockham passes;
  // pass 1 reads y_rank[i + 32 r] from CTA (i + 32 r) / J, row rank J +
  // (i + 32 r) mod J (one CTA for all threads at each r)
  float2 u[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2* const src = cluster.map_shared_rank(buf, (32 * r) / J);
    u[r] = src[(rank * J + (i + 32 * r) % J) * W + col];
  }
  cluster_arrive();  // this CTA's pulls are done: DFT while the rest end
  dft<R, INV>(u);
  cluster_wait();  // no DSMEM access after this
#pragma unroll
  for (int r = 0; r < R; ++r) buf[at(32 * i + r, col)] = u[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) u[r] = buf[at(i + 32 * r, col)];
  {
    // w^r, w = exp(-+2 pi i i / N) = table[C i]: lo, mid, hi as the row
    // core's PassTwiddle makes them, from the table
    PassTwiddle<R, INV> tw;
    tw.lo[0] = tw.mid[0] = make_float2(1.0f, 0.0f);
    tw.lo[1] = table_root<INV>(a.tw, C * i);
    tw.lo[2] = cmul(tw.lo[1], tw.lo[1]);
    tw.lo[3] = cmul(tw.lo[2], tw.lo[1]);
    tw.mid[1] = table_root<INV>(a.tw, 4 * C * i);
    tw.mid[2] = cmul(tw.mid[1], tw.mid[1]);
    tw.mid[3] = cmul(tw.mid[2], tw.mid[1]);
    tw.hi = table_root<INV>(a.tw, 16 * C * i);
    tw.apply(u);
  }
  dft<R, INV>(u);  // u[r] = X[C (i + 32 r) + rank]

  // 4. the four-step twiddle and the store
  float2* const o = a.out + (plane * G::N1 + k0) * a.n2 + j2;
  const long long step = 32LL * C * a.n2;
  double s2 = 0.0;
  __shared__ double warp_s2[G::THREADS / 32];
  __shared__ float2 dc[W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float2 w =
        (r & 12) == 0 ? lo[r & 3] : cmul(lo[r & 3], mid[(r >> 2) & 3]);
    if (r >= 16) w = cmul(w, hi);
    const float2 v = cmul(u[r], w);
    o[r * step] = v;
    if constexpr (STATS) {
      s2 += static_cast<double>(v.x) * v.x +
            static_cast<double>(v.y) * v.y;
      if (r == 0 && i == 0) dc[col] = v;  // B[0, j2] on rank 0
    }
  }
  if constexpr (STATS) {
    s2 = fft::warp_sum(s2);
    if ((tid & 31) == 0) warp_s2[tid >> 5] = s2;
    __syncthreads();
    if (tid == 0) {
      double total = 0.0;
#pragma unroll 1
      for (int w = 0; w < G::THREADS / 32; ++w) total += warp_s2[w];
      double f0r = 0.0;
      double f0i = 0.0;
      if (rank == 0) {
#pragma unroll
        for (int c = 0; c < W; ++c) {
          f0r += dc[c].x;
          f0i += dc[c].y;
        }
      }
      double* const p = a.part + 3 * static_cast<long long>(blockIdx.x);
      p[0] = total;
      p[1] = f0r;
      p[2] = f0i;
    }
  }
}

template <int LOG_N1, bool INV, bool STATS, class Load>
int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      column_kernel<LOG_N1, INV, STATS, Load>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Geometry<LOG_N1>::SMEM)));
}

// Launch the column pass on `planes` planes of [n1, n2]: one cluster a
// column tile of a plane.
template <int LOG_N1, bool INV, bool STATS, class Load>
int launch(const Load& load, const Args& a, long long planes,
           cudaStream_t stream) {
  using G = Geometry<LOG_N1>;
  const int rc = set_smem<LOG_N1, INV, STATS, Load>();
  if (rc != 0) return rc;
  const long long blocks = planes * (a.n2 / G::W) * G::C;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, column_kernel<LOG_N1, INV, STATS, Load>, load, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

inline bool valid_block(long long n1, long long n2) {
  return (n1 == (1 << 12) || n1 == (1 << 13)) && n2 >= (1 << 12) &&
         n2 <= (1 << 16) && (n2 & (n2 - 1)) == 0;
}

// Dispatch on n1 (4096 or 8192) and the direction.  `make_load(c)` gives
// the loader for clusters of c CTAs (B9's tensor map box depends on it).
template <bool STATS, class MakeLoad>
int run(MakeLoad&& make_load, float2* out, const float2* tw, double* part,
        long long planes, long long n1, long long n2, int inverse,
        cudaStream_t stream) {
  if (planes <= 0) return 0;
  if (!valid_block(n1, n2)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {out, tw, part, static_cast<int>(n2)};
  auto go = [&](auto log_n1) {
    constexpr int LN = decltype(log_n1)::value;
    int rc = 0;
    const auto load = make_load(Geometry<LN>::C, rc);
    if (rc != 0) return rc;
    using L = std::decay_t<decltype(load)>;
    return inverse ? launch<LN, true, STATS, L>(load, a, planes, stream)
                   : launch<LN, false, STATS, L>(load, a, planes, stream);
  };
  return n1 == (1 << 12) ? go(std::integral_constant<int, 12>{})
                         : go(std::integral_constant<int, 13>{});
}

// Geometry of the launch: [C, W, rows a CTA, threads, CTAs an SM,
// resident clusters, registers, local bytes, shared bytes] of the forward
// kernel of Load.
constexpr int kGeometryFields = 9;

template <int LOG_N1, bool STATS, class Load>
int configure(int* geo) {
  using G = Geometry<LOG_N1>;
  const auto kernel = column_kernel<LOG_N1, false, STATS, Load>;
  int rc = set_smem<LOG_N1, false, STATS, Load>();
  if (rc != 0) return rc;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      G::THREADS, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G::C * sms);
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa = {};
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[kGeometryFields] = {
      G::C, G::W, G::N, G::THREADS, per_sm, resident, fa.numRegs,
      static_cast<int>(fa.localSizeBytes), static_cast<int>(G::SMEM)};
  for (int k = 0; k < kGeometryFields; ++k) geo[k] = vals[k];
  return resident > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

template <bool STATS, class Load>
int geometry(long long n1, int* geo) {
  if (n1 == (1 << 12)) return configure<12, STATS, Load>(geo);
  if (n1 == (1 << 13)) return configure<13, STATS, Load>(geo);
  return static_cast<int>(cudaErrorInvalidValue);
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against the driver library.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// B9's tensor map: complex64 planes [rows = planes n1, n2] seen as float32
// [rows, 2 n2], box `box_rows` rows x 16 floats.  `in` 16-byte aligned.
inline int make_tma_loader(TmaLoader& load, const void* in, long long rows,
                           long long n2, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(2 * n2),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n2 * 8)};
  const cuuint32_t box[2] = {16, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      &load.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(in),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace cols
}  // namespace srtb

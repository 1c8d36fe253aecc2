// pareto_count: per row of y [n, m], the number of rows that strictly
// dominate it (minimization: all <= and any <), on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/pareto_count/kernel.py::
// dominance_counts (body _body). Plain version: repro_torch/kernels/
// pareto_count.py::dominance_counts_plain. Counts are exact integers, so the
// kernel and its plain version must agree bit for bit. A NaN row dominates
// nothing and is dominated by nothing (every comparison with it is false);
// +inf compares as IEEE says, as the JAX wrapper's +inf pad rows do.
//
// What bounds it here: n^2 pairs of 2m compares, m + 1 logic ops and one
// add. At the main path's largest call (the reference front, n = 2500,
// m = 3) that is ~70 M operations, ~1 us at the card's 67 T/s float32
// rate, against 40 KB of input and output; the main path's other 22 calls
// (the tuner's fronts, 50-70 rows) are bound by the launch itself. The
// first port (32 rows a block, 16 threads sharing a row's j range) ran 79
// blocks of 512 threads, 60 % of the SMs, each thread a chain of 156
// iterations of three scalar shared loads and 6 compares, with two
// __syncthreads per staged tile of 512 rows.
//
// Design: a block owns `rows` consecutive rows i, and a call larger than a
// round's front has about one block an SM (2500 rows: 132 blocks of 19),
// so the SMs share the pairs evenly; a round's front (up to 128 rows) is
// split into blocks of 16 rows. Each block stages y in shared memory once
// (4-byte cp.async copies, all in flight at once; tiles of rows where all
// do not fit), each row padded to P = 4 floats (m <= 4) or 8 (m <= 8), so a
// row j is one or two 16-byte shared loads (the pad is never compared). A
// row thread holds R = 2 or 4 rows i in registers (rows a, a + A, ...), so
// one shared load serves R dominance tests; its S splits (a power of two)
// walk the j range side by side and fill aligned lanes of a warp (or whole
// warps), so its partial counts are summed by shuffles, then over its warps
// in shared memory: integer sums, exact in any order. The plan (rows, R, S,
// tiles) comes from kernels/pareto_count.py::launch_plan. No cross-block
// atomics and no memset: each call is one device operation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// One 4-byte asynchronous copy from device to shared memory (cp.async:
// no register holds the value, so a thread keeps many in flight).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Copies the first `rows` rows of the row-major [rows, M] array src into
// the [rows, P] stage (element e to row e / M, column e % M; the pad
// columns are never written nor read), with the block's threads.
template <int M, int P>
__device__ __forceinline__ void stage_rows(float* ys,
                                           const float* __restrict__ src,
                                           int rows) {
  for (int e = threadIdx.x; e < rows * M; e += blockDim.x) {
    const int j = e / M;
    cp_async4(ys + j * P + (e - j * M), src + e);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// blockDim.x = A * S threads, S = 2^s_log2: thread t is split t % S of row
// thread t / S.
template <int M, int R>
__global__ void __launch_bounds__(kMaxThreads)
pareto_count_kernel(const float* __restrict__ y, int* __restrict__ out,
                    int n, int rows_per_block, int s_log2, int tile_rows) {
  constexpr int P = M <= 4 ? 4 : 8;
  extern __shared__ __align__(16) float smem[];
  float* ys = smem;  // [tile_rows, P]
  // S splits a row thread: up to 32 (a warp holds 32 / S row threads) or
  // W whole warps
  const int S = 1 << s_log2, A = blockDim.x >> s_log2;
  const int seg = min(S, 32), W = (S + 31) >> 5;
  // [W, R * A]: each warp's sums for the R rows of its row thread
  int* part = reinterpret_cast<int*>(smem + (size_t)tile_rows * P);
  const int t = threadIdx.x, a = t >> s_log2, s = t & (S - 1);
  const int i0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - i0);

  float yi[R][M];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = a + A * q;
#pragma unroll
    for (int k = 0; k < M; ++k)
      yi[q][k] = r < rows ? y[(size_t)(i0 + r) * M + k] : 0.0f;
  }

  int c[R];
#pragma unroll
  for (int q = 0; q < R; ++q) c[q] = 0;
  for (int j0 = 0; j0 < n; j0 += tile_rows) {
    const int jn = min(tile_rows, n - j0);
    if (j0 > 0) __syncthreads();  // the previous tile is consumed
    stage_rows<M, P>(ys, y + (size_t)j0 * M, jn);
    __syncthreads();  // every thread's copies have landed
#pragma unroll 2
    for (int j = s; j < jn; j += S) {
      float yj[P];
      const float4* row = reinterpret_cast<const float4*>(ys + j * P);
#pragma unroll
      for (int h = 0; h < P / 4; ++h) {
        const float4 w = row[h];
        yj[4 * h] = w.x;
        yj[4 * h + 1] = w.y;
        yj[4 * h + 2] = w.z;
        yj[4 * h + 3] = w.w;
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        bool le = true, lt = false;
#pragma unroll
        for (int k = 0; k < M; ++k) {
          le = le & (yj[k] <= yi[q][k]);
          lt = lt | (yj[k] < yi[q][k]);
        }
        c[q] += (int)(le & lt);
      }
    }
  }

  // a warp's splits of one row thread, then the row thread's W warps
  for (int off = seg >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < R; ++q) c[q] += __shfl_xor_sync(kFull, c[q], off);
  }
  if (W == 1) {  // a warp or less a row thread: its first lane has it all
    if (s == 0) {
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (a + A * q < rows) out[i0 + a + A * q] = c[q];
    }
    return;
  }
  if ((s & 31) == 0) {
#pragma unroll
    for (int q = 0; q < R; ++q) part[(s >> 5) * (R * A) + a + A * q] = c[q];
  }
  __syncthreads();
  if (t < rows) {
    int total = 0;
    for (int w = 0; w < W; ++w) total += part[w * (R * A) + t];
    out[i0 + t] = total;
  }
}

template <int M, int R>
cudaError_t launch(const float* y, int* out, int n, int rows_per_block,
                   int s_log2, int threads, int tile_rows,
                   int smem_bytes, cudaStream_t st) {
  static int opted_in = 0;  // bytes this instance may use (opt in once)
  if (smem_bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        pareto_count_kernel<M, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    opted_in = smem_bytes;
  }
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  pareto_count_kernel<M, R><<<blocks, threads, smem_bytes, st>>>(
      y, out, n, rows_per_block, s_log2, tile_rows);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_m(const float* y, int* out, int n, int r,
                     int rows_per_block, int s_log2, int threads,
                     int tile_rows, int smem_bytes, cudaStream_t st) {
  return r == 2 ? launch<M, 2>(y, out, n, rows_per_block, s_log2, threads,
                               tile_rows, smem_bytes, st)
                : launch<M, 4>(y, out, n, rows_per_block, s_log2, threads,
                               tile_rows, smem_bytes, st);
}

}  // namespace

// y [n, m] float32 contiguous (1 <= m <= 8), out [n] int32. The plan from
// kernels/pareto_count.py::launch_plan: r rows a row thread (2 or 4),
// 2^s_log2 splits a row thread, threads (a multiple of 32 and of the
// splits; rows_per_block <= r * threads / splits), rows j staged per tile,
// and the dynamic shared bytes (the tile's rows of 4 or 8 floats, then
// ceil(splits / 32) * r * row threads int32 sums); a plan that does not add
// up is refused.
extern "C" int pareto_count_launch(const void* y, void* out, int n, int m,
                                   int r, int rows_per_block, int s_log2,
                                   int threads, int tile_rows,
                                   int smem_bytes, void* stream) {
  const int pad = m <= 4 ? 4 : 8;
  const bool ok =
      n > 0 && m >= 1 && m <= 8 && (r == 2 || r == 4) && s_log2 >= 0 &&
      s_log2 <= 10 && threads >= 32 && threads <= kMaxThreads &&
      threads % 32 == 0 && (threads >> s_log2) << s_log2 == threads &&
      rows_per_block >= 1 && rows_per_block <= r * (threads >> s_log2) &&
      tile_rows >= 1 &&
      (size_t)4 * ((size_t)tile_rows * pad +
                   (size_t)(((1 << s_log2) + 31) / 32) * r *
                       (threads >> s_log2)) <= (size_t)smem_bytes;
  if (!ok) return (int)cudaErrorInvalidValue;
  const float* yp = (const float*)y;
  int* op = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (m) {
    case 1: err = launch_m<1>(yp, op, n, r, rows_per_block, s_log2, threads,
                              tile_rows, smem_bytes, s); break;
    case 2: err = launch_m<2>(yp, op, n, r, rows_per_block, s_log2, threads,
                              tile_rows, smem_bytes, s); break;
    case 3: err = launch_m<3>(yp, op, n, r, rows_per_block, s_log2, threads,
                              tile_rows, smem_bytes, s); break;
    case 4: err = launch_m<4>(yp, op, n, r, rows_per_block, s_log2, threads,
                              tile_rows, smem_bytes, s); break;
    case 5: err = launch_m<5>(yp, op, n, r, rows_per_block, s_log2, threads,
                              tile_rows, smem_bytes, s); break;
    case 6: err = launch_m<6>(yp, op, n, r, rows_per_block, s_log2, threads,
                              tile_rows, smem_bytes, s); break;
    case 7: err = launch_m<7>(yp, op, n, r, rows_per_block, s_log2, threads,
                              tile_rows, smem_bytes, s); break;
    default: err = launch_m<8>(yp, op, n, r, rows_per_block, s_log2, threads,
                               tile_rows, smem_bytes, s); break;
  }
  return (int)err;
}

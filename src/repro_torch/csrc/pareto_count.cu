// pareto_count: per row of y [n, m], the number of rows that strictly
// dominate it (minimization: all <= and any <), on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/pareto_count/kernel.py::
// dominance_counts (body _body). Plain version: repro_torch/kernels/
// pareto_count.py::dominance_counts_plain. Counts are exact integers, so the
// kernel and its plain version must agree bit for bit.
//
// What bounds it here: n^2 pairs of m comparisons each. At the main path's
// largest call (the reference front, n = 2500, m = 3) that is 6.25 M pairs,
// ~70 M compare/logic operations: ~1 us at the card's 67 T/s float32 issue
// rate, against 40 KB of input and output. What a simple kernel hits first
// is the serial chain of one thread: with one thread per row walking all n
// rows j, each thread runs n dependent iterations on 10 blocks (measured on
// the card: slower than the plain version).
//
// Design: a block owns 32 candidate rows i (one per lane, y_i in registers)
// and splits the rows j among 16 threads per row, so each thread's chain is
// n / 16 long and 79 blocks of 512 threads cover n = 2500. The block walks
// all rows j in tiles of 512 staged in shared memory (every y_j is read
// from device memory once per block; a warp reads one y_j at a time, a
// broadcast). The 16 partial counts of a row are summed through shared
// memory at the end. The Pallas kernel accumulated counts across a
// sequential grid axis; here the j loop runs inside the block, so no
// cross-block reduction (and no atomic) is needed. The objective count m is
// a template parameter so the compare loop unrolls fully.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;              // candidate rows i per block
constexpr int kSplit = 16;             // threads sharing one row's j range
constexpr int kTileJ = kRows * kSplit;  // rows j staged per step

template <int M>
__global__ void __launch_bounds__(kRows * kSplit)
pareto_count_kernel(const float* __restrict__ y, int* __restrict__ out,
                    int n) {
  __shared__ float tile[kTileJ * M];
  __shared__ int partial[kSplit][kRows];
  const int lane = threadIdx.x, part = threadIdx.y;
  const int tid = part * kRows + lane;
  const int i = blockIdx.x * kRows + lane;
  float yi[M];
#pragma unroll
  for (int k = 0; k < M; ++k) yi[k] = (i < n) ? y[(size_t)i * M + k] : 0.0f;

  int count = 0;
  for (int j0 = 0; j0 < n; j0 += kTileJ) {
    const int jn = min(kTileJ, n - j0);
    for (int e = tid; e < jn * M; e += kRows * kSplit)
      tile[e] = y[(size_t)j0 * M + e];
    __syncthreads();
    for (int j = part; j < jn; j += kSplit) {
      bool le = true, lt = false;
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const float a = tile[j * M + k];
        le = le && (a <= yi[k]);
        lt = lt || (a < yi[k]);
      }
      count += (le && lt) ? 1 : 0;
    }
    __syncthreads();
  }
  partial[part][lane] = count;
  __syncthreads();
  if (part == 0 && i < n) {
    int total = 0;
#pragma unroll
    for (int p = 0; p < kSplit; ++p) total += partial[p][lane];
    out[i] = total;
  }
}

template <int M>
void launch(const float* y, int* out, int n, cudaStream_t stream) {
  const dim3 block(kRows, kSplit);
  const int blocks = (n + kRows - 1) / kRows;
  pareto_count_kernel<M><<<blocks, block, 0, stream>>>(y, out, n);
}

}  // namespace

// y [n, m] float32 contiguous (1 <= m <= 8), out [n] int32.
extern "C" int pareto_count_launch(const void* y, void* out, int n, int m,
                                   void* stream) {
  const float* yp = (const float*)y;
  int* op = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 1: launch<1>(yp, op, n, s); break;
    case 2: launch<2>(yp, op, n, s); break;
    case 3: launch<3>(yp, op, n, s); break;
    case 4: launch<4>(yp, op, n, s); break;
    case 5: launch<5>(yp, op, n, s); break;
    case 6: launch<6>(yp, op, n, s); break;
    case 7: launch<7>(yp, op, n, s); break;
    case 8: launch<8>(yp, op, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// pairdist: pairwise squared distances ||x_i - y_j||^2 (optionally the fused
// RBF kernel exp(-d^2 * inv2s2)) on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/pairdist/kernel.py::pairdist
// (body _body). Plain version: repro_torch/kernels/pairdist.py::
// pairdist_plain (the max(|x|^2 + |y|^2 - 2 x y^T, 0) form).
//
// What bounds it here: at the main path's largest call (TED, 2500 x 2500,
// D = 26) the 25 MB output write takes ~7.6 us at 3.35 TB/s while the
// 2*N*M*D = 325 MFLOP cross term takes ~4.9 us at the 67 TFLOP/s float32
// (non-tensor-core) rate, so the kernel is bound by the bytes it writes and
// the stores have to overlap the arithmetic. The GP's calls (P x P, P x 2500,
// P x 512 and 512 x 512 with P <= ~72) are a few KB to 1 MB and are bound by
// launch latency and by how many blocks are in flight.
//
// Design: 256 threads (16 x 16) per block; each thread computes TM rows x 4
// consecutive columns, so a tile is 16*TM rows x 64 columns and each row of
// the tile is stored as 16-byte vectors (a scalar path takes a ragged or
// unaligned row). TM (8, 4, 2 or 1) is chosen per call by kernels/pairdist.py::
// launch_plan from the grid it gives: TED's 2500 x 2500 takes 128-row tiles
// (800 blocks, several an SM, so one tile's stores overlap another's
// arithmetic); the small GP shapes take 32- or 16-row tiles, two to four
// times the blocks 64 x 64 tiles give. The
// features are staged feature-major in shared memory all at once when
// d <= 32 (in chunks of 32 beyond). Each row's and column's squared norm is
// computed once, by one thread, beside its cross-term products, into shared
// memory. The cross term and both
// norms accumulate in float32 FMA (fmaf, feature order k = 0..d-1) on the
// CUDA cores, never TF32 tensor cores: the GP and TED need full float32
// distances. No input is padded; each output is written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSide = 16;           // threads per block edge (16 x 16)
constexpr int kCols = 4 * kSide;    // tile columns: 4 per thread
constexpr int kChunk = 32;          // features staged per step
constexpr int kYStride = kCols + 4; // 16-byte aligned rows of ys

template <int TM>
__global__ void __launch_bounds__(kSide * kSide)
pairdist_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, int n, int m, int d, int rbf,
                float inv2s2, int vec) {
  constexpr int kRows = kSide * TM;
  __shared__ float xs[kChunk][kRows + 1];  // + 1: staging writes spread
  __shared__ __align__(16) float ys[kChunk][kYStride];
  __shared__ float xxs[kRows];
  __shared__ float yys[kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int row0 = blockIdx.y * kRows, col0 = blockIdx.x * kCols;

  float acc[TM][4];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  // threads tid < kRows: row tid's norm; the next kCols: column's
  float norm = 0.0f;
  const float* nsrc = tid < kRows ? &xs[0][tid] : &ys[0][tid - kRows];
  const int nstride = tid < kRows ? kRows + 1 : kYStride;
  const bool has_norm = tid < kRows + kCols;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = (d - k0) < kChunk ? (d - k0) : kChunk;
    if (k0 > 0) __syncthreads();  // the previous chunk is consumed
    // every load of the chunk in flight before the first store: thread
    // (tx, ty) stages features tx and tx + 16 of rows ty + 16 i
    constexpr int kU = kChunk / kSide;
    float xv[TM][kU], yv[kCols / kSide][kU];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int g = row0 + ty + kSide * i;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = tx + kSide * u;
        xv[i][u] = (g < n && k < kc) ? x[(size_t)g * d + k0 + k] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < kCols / kSide; ++i) {
      const int g = col0 + ty + kSide * i;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = tx + kSide * u;
        yv[i][u] = (g < m && k < kc) ? y[(size_t)g * d + k0 + k] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int k = tx + kSide * u;
      if (k < kc) {
#pragma unroll
        for (int i = 0; i < TM; ++i) xs[k][ty + kSide * i] = xv[i][u];
#pragma unroll
        for (int i = 0; i < kCols / kSide; ++i)
          ys[k][ty + kSide * i] = yv[i][u];
      }
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&ys[k][4 * tx]);
#pragma unroll
      for (int p = 0; p < TM; ++p) {
        const float a = xs[k][ty + kSide * p];
        acc[p][0] = fmaf(a, b.x, acc[p][0]);
        acc[p][1] = fmaf(a, b.y, acc[p][1]);
        acc[p][2] = fmaf(a, b.z, acc[p][2]);
        acc[p][3] = fmaf(a, b.w, acc[p][3]);
      }
      if (has_norm) {
        const float v = nsrc[k * nstride];
        norm = fmaf(v, v, norm);
      }
    }
  }
  if (tid < kRows) {
    xxs[tid] = norm;
  } else if (has_norm) {
    yys[tid - kRows] = norm;
  }
  __syncthreads();

  const int c0 = col0 + 4 * tx;
  float yy[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) yy[q] = yys[4 * tx + q];
#pragma unroll
  for (int p = 0; p < TM; ++p) {
    const int r = row0 + ty + kSide * p;
    if (r >= n) continue;
    const float xx = xxs[ty + kSide * p];
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float d2 = fmaxf(xx + yy[q] - 2.0f * acc[p][q], 0.0f);
      v[q] = rbf ? expf(-d2 * inv2s2) : d2;
    }
    float* o = out + (size_t)r * m + c0;
    if (vec && c0 + 3 < m) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c0 + q < m) o[q] = v[q];
    }
  }
}

}  // namespace

// x [n, d], y [m, d], out [n, m]; all float32, contiguous. rbf != 0 writes
// exp(-d^2 * inv2s2) instead of d^2. tm (8, 4, 2 or 1): rows per thread, from
// kernels/pairdist.py::launch_plan.
extern "C" int pairdist_launch(const void* x, const void* y, void* out, int n,
                               int m, int d, int rbf, float inv2s2, int tm,
                               void* stream) {
  const dim3 block(kSide, kSide);
  const dim3 grid((m + kCols - 1) / kCols, (n + kSide * tm - 1) / (kSide * tm));
  const int vec = (m % 4 == 0) && ((uintptr_t)out % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  const float* yp = (const float*)y;
  float* op = (float*)out;
  if (tm == 8) {
    pairdist_kernel<8><<<grid, block, 0, st>>>(xp, yp, op, n, m, d, rbf,
                                              inv2s2, vec);
  } else if (tm == 4) {
    pairdist_kernel<4><<<grid, block, 0, st>>>(xp, yp, op, n, m, d, rbf,
                                              inv2s2, vec);
  } else if (tm == 2) {
    pairdist_kernel<2><<<grid, block, 0, st>>>(xp, yp, op, n, m, d, rbf,
                                              inv2s2, vec);
  } else if (tm == 1) {
    pairdist_kernel<1><<<grid, block, 0, st>>>(xp, yp, op, n, m, d, rbf,
                                              inv2s2, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

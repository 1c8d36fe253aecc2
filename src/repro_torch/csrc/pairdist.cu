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
// (non-tensor-core) rate, so the kernel is bound by the bytes it writes. The
// GP's calls (P x P, P x 2500, 512 x 512 with P <= ~72) are a few hundred KB
// to 1 MB and are bound by launch latency.
//
// Design: a 2D grid of 64 x 64 output tiles, 256 threads each computing a
// 4 x 4 register block. Row tiles of x and y are staged in shared memory in
// chunks of 16 features (stored feature-major, padded by one column against
// bank conflicts). The cross term and both norms accumulate in float32 FMA
// on the CUDA cores, never TF32 tensor cores: the GP and TED need full
// float32 distances. The ragged edges are masked in the loads and stores,
// so no input is padded. Each output is written once, coalesced along rows.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;   // output tile edge
constexpr int kChunk = 16;  // features staged per step
constexpr int kSide = 16;   // threads per tile edge (16 x 16 = 256)
constexpr int kReg = kTile / kSide;  // outputs per thread per edge (4)

__global__ void __launch_bounds__(kSide * kSide)
pairdist_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, int n, int m, int d, int rbf,
                float inv2s2) {
  __shared__ float xs[kChunk][kTile + 1];
  __shared__ float ys[kChunk][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;

  float acc[kReg][kReg];
  float xx[kReg], yy[kReg];
#pragma unroll
  for (int a = 0; a < kReg; ++a) {
    xx[a] = 0.0f;
    yy[a] = 0.0f;
#pragma unroll
    for (int b = 0; b < kReg; ++b) acc[a][b] = 0.0f;
  }

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kSide * kSide) {
      const int r = e / kChunk, k = e % kChunk, gk = k0 + k;
      const int gx = row0 + r, gy = col0 + r;
      xs[k][r] = (gx < n && gk < d) ? x[(size_t)gx * d + gk] : 0.0f;
      ys[k][r] = (gy < m && gk < d) ? y[(size_t)gy * d + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      float a[kReg], b[kReg];
#pragma unroll
      for (int s = 0; s < kReg; ++s) {
        a[s] = xs[k][ty + kSide * s];
        b[s] = ys[k][tx + kSide * s];
        xx[s] = fmaf(a[s], a[s], xx[s]);
        yy[s] = fmaf(b[s], b[s], yy[s]);
      }
#pragma unroll
      for (int p = 0; p < kReg; ++p)
#pragma unroll
        for (int q = 0; q < kReg; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kReg; ++p) {
    const int r = row0 + ty + kSide * p;
    if (r >= n) continue;
#pragma unroll
    for (int q = 0; q < kReg; ++q) {
      const int c = col0 + tx + kSide * q;
      if (c >= m) continue;
      const float d2 = fmaxf(xx[p] + yy[q] - 2.0f * acc[p][q], 0.0f);
      out[(size_t)r * m + c] = rbf ? expf(-d2 * inv2s2) : d2;
    }
  }
}

}  // namespace

// x [n, d], y [m, d], out [n, m]; all float32, contiguous. rbf != 0 writes
// exp(-d^2 * inv2s2) instead of d^2.
extern "C" int pairdist_launch(const void* x, const void* y, void* out, int n,
                               int m, int d, int rbf, float inv2s2,
                               void* stream) {
  const dim3 block(kSide, kSide);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  pairdist_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (float*)out, n, m, d, rbf, inv2s2);
  return (int)cudaGetLastError();
}

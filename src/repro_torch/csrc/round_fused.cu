// round_fused: one acquisition round of the incremental BO engine over the
// chunked candidate pool, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/round_fused/kernel.py::
// round_fused (body _round_body; wrapper ops.round_select). Plain version:
// repro_torch/kernels/round_fused.py::round_select_plain.
//
// Per pool column and objective i it recomputes rows s0..P-1 of the cached
// V = L^-1 K(x, pool) in place (RBF entries, then forward substitution over
// the full prefix of each row of L), takes the posterior moments in the
// engine's fixed order (beta[0]*V[0], then rows 1..P-1), de-standardizes,
// scores the MES gain over the S frozen frontier samples, weights it, masks
// evaluated columns to -inf, and the global first-index argmax follows.
//
// What bounds it here: at the main path's shapes (one chunk of C = 2500, m =
// 3, P = 72, d <= 26) V is 2.2 MB, about a microsecond of memory traffic,
// and the arithmetic is ~m*C*P*(d + P/2) ~ 25 M operations. What a simple
// kernel hits first is one thread's serial chain (the substitution is P*P/2
// dependent steps per objective) on only 20 blocks of 128 threads, plus
// the launch latency of two kernels.
//
// Design: grid (ceil(C / 128), nc), one thread per pool column, so a block
// never straddles two chunks and the ragged edge is masked, not padded (the
// TPU's 128-lane and 128-feature padding have no counterpart here). V is laid
// out [nc, m, P, C], so the threads of a warp read and write one row of V at
// consecutive addresses. x, L, beta and the small vectors are read through
// the read-only cache (every thread of a warp reads the same L[r, j], a
// broadcast), so P is bounded by nothing but device memory. The TPU kernel
// carried its running argmax in a (1, 1) block that its sequential grid
// revisited; a GPU grid runs in parallel, so pass 1 reduces each chunk with
// warp shuffles and one 64-bit atomicMax per warp on a packed key
// (order-preserving float bits << 32 | (0xFFFFFFFF - column): ties go to the
// lowest column; -0.0 counts as +0.0) and sets a per-chunk NaN flag; pass 2
// scans the nc chunk results in order with a strict > from (-inf, 0), which
// is the engine's chunk scan exactly. Atomic maxima do not depend on their
// order, so the pick is deterministic.
//
// Rounding: built with -fmad=false (kernels/build.py), so every product is
// rounded before its sum, as in the plain version, and each sum runs in the
// plain version's order. What differs are expf, erff, erfcf and logf (a few
// ulp here; correctly rounded in the plain version); V agrees to ~1e-5.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kHalfSqrt2 = 0.70710678118654752f;

// Phi(x) in jax.scipy.special.ndtr's form: 1 + erf near 0, erfc in the
// tails (the float32 lower tail survives).
__device__ __forceinline__ float ndtr(float x) {
  const float w = x * kHalfSqrt2;
  const float z = fabsf(w);
  float y;
  if (z < kHalfSqrt2) {
    y = 1.0f + erff(w);
  } else {
    y = (w > 0.0f) ? 2.0f - erfcf(z) : erfcf(z);
  }
  return 0.5f * y;
}

// Order-preserving key of a non-NaN score and its column.
__device__ __forceinline__ unsigned long long pack(float v, int col) {
  unsigned int b = __float_as_uint(v);
  if ((b << 1) == 0u) b = 0u;  // -0.0 -> +0.0
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | (0xFFFFFFFFu - (unsigned int)col);
}

__global__ void __launch_bounds__(kThreads)
round_pass1(const float* __restrict__ ls, const float* __restrict__ var,
            const float* __restrict__ L, float* __restrict__ V,
            const float* __restrict__ x, const float* __restrict__ beta,
            const float* __restrict__ ystar, const float* __restrict__ pool_c,
            const unsigned char* __restrict__ evalm,
            const float* __restrict__ y_mean, const float* __restrict__ y_std,
            const float* __restrict__ weights,
            unsigned long long* __restrict__ best, int* __restrict__ nanflag,
            int C, int d, int m, int P, int S, int s0) {
  const int j = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < C;
  float score = 0.0f;
  if (live) {
    const float* pc = pool_c + ((size_t)j * C + c) * d;
    for (int i = 0; i < m; ++i) {
      const float* lsi = ls + (size_t)i * d;
      const float* Li = L + (size_t)i * P * P;
      float* Vi = V + ((size_t)j * m + i) * P * (size_t)C + c;
      const float vari = var[i];
      if (s0 < P) {
        float bb = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float p = pc[k] / lsi[k];
          bb = (k == 0) ? p * p : bb + p * p;
        }
        for (int r = s0; r < P; ++r) {
          const float* xr = x + (size_t)r * d;
          float aa = 0.0f, cross = 0.0f;
          for (int k = 0; k < d; ++k) {
            const float a = xr[k] / lsi[k];
            const float p = pc[k] / lsi[k];
            aa = (k == 0) ? a * a : aa + a * a;
            cross = (k == 0) ? a * p : cross + a * p;
          }
          float d2 = (aa + bb) - 2.0f * cross;
          d2 = (d2 < 0.0f) ? 0.0f : d2;
          float acc = vari * expf(-0.5f * d2);
          const float* Lr = Li + (size_t)r * P;
          for (int q = 0; q < r; ++q) acc = acc - Lr[q] * Vi[(size_t)q * C];
          Vi[(size_t)r * C] = acc / Lr[r];
        }
      }
      const float* bi = beta + (size_t)i * P;
      const float v0 = Vi[0];
      float mu = bi[0] * v0, ss = v0 * v0;
      for (int p = 1; p < P; ++p) {
        const float v = Vi[(size_t)p * C];
        mu = mu + bi[p] * v;
        ss = ss + v * v;
      }
      float t = vari - ss;
      t = (t < 1e-10f) ? 1e-10f : t;  // NaN stays NaN, like clamp_min
      const float mean_d = mu * y_std[i] + y_mean[i];
      const float std_d = sqrtf(t) * y_std[i];
      float af = 0.0f;
      for (int s = 0; s < S; ++s) {
        const float g = (ystar[(size_t)s * m + i] - mean_d) / std_d;
        const float pdf = expf((kLog2Pi + g * g) / -2.0f);
        float cdf = ndtr(g);
        cdf = (cdf < 1e-9f) ? 1e-9f : ((cdf > 1.0f) ? 1.0f : cdf);
        const float term = g * pdf / (2.0f * cdf) - logf(cdf);
        af = (s == 0) ? term : af + term;
      }
      const float per = (af / (float)S) * weights[i];
      score = (i == 0) ? per : score + per;
    }
    if (evalm[(size_t)j * C + c]) score = -INFINITY;
  }
  const bool nan = live && isnan(score);
  unsigned long long key = (live && !nan) ? pack(score, c) : 0ull;
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, key, off);
    key = (o > key) ? o : key;
  }
  const bool any_nan = __any_sync(0xffffffffu, nan);
  if ((threadIdx.x & 31) == 0) {
    if (key != 0ull) atomicMax(best + j, key);
    if (any_nan) atomicOr(nanflag + j, 1);
  }
}

__global__ void round_pass2(const unsigned long long* __restrict__ best,
                            const int* __restrict__ nanflag, int nc, int C,
                            int* __restrict__ out) {
  float bv = -INFINITY;
  int bi = 0;
  for (int j = 0; j < nc; ++j) {
    const unsigned long long k = best[j];
    if (nanflag[j] || k == 0ull) continue;
    const unsigned int hi = (unsigned int)(k >> 32);
    const unsigned int b = (hi & 0x80000000u) ? (hi & 0x7FFFFFFFu) : ~hi;
    const float v = __uint_as_float(b);
    const int col = (int)(0xFFFFFFFFu - (unsigned int)(k & 0xFFFFFFFFull));
    if (v > bv) {
      bv = v;
      bi = j * C + col;
    }
  }
  *out = bi;
}

}  // namespace

// ls [m, d], var [m], L [m, P, P], V [nc, m, P, C] (updated in place),
// x [P, d], beta [m, P], ystar [S, m], pool_c [nc, C, d] float32; evalm
// [nc, C] bool; y_mean, y_std, weights [m] float32; scratch: 2*nc int64;
// out: one int32. All contiguous on the current device.
extern "C" int round_fused_launch(
    const void* ls, const void* var, const void* L, void* V, const void* x,
    const void* beta, const void* ystar, const void* pool_c,
    const void* evalm, const void* y_mean, const void* y_std,
    const void* weights, void* scratch, void* out, int nc, int C, int d,
    int m, int P, int S, int s0, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* best = (unsigned long long*)scratch;
  int* nanflag = (int*)(best + nc);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)nc * 16, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + kThreads - 1) / kThreads, nc);
  round_pass1<<<grid, kThreads, 0, st>>>(
      (const float*)ls, (const float*)var, (const float*)L, (float*)V,
      (const float*)x, (const float*)beta, (const float*)ystar,
      (const float*)pool_c, (const unsigned char*)evalm,
      (const float*)y_mean, (const float*)y_std, (const float*)weights, best,
      nanflag, C, d, m, P, S, s0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  round_pass2<<<1, 1, 0, st>>>(best, nanflag, nc, C, (int*)out);
  return (int)cudaGetLastError();
}

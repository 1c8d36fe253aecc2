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
// Given a `scores` buffer [nc, C], it also writes each column's masked score
// there (the engine's pool scores: one call at s0 >= P).
//
// What bounds it here: at the main path's shapes (one chunk of C = 2500, m =
// 3, P = 72, d = 26) V is 2.2 MB, under a microsecond of memory traffic, and
// the arithmetic is ~25 M operations, under a microsecond on the CUDA cores.
// What is left is latency: the substitution of one column is a chain of P
// dependent divisions, and the whole call is one launch. One tile's
// latency sets the time (PERF.md has it by phase, from
// tools/k4_attribution.py); at a large pool (10^5-10^6 columns) the blocks
// walk many tiles and the same per-tile latency, not V's bytes, sets it.
//
// Design (the launch plan is chosen in Python, kernels/round_fused.py::
// launch_plan, and checked here):
// - A block owns a tile of `ct` columns of one chunk and runs the m
//   objectives in waves of `w` slots; each (column, objective) pair has a
//   group of G = 8 lanes (a warp holds 4 columns of one objective; at the
//   main path 32 columns x 3 objectives, 768 threads, 79 blocks). One
//   thread per pair running down all rows measured 1.2-3.1x slower at
//   every timed shape (PERF.md). Blocks are persistent: they walk the
//   tiles of every chunk, so what a block stages once serves all its
//   tiles.
// - Scaled inputs once: x[r]/ls[i] and its norm aa for the rows s0..P-1, and
//   pool/ls and its norm bb for the tile's columns, go to shared memory,
//   each sum in feature order as the plain version takes it.
// - L: rows s0..P-1 of every objective are staged once per block with
//   cp.async ("resident"), or, where they do not fit, in panels of R rows
//   through a two-slot cp.async ring per tile and wave ("ring"), or read
//   from device memory where even a panel does not fit ("device").
// - V: the cached rows V[0:s0] of the tile are read once, coalesced along C,
//   into a shared-memory tile of `pv` rows (a column's rows contiguous, for
//   16-byte loads); the new rows stay there through the substitution and
//   the moments and are written once (rows >= pv, for very large P only,
//   live in device memory as the output itself).
// - Substitution, panel by panel (32 rows, or one 8-row panel for a block
//   update of up to 8 rows, where a lane owns one row and the instance
//   with one accumulator a lane runs): each lane keeps the accumulators of
//   its rows (r = r0 + k*G + t) in registers: the RBF entry, then the sum over
//   all rows above the panel (independent across rows; four L entries per
//   16-byte shared load), then the panel's triangle in the right-looking
//   form: the lane that owns row q divides, the value goes to the group by
//   __shfl_sync, and every row r > q subtracts L[r,q]*V[q]. Each row's sum
//   still runs q = 0, 1, ... in order.
// - Moments from the shared V tile (on lane 0 of the group), the S MES
//   terms spread over the lanes and added in order s = 0..S-1, the
//   objectives added in order i = 0..m-1 through shared memory.
// - One launch: the argmax is a per-warp 64-bit atomicMax on a packed key
//   (order-preserving float bits << 32 | (0xFFFFFFFF - column): ties go to
//   the lowest column; -0.0 counts as +0.0) and a per-chunk NaN flag; the
//   last block to finish (an atomic ticket after __threadfence) scans the
//   chunk results in order with a strict > from (-inf, 0), which is the
//   engine's chunk scan exactly, and resets the scratch to zero for the
//   next call, so no memset is needed. Atomic maxima do not depend on
//   their order, so the pick is deterministic.
//
// Rounding: built with -fmad=false (kernels/build.py), so every product is
// rounded before its sum, as in the plain version, and each sum runs in the
// plain version's order. What differs are expf, erff, erfcf and logf (a few
// ulp here; correctly rounded in the plain version); V agrees to ~1e-5.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int G = 8;  // lanes a (column, objective) pair
// 768 threads a block cap a thread at 80 registers (it spills ~190 bytes;
// a 384-thread variant without spills measured no faster)
constexpr int kMaxThreads = 768;
constexpr int kMaxRows = 32;  // panel rows R <= 32: G * (rows per lane)
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kHalfSqrt2 = 0.70710678118654752f;

enum LMode { kResident = 0, kRing = 1, kDevice = 2 };

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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Row stride of a staged row (of L, of scaled x or pool, of a V tile
// column): a multiple of 4 floats (16-byte loads) that is 4 mod 8, so 8
// consecutive rows start in 8 distinct 16-byte bank groups.
__host__ __device__ __forceinline__ int lstride(int P) {
  const int s = round4(P);
  return (s % 8 == 0) ? s + 4 : s;
}

struct Plan {
  int ct;     // columns per tile (a multiple of 32 / G)
  int w;      // objective slots per wave
  int R;      // panel rows (a multiple of G, <= kMaxRows)
  int lmode;  // LMode
  int xs;     // 1: scaled x and pool in shared memory; 0: divided inline
  int pv;     // rows of the V tile kept in shared memory
};

// Offsets (in floats) of the shared-memory regions; the same formula as
// kernels/round_fused.py::_smem_floats. Each region starts 16-byte aligned.
struct Layout {
  int L, xs, aa, ps, bb, vs, beta, per, total;
};

__host__ __device__ inline Layout layout(const Plan& p, int d, int m, int P,
                                         int B) {
  const int Ps = lstride(P), dp = lstride(d), vst = lstride(p.pv);
  int sz[8];
  const bool any = B > 0;
  sz[0] = !any ? 0
          : p.lmode == kResident ? m * B * Ps
          : p.lmode == kRing     ? 2 * p.w * p.R * Ps
                                 : 0;
  const bool xs = any && p.xs;
  sz[1] = !xs ? 0 : (p.lmode == kResident ? m * B * dp : p.w * p.R * dp);
  sz[2] = !xs ? 0 : (p.lmode == kResident ? m * B : p.w * p.R);
  sz[3] = !xs ? 0 : p.w * p.ct * dp;
  sz[4] = !any ? 0 : p.w * p.ct;
  sz[5] = p.w * p.ct * vst;
  sz[6] = p.w * vst;
  sz[7] = p.w * p.ct;
  int off[9];
  off[0] = 0;
  for (int k = 0; k < 8; ++k) off[k + 1] = off[k] + round4(sz[k]);
  return Layout{off[0], off[1], off[2], off[3], off[4], off[5], off[6],
                off[7], off[8]};
}

struct Args {
  const float* ls;      // [m, d]
  const float* var;     // [m]
  const float* L;       // [m, P, P]
  float* V;             // [nc, m, P, C]
  const float* x;       // [P, d]
  const float* beta;    // [m, P]
  const float* ystar;   // [S, m]
  const float* pool_c;  // [nc, C, d]
  const unsigned char* evalm;  // [nc, C]
  const float* y_mean;  // [m]
  const float* y_std;   // [m]
  const float* weights; // [m]
  unsigned long long* best;  // [nc], zero on entry, zero on exit
  int* nanflag;              // [nc], zero on entry, zero on exit
  unsigned int* ticket;      // one, zero on entry, zero on exit
  int* out;
  float* scores;  // [nc, C] masked scores, or null
  int nc, C, d, m, P, S, s0;
  int lvec;  // L rows in device memory may be read 16 bytes at a time
};

// Stage rows [r0, r0 + nr) of L (columns 0..r, the rest is never read) for
// objectives i0 + 0..nw-1 into dst (rows of stride Ps; slot-major, `rows`
// rows a slot) by cp.async: a warp per row, 16 bytes a lane where the rows
// of L are 16-byte aligned (a.lvec), else 4.
__device__ void stage_L(float* dst, const Args& a, int i0, int nw, int rows,
                        int r0, int nr, int Ps) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int row = threadIdx.x >> 5; row < nw * nr; row += nwarps) {
    const int sl = row / nr, rr = row - sl * nr, i = i0 + sl;
    if (i >= a.m) continue;
    const float* src = a.L + ((size_t)i * a.P + r0 + rr) * a.P;
    float* d = dst + ((size_t)sl * rows + rr) * Ps;
    const int n = r0 + rr + 1;  // columns 0..r
    if (a.lvec) {
      for (int q = 4 * lane; q < n; q += 128) cp_async16(d + q, src + q);
    } else {
      for (int q = lane; q < n; q += 32) cp_async4(d + q, src + q);
    }
  }
}

// out[k] = num[k] / den[k] for k < d and each row in [0, n_rows), with
// (num, den, out) = src(row) (num null: skip the row): a warp per row, four
// rows' loads in flight in each lane.
template <class Src>
__device__ void scale_block(int n_rows, int d, Src src) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int row0 = threadIdx.x >> 5; row0 < n_rows; row0 += 4 * nwarps) {
    for (int k = lane; k < d; k += 32) {
      float nv[4], dv[4];
      float* out[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = row0 + u * nwarps;
        const float* num = nullptr;
        const float* den = nullptr;
        out[u] = nullptr;
        if (row < n_rows) src(row, num, den, out[u]);
        if (!num) out[u] = nullptr;
        nv[u] = num ? num[k] : 0.0f;
        dv[u] = num ? den[k] : 1.0f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (out[u]) out[u][k] = nv[u] / dv[u];
    }
  }
}

// x[r]/ls[i] for rows [r0, r0 + nr) of objectives i0 + 0..nw-1 into xs
// (rows of stride dp, slot-major, `rows` rows a slot).
__device__ void scale_rows(float* xs, const Args& a, int i0, int nw, int rows,
                           int r0, int nr, int dp) {
  scale_block(nw * nr, a.d,
              [&](int row, const float*& num, const float*& den, float*& out) {
                const int sl = row / nr, rr = row - sl * nr;
                if (i0 + sl >= a.m) return;
                num = a.x + (size_t)(r0 + rr) * a.d;
                den = a.ls + (size_t)(i0 + sl) * a.d;
                out = xs + ((size_t)sl * rows + rr) * dp;
              });
}

// Squared norms of `n` staged rows of stride dp (d features), summed in
// feature order, one row a thread.
__device__ void row_norms(float* out, const float* rows, int n, int d,
                          int dp) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float* v = rows + (size_t)e * dp;
    float s = v[0] * v[0];
#pragma unroll 4
    for (int k = 1; k < d; ++k) s = s + v[k] * v[k];
    out[e] = s;
  }
}

// RPT: rows a lane owns in a panel (R <= G * RPT). 4 takes panels of up to
// 32 rows; 1 takes 8-row panels without the instructions of three idle
// rows, for a block update of up to 8 new rows (the engine's bucket).
template <int RPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
round_kernel(const Args a, const Plan p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ int last_block;

  const int m = a.m, P = a.P, C = a.C, d = a.d, S = a.S;
  const int s0 = a.s0 < P ? a.s0 : P;
  const int B = P - s0;
  const int Ps = lstride(P), dp = lstride(d), vst = lstride(p.pv);
  const Layout lay = layout(p, d, m, P, B);
  float* sL = sm + lay.L;
  float* sXs = sm + lay.xs;
  float* sAa = sm + lay.aa;
  float* sPs = sm + lay.ps;
  float* sBb = sm + lay.bb;
  float* sV = sm + lay.vs;
  float* sBeta = sm + lay.beta;
  float* sPer = sm + lay.per;

  const int tid = threadIdx.x;
  const int t = tid % G;                 // lane within the group
  const int c = (tid / G) % p.ct;        // column within the tile
  const int slot = tid / (G * p.ct);     // objective slot within the wave
  const int tpc = (C + p.ct - 1) / p.ct;
  const int ntiles = a.nc * tpc;
  const bool lvec = p.lmode != kDevice || a.lvec;
  float score = 0.0f;  // threads tid < ct: the tile's column tid

  // resident staging: L rows s0..P-1 and scaled x of every objective, once
  if (B > 0 && p.lmode == kResident) {
    stage_L(sL, a, 0, m, B, s0, B, Ps);
    cp_async_commit();
    scale_rows(sXs, a, 0, m, B, s0, B, dp);
    __syncthreads();
    row_norms(sAa, sXs, m * B, d, dp);
    cp_async_wait<0>();
  }
  __syncthreads();

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int j = tile / tpc;
    const int col0 = (tile % tpc) * p.ct;
    const int col = col0 + c;
    const bool col_live = col < C;
    const int colr = col_live ? col : C - 1;  // clamped for reads
    const float* pc = a.pool_c + ((size_t)j * C + colr) * d;

    for (int i0 = 0; i0 < m; i0 += p.w) {
      const int i = i0 + slot;
      const bool live = col_live && i < m;
      const int ir = i < m ? i : m - 1;  // clamped for reads
      float* Vg = a.V + ((size_t)j * m + ir) * P * (size_t)C + colr;
      // this pair's column of the V tile: rows q < pv at Vt[q]
      float* Vt = sV + ((size_t)slot * p.ct + c) * vst;
      const float vari = a.var[ir];

      // cp.async: the cached rows [0, min(s0, pv)) of the tile, coalesced
      // along C, and beta of the wave's objectives (rows < pv)
      {
        const int nq = s0 < p.pv ? s0 : p.pv;
        for (int sl = 0; sl < p.w && i0 + sl < m; ++sl) {
          const float* src = a.V + ((size_t)j * m + i0 + sl) * P * (size_t)C;
          float* dst = sV + (size_t)sl * p.ct * vst;
          for (int e = tid; e < nq * p.ct; e += blockDim.x) {
            const int q = e / p.ct, cc = e - q * p.ct;
            if (col0 + cc < C)
              cp_async4(dst + (size_t)cc * vst + q,
                        src + (size_t)q * C + col0 + cc);
          }
          const float* bsrc = a.beta + (size_t)(i0 + sl) * P;
          for (int q = tid; q < p.pv; q += blockDim.x)
            cp_async4(sBeta + sl * vst + q, bsrc + q);
        }
        cp_async_commit();
      }
      // pool/ls of the tile's columns, then its norm bb
      if (B > 0 && p.xs) {
        scale_block(p.w * p.ct, d,
                    [&](int e, const float*& num, const float*& den,
                        float*& out) {
                      const int sl = e / p.ct, cc = e - sl * p.ct;
                      if (i0 + sl >= m || col0 + cc >= C) return;
                      num = a.pool_c + ((size_t)j * C + col0 + cc) * d;
                      den = a.ls + (size_t)(i0 + sl) * d;
                      out = sPs + (size_t)e * dp;
                    });
      }
      cp_async_wait<0>();
      __syncthreads();
      if (B > 0) {
        if (p.xs) {
          row_norms(sBb, sPs, p.w * p.ct, d, dp);
        } else {
          for (int e = tid; e < p.w * p.ct; e += blockDim.x) {
            const int ii = i0 + e / p.ct, gc = col0 + e % p.ct;
            if (ii >= m || gc >= C) continue;
            const float* pcc = a.pool_c + ((size_t)j * C + gc) * d;
            const float* lsi = a.ls + (size_t)ii * d;
            float s = 0.0f;
            for (int k = 0; k < d; ++k) {
              const float v = pcc[k] / lsi[k];
              s = (k == 0) ? v * v : s + v * v;
            }
            sBb[e] = s;
          }
        }
      }

      const int np = (B + p.R - 1) / p.R;  // panels
      if (B > 0 && p.lmode == kRing) {
        stage_L(sL, a, i0, p.w, p.R, s0, (p.R < B ? p.R : B), Ps);
        cp_async_commit();
      }
      for (int pi = 0; pi < np; ++pi) {
        const int r0 = s0 + pi * p.R;
        const int nr = (P - r0) < p.R ? (P - r0) : p.R;  // rows this panel
        // where this panel's L rows, scaled x rows and norms live
        const float* Lrow;  // L[r0 + t, :]; rows k*G apart by lsk
        size_t lsk;
        const float* xrow;  // scaled x[r0 + t] (staged), rows k*G apart
        const float* aap;
        if (p.lmode == kRing) {
          if (pi + 1 < np) {
            const int r1 = r0 + p.R;
            stage_L(sL + (size_t)((pi + 1) & 1) * p.w * p.R * Ps, a, i0, p.w,
                    p.R, r1, (P - r1) < p.R ? (P - r1) : p.R, Ps);
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          Lrow = sL + ((size_t)(pi & 1) * p.w * p.R + slot * p.R + t) * Ps;
        } else if (p.lmode == kResident) {
          Lrow = sL + ((size_t)ir * B + (r0 - s0) + t) * Ps;
        } else {
          Lrow = a.L + ((size_t)ir * P + r0 + t) * P;
        }
        lsk = (size_t)G * (p.lmode == kDevice ? P : Ps);
        if (p.lmode == kResident) {
          xrow = sXs + ((size_t)ir * B + (r0 - s0) + t) * dp;
          aap = sAa + (size_t)ir * B + (r0 - s0) + t;
        } else {
          if (p.xs) {
            scale_rows(sXs, a, i0, p.w, p.R, r0, nr, dp);
            __syncthreads();
            for (int sl = 0; sl < p.w; ++sl)
              row_norms(sAa + sl * p.R, sXs + (size_t)sl * p.R * dp, nr, d,
                        dp);
          }
          xrow = sXs + ((size_t)slot * p.R + t) * dp;
          aap = sAa + (size_t)slot * p.R + t;
        }
        __syncthreads();

        // the RBF entries of this lane's rows
        float acc[RPT];
        if (p.xs) {
          const float* pcs = sPs + ((size_t)slot * p.ct + c) * dp;
          // cross term in feature order: f = 0, then four features a
          // 16-byte load, then the tail
          float cr[RPT];
          const float p0 = pcs[0];
#pragma unroll
          for (int k = 0; k < RPT; ++k)
            cr[k] = (k * G + t < nr) ? xrow[(size_t)k * G * dp] * p0 : 0.0f;
          int f = 1;
          if (d >= 4) {
            const float p1 = pcs[1], p2 = pcs[2], p3 = pcs[3];
#pragma unroll
            for (int k = 0; k < RPT; ++k)
              if (k * G + t < nr) {
                const float* xa = xrow + (size_t)k * G * dp;
                cr[k] = cr[k] + xa[1] * p1;
                cr[k] = cr[k] + xa[2] * p2;
                cr[k] = cr[k] + xa[3] * p3;
              }
            for (f = 4; f + 4 <= d; f += 4) {
              const float4 pf = *reinterpret_cast<const float4*>(pcs + f);
#pragma unroll
              for (int k = 0; k < RPT; ++k)
                if (k * G + t < nr) {
                  const float4 af = *reinterpret_cast<const float4*>(
                      xrow + (size_t)k * G * dp + f);
                  cr[k] = cr[k] + af.x * pf.x;
                  cr[k] = cr[k] + af.y * pf.y;
                  cr[k] = cr[k] + af.z * pf.z;
                  cr[k] = cr[k] + af.w * pf.w;
                }
            }
          }
          for (; f < d; ++f) {
            const float pf = pcs[f];
#pragma unroll
            for (int k = 0; k < RPT; ++k)
              if (k * G + t < nr)
                cr[k] = cr[k] + xrow[(size_t)k * G * dp + f] * pf;
          }
          const float bb = sBb[slot * p.ct + c];
#pragma unroll
          for (int k = 0; k < RPT; ++k) {
            acc[k] = 0.0f;
            if (k * G + t < nr) {
              float d2 = (aap[k * G] + bb) - 2.0f * cr[k];
              d2 = (d2 < 0.0f) ? 0.0f : d2;
              acc[k] = vari * expf(-0.5f * d2);
            }
          }
        } else {
          const float* lsi = a.ls + (size_t)ir * d;
          const float bb = sBb[slot * p.ct + c];
#pragma unroll
          for (int k = 0; k < RPT; ++k) {
            acc[k] = 0.0f;
            if (k * G + t < nr) {
              const float* xr = a.x + (size_t)(r0 + k * G + t) * d;
              float aa = 0.0f, cross = 0.0f;
              for (int f = 0; f < d; ++f) {
                const float av = xr[f] / lsi[f];
                const float pv = pc[f] / lsi[f];
                aa = (f == 0) ? av * av : aa + av * av;
                cross = (f == 0) ? av * pv : cross + av * pv;
              }
              float d2 = (aa + bb) - 2.0f * cross;
              d2 = (d2 < 0.0f) ? 0.0f : d2;
              acc[k] = vari * expf(-0.5f * d2);
            }
          }
        }

        // rows above the panel: acc[r] -= L[r, q] * V[q], q = 0 .. r0-1
        {
          const int qs = r0 < p.pv ? r0 : p.pv;  // V rows in the tile
          int q = 0;
          if (lvec) {
            for (; q + 4 <= qs; q += 4) {
              const float4 vq = *reinterpret_cast<const float4*>(Vt + q);
              const float v0 = vq.x, v1 = vq.y, v2 = vq.z, v3 = vq.w;
#pragma unroll
              for (int k = 0; k < RPT; ++k)
                if (k * G + t < nr) {
                  const float4 l =
                      *reinterpret_cast<const float4*>(Lrow + k * lsk + q);
                  acc[k] = acc[k] - l.x * v0;
                  acc[k] = acc[k] - l.y * v1;
                  acc[k] = acc[k] - l.z * v2;
                  acc[k] = acc[k] - l.w * v3;
                }
            }
          }
          for (; q < r0; ++q) {
            const float v = q < p.pv ? Vt[q] : Vg[(size_t)q * C];
#pragma unroll
            for (int k = 0; k < RPT; ++k)
              if (k * G + t < nr) acc[k] = acc[k] - Lrow[k * lsk + q] * v;
          }
        }

        // the panel's triangle, right-looking: row q's owner divides and
        // hands V[q] to its group; rows r > q subtract L[r, q] * V[q]
#pragma unroll
        for (int kq = 0; kq < RPT; ++kq) {
          for (int tq = 0; tq < G; ++tq) {
            const int rq = kq * G + tq;  // row r0 + rq
            if (rq >= nr) break;
            const int q = r0 + rq;
            float v = 0.0f;
            if (t == tq) v = acc[kq] / Lrow[kq * lsk + q];
            v = __shfl_sync(0xffffffffu, v, tq, G);
            if (t == tq) {
              if (q < p.pv) {
                Vt[q] = v;
              } else if (live) {
                Vg[(size_t)q * C] = v;
              }
            }
#pragma unroll
            for (int k = kq; k < RPT; ++k)
              if (k * G + t > rq && k * G + t < nr)
                acc[k] = acc[k] - Lrow[k * lsk + q] * v;
          }
        }
        __syncthreads();  // the panel's rows are in; its buffers are free
      }

      // the new rows [s0, min(P, pv)) of the tile, written once, coalesced
      if (B > 0) {
        const int hi = P < p.pv ? P : p.pv;
        const int nq = hi > s0 ? hi - s0 : 0;
        const int n = p.w * nq * p.ct;
        for (int e = tid; e < n; e += blockDim.x) {
          const int cc = e % p.ct, q = s0 + (e / p.ct) % nq;
          const int sl = e / (p.ct * nq);
          const int ii = i0 + sl, gc = col0 + cc;
          if (ii < m && gc < C)
            a.V[(((size_t)j * m + ii) * P + q) * C + gc] =
                sV[((size_t)sl * p.ct + cc) * vst + q];
        }
      }

      // moments in the engine's order on lane 0: rows 1..3, then the rows
      // in the V tile eight at a time (two 16-byte loads each of V and beta
      // ahead of the sums), then any rows in device memory
      // the scoring's scalars, loaded here so that the moments hide their
      // latency (loaded earlier, they would hold registers through the
      // substitution)
      const float ystd = a.y_std[ir], ymean = a.y_mean[ir];
      const float wgt = a.weights[ir];
      const float ys0 = t < S ? a.ystar[(size_t)t * m + ir] : 0.0f;
      const float* bi = sBeta + (size_t)slot * vst;     // rows < pv
      const float* big = a.beta + (size_t)ir * P;       // rows >= pv
      float mu = 0.0f, ss = 0.0f;
      if (t == 0) {
        const int qs = P < p.pv ? P : p.pv;
        const float v0 = qs > 0 ? Vt[0] : Vg[0];
        mu = (qs > 0 ? bi[0] : big[0]) * v0;
        ss = v0 * v0;
        int q = 1;
        for (; q < 4 && q < qs; ++q) {
          const float v = Vt[q];
          mu = mu + bi[q] * v;
          ss = ss + v * v;
        }
        for (; q + 8 <= qs; q += 8) {
          float vv[8], b8[8];
#pragma unroll
          for (int u = 0; u < 8; u += 4) {
            *reinterpret_cast<float4*>(vv + u) =
                *reinterpret_cast<const float4*>(Vt + q + u);
            *reinterpret_cast<float4*>(b8 + u) =
                *reinterpret_cast<const float4*>(bi + q + u);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            mu = mu + b8[u] * vv[u];
            ss = ss + vv[u] * vv[u];
          }
        }
        for (; q < qs; ++q) {
          const float v = Vt[q];
          mu = mu + bi[q] * v;
          ss = ss + v * v;
        }
        for (; q < P; ++q) {
          const float v = Vg[(size_t)q * C];
          mu = mu + big[q] * v;
          ss = ss + v * v;
        }
      }
      ss = __shfl_sync(0xffffffffu, ss, 0, G);
      float tv = vari - ss;
      tv = (tv < 1e-10f) ? 1e-10f : tv;  // NaN stays NaN, like clamp_min
      float mean_d = mu * ystd + ymean;
      mean_d = __shfl_sync(0xffffffffu, mean_d, 0, G);
      const float std_d = sqrtf(tv) * ystd;

      // MES: the S terms spread over the lanes, added in order
      float af = 0.0f;
      for (int sb = 0; sb < S; sb += G) {
        const int s = sb + t;
        float term = 0.0f;
        if (s < S) {
          const float yst = sb == 0 ? ys0 : a.ystar[(size_t)s * m + ir];
          const float g = (yst - mean_d) / std_d;
          const float pdf = expf((kLog2Pi + g * g) / -2.0f);
          float cdf = ndtr(g);
          cdf = (cdf < 1e-9f) ? 1e-9f : ((cdf > 1.0f) ? 1.0f : cdf);
          term = g * pdf / (2.0f * cdf) - logf(cdf);
        }
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const float tu = __shfl_sync(0xffffffffu, term, u, G);
          if (sb + u < S) af = (sb + u == 0) ? tu : af + tu;
        }
      }
      if (t == 0) sPer[slot * p.ct + c] = (af / (float)S) * wgt;
      __syncthreads();
      if (tid < p.ct) {
        for (int sl = 0; sl < p.w && i0 + sl < m; ++sl) {
          const float per = sPer[sl * p.ct + tid];
          score = (i0 + sl == 0) ? per : score + per;
        }
      }
      __syncthreads();  // the V tile and sPer are free for the next wave
    }

    // the tile's best key and NaN flag, one atomic per warp
    const int nw32 = (p.ct + 31) / 32;
    if (tid < nw32 * 32) {
      const int gc = col0 + tid;
      const bool lv = tid < p.ct && gc < C;
      float sc = score;
      if (lv && a.evalm[(size_t)j * C + gc]) sc = -INFINITY;
      if (lv && a.scores) a.scores[(size_t)j * C + gc] = sc;
      const bool nan = lv && isnan(sc);
      unsigned long long key = (lv && !nan) ? pack(sc, gc) : 0ull;
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_down_sync(0xffffffffu, key, off);
        key = (o > key) ? o : key;
      }
      const bool any_nan = __any_sync(0xffffffffu, nan);
      if ((tid & 31) == 0) {
        if (key != 0ull) atomicMax(a.best + j, key);
        if (any_nan) atomicOr(a.nanflag + j, 1);
        __threadfence();
      }
    }
  }

  // the last block to finish scans the chunk results and resets the scratch
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_block = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last_block && tid == 0) {
    __threadfence();
    float bv = -INFINITY;
    int bi = 0;
    for (int jj = 0; jj < a.nc; ++jj) {
      const unsigned long long k = atomicExch(a.best + jj, 0ull);
      const int nanj = atomicExch(a.nanflag + jj, 0);
      if (nanj || k == 0ull) continue;
      const unsigned int hi = (unsigned int)(k >> 32);
      const unsigned int b = (hi & 0x80000000u) ? (hi & 0x7FFFFFFFu) : ~hi;
      const float v = __uint_as_float(b);
      const int cl = (int)(0xFFFFFFFFu - (unsigned int)(k & 0xFFFFFFFFull));
      if (v > bv) {
        bv = v;
        bi = jj * C + cl;
      }
    }
    *a.out = bi;
    atomicExch(a.ticket, 0u);
  }
}

template <int RPT>
cudaError_t launch(const Args& a, const Plan& p, int smem_bytes,
                   cudaStream_t st) {
  const int threads = p.w * p.ct * G;
  cudaError_t err = cudaFuncSetAttribute(
      round_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, round_kernel<RPT>, threads, smem_bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long ntiles =
      (long long)a.nc * ((a.C + p.ct - 1) / p.ct);
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(ntiles < cap ? ntiles : cap);
  round_kernel<RPT><<<grid, threads, smem_bytes, st>>>(a, p);
  return cudaGetLastError();
}

}  // namespace

// ls [m, d], var [m], L [m, P, P], V [nc, m, P, C] (updated in place),
// x [P, d], beta [m, P], ystar [S, m], pool_c [nc, C, d] float32; evalm
// [nc, C] bool; y_mean, y_std, weights [m] float32; scratch: nc uint64 then
// nc int32 then one uint32, all zero (the kernel leaves them zero); out: one
// int32; scores: [nc, C] float32 or null. All contiguous on the current
// device. The plan (ct, w, R, lmode,
// xs, pv, smem_bytes) comes from kernels/round_fused.py::launch_plan;
// a plan whose shared memory does not add up is refused.
extern "C" int round_fused_launch(
    const void* ls, const void* var, const void* L, void* V, const void* x,
    const void* beta, const void* ystar, const void* pool_c,
    const void* evalm, const void* y_mean, const void* y_std,
    const void* weights, void* scratch, void* out, void* scores, int nc,
    int C, int d, int m, int P, int S, int s0, int ct, int w, int R,
    int lmode, int xs, int pv, int smem_bytes, void* stream) {
  Args a;
  a.ls = (const float*)ls;
  a.var = (const float*)var;
  a.L = (const float*)L;
  a.V = (float*)V;
  a.x = (const float*)x;
  a.beta = (const float*)beta;
  a.ystar = (const float*)ystar;
  a.pool_c = (const float*)pool_c;
  a.evalm = (const unsigned char*)evalm;
  a.y_mean = (const float*)y_mean;
  a.y_std = (const float*)y_std;
  a.weights = (const float*)weights;
  a.best = (unsigned long long*)scratch;
  a.nanflag = (int*)(a.best + nc);
  a.ticket = (unsigned int*)(a.nanflag + nc);
  a.out = (int*)out;
  a.scores = (float*)scores;
  a.nc = nc;
  a.C = C;
  a.d = d;
  a.m = m;
  a.P = P;
  a.S = S;
  a.s0 = s0 < P ? s0 : P;
  a.lvec = (P % 4 == 0) && ((uintptr_t)L % 16 == 0);
  const Plan p{ct, w, R, lmode, xs, pv};
  const int B = P - a.s0;
  const bool ok =
      ct >= 1 && (ct * G) % 32 == 0 && w >= 1 && w <= m &&
      w * ct * G <= kMaxThreads && R >= G && R <= kMaxRows && R % G == 0 &&
      lmode >= kResident &&
      lmode <= kDevice && (lmode != kResident || xs) && pv >= 0 && pv <= P &&
      (size_t)layout(p, d, m, P, B).total * 4 <= (size_t)smem_bytes;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(R <= G ? launch<1>(a, p, smem_bytes, st)
                      : launch<kMaxRows / G>(a, p, smem_bytes, st));
}

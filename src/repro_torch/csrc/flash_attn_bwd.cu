// flash_attn_bwd: the backward of kernel K5's bf16 route (causal attention
// without a window, for training), on Hopper tensor cores with mma.sync.
//
// The TPU kernel repro/kernels/flash_attn/kernel.py::flash_attention has no
// backward: the reference's models never call it and differentiate their
// plain _sdpa (repro/models/attention.py) with jax.value_and_grad. The port
// runs K5 in the training forward (csrc/flash_attn_tc.cu), so its gradient
// is a kernel too. Plain version: repro_torch/kernels/flash_attn.py::
// flash_attention_backward_plain (the materialized float32 softmax of
// flash_attn/ref.py differentiated, K/V heads repeated, then summed).
//
// Computes, for q [B, S, H, DQK], k [B, S, KH, DQK], v [B, S, KH, DV], the
// forward's output o [B, S, H, DV] and its row statistic lse [B, H, S]
// (base 2: lse = log2 sum_j exp2(s_ij c), s = q.k, c = scale * log2(e)),
// and the output's gradient do [B, S, H, DV], all bf16 but lse:
//   P_ij  = exp2(s_ij c - lse_i)          (0 where j > i: the causal mask)
//   D_i   = sum_d do_id o_id              (float32)
//   dS_ij = P_ij (do_i . v_j - D_i)
//   dq_i  = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,
//   dv_j  = sum_i P_ij do_i,
// with g = h / (H / KH): dk and dv of KV head g sum the gradients of its
// H / KH query heads. Products take bf16 operands (P and dS rounded to bf16)
// and float32 accumulators; outputs are bf16 (round to nearest even).
//
// What bounds it: five products of 2 hd operations a (query, key) pair:
// at starcoder2-3b's training shape (B 2, S 2048, H 24, KH 2, hd 128)
// 2,098,176 causal pairs a (b, h) x 48 x 10 x 128 = 1.29e11 operations,
// 0.130 ms at the bf16 tensor-core peak, against 63 MB in 0.019 ms. The
// operations bound it, so the products run on the tensor cores.
//
// Design (simple first; no TMA or wgmma yet). Four launches on the stream:
// 1. delta: D [B, H, S] in float32, one warp a row.
// 2. dk/dv: one block of 4 warps per (tile of 64 keys, b, query head h),
//    the key tiles nearest the start first (they see the most queries).
//    K and V rows of the tile stay in shared memory; query rows stream in
//    chunks of 32 (q, do, lse, D) from the tile's first key on (earlier
//    queries see none of its keys). Each warp owns 16 keys and computes
//    S^T = K Q^T and dP^T = V dO^T with keys as rows, so P^T and dS^T sit
//    in the accumulator fragment that, packed to bf16, is the A operand of
//    dV += P^T dO and dK += dS^T Q (B by ldmatrix.trans from the row-major
//    chunk). The block writes float32 partials of its query head:
//    dkp, dvp [B, S, H, D].
// 3. dq: one block of 4 warps per (tile of 64 queries, b, h), the last
//    tiles first; key rows stream in chunks of 32 up to the tile's last
//    row; S = Q K^T, dP = dO V^T, dS, dQ += dS K; bf16 out, no partials
//    (each query head owns its rows).
// 4. group sum: dk (dv) of KV head g = bf16 of the sum of the partials of
//    query heads g (H/KH) .. g (H/KH) + H/KH - 1, in that order.
// No float atomics anywhere: every sum has a fixed order, so the backward
// is bitwise repeatable run to run. Per-query-head partials keep the dk/dv
// grid at (S/64) B H blocks (1536 at starcoder2's shape; a grid over KV
// heads alone would give 128 blocks for 132 SMs). Shared rows are padded by
// 8 bf16 (16 bytes) so that the 8 rows a fragment load touches fall in 8
// distinct bank groups. Rows at or past S load as zeros and are masked;
// nothing is written for them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;     // a block's own rows: 4 warps of 16
constexpr int kChunk = 32;    // rows of the other side a step
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 elements past each shared row

template <int DQK, int DV>
constexpr int smem_bytes() {
  return (kTile + kChunk) * (DQK + kPad + DV + kPad) * 2 + 2 * kChunk * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += A.B: m16n8k16, A [16 x 16] row-major bf16 (a0: row g, cols 2t..2t+1;
// a1: row g+8; a2: row g, cols 8+2t..; a3: row g+8, cols 8+2t..), B
// [16 x 8] (b0: k 2t..2t+1, col g; b1: k 8+2t..), d [16 x 8] float32 (d0,
// d1: row g, cols 2t, 2t+1; d2, d3: row g+8); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices, transposed: lane i gives the address of row i % 8 of
// matrix i / 8; register m holds (row 2t, col g) and (row 2t + 1, col g) of
// matrix m.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The A fragment of rows row..row+15, columns col..col+15 of a row-major
// shared matrix with LD elements a row.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int row, int col, int g, int t) {
  a[0] = ld32(s + (row + g) * LD + col + 2 * t);
  a[1] = ld32(s + (row + g + 8) * LD + col + 2 * t);
  a[2] = ld32(s + (row + g) * LD + col + 8 + 2 * t);
  a[3] = ld32(s + (row + g + 8) * LD + col + 8 + 2 * t);
}

// B fragments of X.Y^T for the n-tile of Y's rows n0..n0+7 at columns
// col..col+15 (Y row-major, the contraction dim contiguous).
template <int LD>
__device__ __forceinline__ void mma_xyt(float (&d)[4], const uint32_t (&a)[4],
                                        const bf16* y, int n0, int col, int g,
                                        int t) {
  const bf16* p = y + (n0 + g) * LD + col + 2 * t;
  mma(d, a, ld32(p), ld32(p + 8));
}

// d[n] += A.Y[k0..k0+15, :] for every 8 columns n of a row-major shared Y
// with N columns (B by ldmatrix.trans, two n-tiles a load).
template <int N, int LD>
__device__ __forceinline__ void mma_ay(float (&d)[N / 8][4],
                                       const uint32_t (&a)[4], const bf16* y,
                                       int k0, int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < N / 8; n += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, smem_u32(y + row * LD + n * 8 + col));
    mma(d[n], a, b[0], b[1]);
    mma(d[n + 1], a, b[2], b[3]);
  }
}

// The accumulator tiles c[2 kk], c[2 kk + 1] (16 rows x 16 columns) as the
// bf16 A fragment of k step kk.
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[N][4],
                                       int kk) {
  a[0] = pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Rows r0..r0+R-1 of head `head` of a [B, S, heads, D] bf16 tensor into
// shared rows of D + kPad elements; rows at or past S are zeros.
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int b,
                                          int r0, int head, int S,
                                          int heads) {
  constexpr int kVec = D / 8;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < R * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(b) * S + r0 + r) * heads + head) * D +
          c);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = val;
  }
}

// D[b, h, s] = sum_d do[b, s, h, d] o[b, s, h, d]: one warp a row.
template <int DV>
__global__ void __launch_bounds__(256)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             float* __restrict__ delta, int S, int H, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* op = o + row * DV;
  const bf16* dp = dout + row * DV;
  float acc = 0.0f;
#pragma unroll
  for (int c = 2 * lane; c < DV; c += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(op + c));
    const float2 d = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dp + c));
    acc = fmaf(a.x, d.x, acc);
    acc = fmaf(a.y, d.y, acc);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long bs = row / H;
    const long long b = bs / S, s = bs % S;
    delta[(b * H + h) * S + s] = acc;
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dkp, float* __restrict__ dvp, int S, int H,
            int KH, int BH, float scale, float scale_log2) {
  constexpr int LQ = DQK + kPad, LV = DV + kPad;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [kTile][LQ]
  bf16* vs = ks + kTile * LQ;                  // [kTile][LV]
  bf16* qs = vs + kTile * LV;                  // [kChunk][LQ]
  bf16* dos = qs + kChunk * LQ;                // [kChunk][LV]
  float* lse_s = reinterpret_cast<float*>(dos + kChunk * LV);
  float* del_s = lse_s + kChunk;

  const int tile = static_cast<int>(blockIdx.x) / BH;  // heaviest first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H, gkv = h / (H / KH);
  const int k0 = tile * kTile;
  load_rows<DQK, kTile>(ks, k, b, k0, gkv, S, KH);
  load_rows<DV, kTile>(vs, v, b, k0, gkv, S, KH);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = k0 + warp * 16;          // the warp's first key
  const int key0 = kw + g, key1 = key0 + 8;
  const float* lse_b = lse + static_cast<size_t>(bh) * S;
  const float* del_b = delta + static_cast<size_t>(bh) * S;

  float dk[DQK / 8][4], dv[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DQK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.0f;

  for (int c0 = k0; c0 < S; c0 += kChunk) {
    __syncthreads();  // the last chunk is consumed
    load_rows<DQK, kChunk>(qs, q, b, c0, h, S, H);
    load_rows<DV, kChunk>(dos, dout, b, c0, h, S, H);
    if (threadIdx.x < kChunk) {
      const int i = c0 + threadIdx.x;
      lse_s[threadIdx.x] = i < S ? lse_b[i] : 0.0f;
      del_s[threadIdx.x] = i < S ? del_b[i] : 0.0f;
    }
    __syncthreads();
    if (c0 + kChunk - 1 < kw) continue;  // no query of the chunk sees a key

    // S^T = K Q^T: 16 keys x kChunk queries
    float st[kChunk / 8][4];
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      uint32_t a[4];
      frag_a<LQ>(a, ks, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n)
        mma_xyt<LQ>(st[n], a, qs, n * 8, kk * 16, g, t);
    }
    // P^T, 0 where the key is past the query or the query past S
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t + e, i = c0 + c;
        const float l = lse_s[c];
        st[n][e] = (i < S && key0 <= i)
                       ? exp2f(fmaf(st[n][e], scale_log2, -l)) : 0.0f;
        st[n][2 + e] = (i < S && key1 <= i)
                           ? exp2f(fmaf(st[n][2 + e], scale_log2, -l)) : 0.0f;
      }
    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t a[4];
      c_to_a<kChunk / 8>(a, st, kk);
      mma_ay<DV, LV>(dv, a, dos, kk * 16, lane);
    }
    // dP^T = V dO^T
    float dp[kChunk / 8][4];
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      uint32_t a[4];
      frag_a<LV>(a, vs, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n)
        mma_xyt<LV>(dp[n], a, dos, n * 8, kk * 16, g, t);
    }
    // dS^T = P^T (dP^T - D)
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = del_s[n * 8 + 2 * t + e];
        dp[n][e] = st[n][e] * (dp[n][e] - d);
        dp[n][2 + e] = st[n][2 + e] * (dp[n][2 + e] - d);
      }
    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t a[4];
      c_to_a<kChunk / 8>(a, dp, kk);
      mma_ay<DQK, LQ>(dk, a, qs, kk * 16, lane);
    }
  }

  // float32 partials of query head h: dkp/dvp [B, S, H, D]
  const size_t row_k = static_cast<size_t>(H) * DQK;
  const size_t row_v = static_cast<size_t>(H) * DV;
  float* dkb = dkp + (static_cast<size_t>(b) * S * H + h) * DQK + 2 * t;
  float* dvb = dvp + (static_cast<size_t>(b) * S * H + h) * DV + 2 * t;
#pragma unroll
  for (int n = 0; n < DQK / 8; ++n) {
    if (key0 < S)
      *reinterpret_cast<float2*>(dkb + key0 * row_k + n * 8) =
          make_float2(scale * dk[n][0], scale * dk[n][1]);
    if (key1 < S)
      *reinterpret_cast<float2*>(dkb + key1 * row_k + n * 8) =
          make_float2(scale * dk[n][2], scale * dk[n][3]);
  }
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    if (key0 < S)
      *reinterpret_cast<float2*>(dvb + key0 * row_v + n * 8) =
          make_float2(dv[n][0], dv[n][1]);
    if (key1 < S)
      *reinterpret_cast<float2*>(dvb + key1 * row_v + n * 8) =
          make_float2(dv[n][2], dv[n][3]);
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int S, int H, int KH, int BH, int nt,
          float scale, float scale_log2) {
  constexpr int LQ = DQK + kPad, LV = DV + kPad;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [kTile][LQ]
  bf16* dos = qs + kTile * LQ;                 // [kTile][LV]
  bf16* ks = dos + kTile * LV;                 // [kChunk][LQ]
  bf16* vs = ks + kChunk * LQ;                 // [kChunk][LV]

  const int tile = nt - 1 - static_cast<int>(blockIdx.x) / BH;  // heaviest first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H, gkv = h / (H / KH);
  const int q0 = tile * kTile;
  load_rows<DQK, kTile>(qs, q, b, q0, h, S, H);
  load_rows<DV, kTile>(dos, dout, b, q0, h, S, H);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qw = q0 + warp * 16;          // the warp's first query
  const int row0 = qw + g, row1 = row0 + 8;
  const float* lse_b = lse + static_cast<size_t>(bh) * S;
  const float* del_b = delta + static_cast<size_t>(bh) * S;
  const float l0 = row0 < S ? lse_b[row0] : 0.0f;
  const float l1 = row1 < S ? lse_b[row1] : 0.0f;
  const float d0 = row0 < S ? del_b[row0] : 0.0f;
  const float d1 = row1 < S ? del_b[row1] : 0.0f;

  float acc[DQK / 8][4];
#pragma unroll
  for (int n = 0; n < DQK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const int last = min(q0 + kTile, S) - 1;  // the block's last query
  for (int c0 = 0; c0 <= last; c0 += kChunk) {
    __syncthreads();  // the last chunk is consumed (and the tile loaded)
    load_rows<DQK, kChunk>(ks, k, b, c0, gkv, S, KH);
    load_rows<DV, kChunk>(vs, v, b, c0, gkv, S, KH);
    __syncthreads();
    if (c0 > qw + 15) continue;  // every key of the chunk past the rows

    // S = Q K^T: 16 queries x kChunk keys
    float s[kChunk / 8][4];
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      uint32_t a[4];
      frag_a<LQ>(a, qs, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n)
        mma_xyt<LQ>(s[n], a, ks, n * 8, kk * 16, g, t);
    }
    // dP = dO V^T
    float dp[kChunk / 8][4];
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      uint32_t a[4];
      frag_a<LV>(a, dos, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n)
        mma_xyt<LV>(dp[n], a, vs, n * 8, kk * 16, g, t);
    }
    // dS = P (dP - D), P 0 where the key is past the query
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = c0 + n * 8 + 2 * t + e;
        const float p0 =
            j <= row0 ? exp2f(fmaf(s[n][e], scale_log2, -l0)) : 0.0f;
        const float p1 =
            j <= row1 ? exp2f(fmaf(s[n][2 + e], scale_log2, -l1)) : 0.0f;
        dp[n][e] = p0 * (dp[n][e] - d0);
        dp[n][2 + e] = p1 * (dp[n][2 + e] - d1);
      }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t a[4];
      c_to_a<kChunk / 8>(a, dp, kk);
      mma_ay<DQK, LQ>(acc, a, ks, kk * 16, lane);
    }
  }

  const size_t row_q = static_cast<size_t>(H) * DQK;
  bf16* dqb = dq + (static_cast<size_t>(b) * S * H + h) * DQK + 2 * t;
#pragma unroll
  for (int n = 0; n < DQK / 8; ++n) {
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(dqb + row0 * row_q + n * 8) =
          pack(scale * acc[n][0], scale * acc[n][1]);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(dqb + row1 * row_q + n * 8) =
          pack(scale * acc[n][2], scale * acc[n][3]);
  }
}

// out[b, s, g, d] = bf16(sum_{r < G} part[b, s, g G + r, d]), r ascending.
__global__ void __launch_bounds__(256)
group_sum_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                 long long n, int KH, int G, int D) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int d = static_cast<int>(i % D);
    const long long pg = i / D;  // (b S + s) KH + g
    const float* p = part + (pg * G) * D + d;
    float acc = 0.0f;
    for (int r = 0; r < G; ++r) acc += p[static_cast<long long>(r) * D];
    out[i] = __float2bfloat16_rn(acc);
  }
}

int group_sum(const float* part, bf16* out, long long n, int KH, int G,
              int D, cudaStream_t stream) {
  const long long blocks = std::min<long long>((n + 255) / 256, 132 * 16);
  group_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      part, out, n, KH, G, D);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, bf16* dq, bf16* dk, bf16* dv,
           float* delta, float* dkp, float* dvp, int B, int S, int H, int KH,
           float scale, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<DQK, DV>();
  static bool configured = false;  // above 48 KB only after opting in
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dq_kernel<DQK, DV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long rows = static_cast<long long>(B) * S * H;
  const int nt = (S + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(nt) * B * H;
  if ((rows + 7) / 8 > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  delta_kernel<DV><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      o, dout, delta, S, H, rows);
  dkdv_kernel<DQK, DV><<<static_cast<unsigned>(blocks), kThreads, kSmem,
                         stream>>>(q, k, v, dout, lse, delta, dkp, dvp, S, H,
                                   KH, B * H, scale, scale_log2);
  dq_kernel<DQK, DV><<<static_cast<unsigned>(blocks), kThreads, kSmem,
                       stream>>>(q, k, v, dout, lse, delta, dq, S, H, KH,
                                 B * H, nt, scale, scale_log2);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int G = H / KH;
  err = group_sum(dkp, dk, static_cast<long long>(B) * S * KH * DQK, KH, G,
                  DQK, stream);
  if (err != 0) return err;
  return group_sum(dvp, dv, static_cast<long long>(B) * S * KH * DV, KH, G,
                   DV, stream);
}

}  // namespace

// q [B, S, H, dqk], k [B, S, KH, dqk], v [B, S, KH, dv], o and dout
// [B, S, H, dv], dq [B, S, H, dqk], dk [B, S, KH, dqk], dv [B, S, KH, dv]:
// contiguous bfloat16, 16-byte aligned; lse [B, H, S] (the forward's, base
// 2) and the scratch delta [B, H, S], dkp [B, S, H, dqk], dvp [B, S, H, dv]:
// float32. (dqk, dv) one of (64, 64), (128, 128); KH divides H; the causal
// mask without a window. Anything else returns cudaErrorInvalidValue
// without launching.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     void* dq, void* dk, void* dv,
                                     void* delta, void* dkp, void* dvp,
                                     int B, int S, int H, int KH, int dqk,
                                     int dv_, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
       reinterpret_cast<uintptr_t>(dkp) | reinterpret_cast<uintptr_t>(dvp)) %
      16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_BWD_ARGS                                                        \
  static_cast<const bf16*>(q), static_cast<const bf16*>(k),                \
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),            \
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),      \
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), \
      static_cast<float*>(delta), static_cast<float*>(dkp),                \
      static_cast<float*>(dvp), B, S, H, KH, scale, st
  switch (dqk * 1000 + dv_) {
    case 64064: return launch<64, 64>(FA_BWD_ARGS);
    case 128128: return launch<128, 128>(FA_BWD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_BWD_ARGS
}

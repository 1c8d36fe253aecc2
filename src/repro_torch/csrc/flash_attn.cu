// flash_attn: the float32 route of kernel K5 (online-softmax attention for
// the LM prefill: causal, optionally over a sliding window, or
// bidirectional), on the CUDA cores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn/kernel.py::
// flash_attention (body _body; wrapper ops.py::flash_attention). Plain
// version: repro_torch/kernels/flash_attn.py::flash_attention_plain (the
// materialized softmax of flash_attn/ref.py). bf16 inputs take the
// tensor-core kernel of flash_attn_tc.cu instead; this kernel is the only
// one that computes float32 inputs in IEEE float32 (never TF32).
//
// Computes, for q [B, S, H, DQK], k [B, S, KH, DQK] and v [B, S, KH, DV]
// (KH divides H; DV may differ from DQK, as MLA's un-absorbed prefill has
// it), o [B, S, H, DV] with
//   o[b, i, h] = sum_{i - W < j <= i} softmax_j((q[b, i, h] * scale) .
//                k[b, j, g]) * v[b, j, g],      g = h / (H / KH),
// W the sliding window (none when the caller passes W <= 0); without
// causality (causal = 0, the whisper encoder's attention) the sum runs
// over every key j < S and there is no window. The logits of masked keys
// are set to -2e38 (not -inf), with a running max,
// sum and accumulator in float32, and o = acc / max(l, 1e-30). The caller
// gives the scale (1/sqrt(DQK) by default in the wrapper).
//
// A query shard: q and o hold Sq rows at positions qoff + [0, Sq) against
// all Sk keys (flash_attn_tc.cu's rule), i above being the row's position;
// the unsharded call is Sq = Sk = S, qoff = 0.
//
// What bounds it here: at the prefill's shape (B 4, S 2048, H 32, KH 8,
// hd 128) 2*B*H*S^2*hd = 1.37e11 causal operations, 2.05 ms at the
// float32 CUDA-core peak; its arithmetic is float32 on the CUDA cores.
//
// Design: one block of 256 threads per (query tile of 64 rows, batch*head).
// The scaled query tile stays in shared memory; for each key tile of 64
// positions at or below the tile's last row (tiles past the diagonal are
// fully masked and skipped: they would add exp(-2e38 - m) = 0 with
// alpha = 1; without causality every key tile is read) and from the tile
// that holds the first row's first key in the window (masked keys before a
// row's first real one add exp(0) = 1 each until its alpha =
// exp(-2e38 - m) = 0 wipes them), the K and V rows of KV head g are staged
// in shared memory, read in place from the [B, S, KH, DQK] and
// [B, S, KH, DV] layouts (no repeat to H heads: 4x fewer K/V bytes at
// H/KH = 4). Each thread owns 4 query rows and computes a 4 x 4 block of
// the 64 x 64 logits, then 4 rows x DV/16 columns of the output; a row's
// max and sum are reduced over the 16 lanes that share it with warp
// shuffles. Keys at or past S are masked (causal or not) and read as 0,
// and rows at or past S are not written, so no input is padded. Rows of the
// query tiles nearest the end of the sequence are launched first (they have
// the most key tiles). Shared-memory rows are padded by one float against
// bank conflicts. At (256, 256) the tiles take 213,760 bytes of the 227 KB.
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr float kNegInf = -2.0e38f;

template <int DQK, int DV>
constexpr int smem_floats() {
  return kBQ * (DQK + 1) + kBK * (DQK + 1) + kBK * DV + kBQ * (kBK + 1);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq,
                  int Sk, int qoff, int H, int KH, int window, int causal,
                  float scale) {
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "head dims");
  constexpr int kQS = DQK + 1;  // row strides in shared memory
  constexpr int kKS = DQK + 1;
  constexpr int kPS = kBK + 1;
  constexpr int kCols = DV / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                // [kBQ][kQS]   q * scale
  float* ks = qs + kBQ * kQS;      // [kBK][kKS]
  float* vs = ks + kBK * kKS;      // [kBK][DV]
  float* ps = vs + kBK * DV;       // [kBQ][kPS]   exp(logit - m)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / KH);
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kBQ;  // its position q0 + qoff
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int r0 = ty * 4;  // this thread's first query row in the tile

  const size_t q_step = (size_t)H * DQK;  // elements between positions
  const size_t k_step = (size_t)KH * DQK;
  const size_t v_step = (size_t)KH * DV;
  const size_t o_step = (size_t)H * DV;
  const float* qb = q + ((size_t)b * Sq * H + h) * DQK;
  const float* kb = k + ((size_t)b * Sk * KH + g) * DQK;
  const float* vb = v + ((size_t)b * Sk * KH + g) * DV;
  float* ob = o + ((size_t)b * Sq * H + h) * DV;

  for (int e = tid; e < kBQ * DQK; e += kThreads) {
    const int r = e / DQK, c = e % DQK, s = q0 + r;
    qs[r * kQS + c] = s < Sq ? qb[s * q_step + c] * scale : 0.0f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // the last key the tile's rows see (its last row's position, at most
  // Sk - 1, or Sk - 1 without causality), and the first key tile of its
  // first row's window
  const int p0 = q0 + qoff;
  const int last = causal ? min(p0 + kBQ, Sk) - 1 : Sk - 1;
  const int first = max(0, p0 - window + 1) / kBK * kBK;
  for (int k0 = first; k0 <= last; k0 += kBK) {
    __syncthreads();  // the previous tile's ks/vs/ps are consumed
    for (int e = tid; e < kBK * DQK; e += kThreads) {
      const int r = e / DQK, c = e % DQK, s = k0 + r;
      ks[r * kKS + c] = s < Sk ? kb[s * k_step + c] : 0.0f;
    }
    for (int e = tid; e < kBK * DV; e += kThreads) {
      const int r = e / DV, c = e % DV, s = k0 + r;
      vs[r * DV + c] = s < Sk ? vb[s * v_step + c] : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DQK; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(r0 + i) * kQS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * kKS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = p0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if ((causal && kp > qp) || kp >= Sk || kp <= qp - window)
          sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 16 lanes of a row group hold the row's 64 logits
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(r0 + i) * kPS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(r0 + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[kk * DV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + r0 + i;
    if (s >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      ob[s * o_step + tx + 16 * c] = acc[i][c] / den;
  }
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int qoff, int H, int KH, int window, int causal,
           float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DQK, DV>() * (int)sizeof(float);
  static bool configured = false;  // above 48 KB only after opting in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<DQK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_attn_kernel<DQK, DV><<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Sk,
      qoff, H, KH, window, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Sq, H, dqk], k [B, Sk, KH, dqk], v [B, Sk, KH, dv] and o [B, Sq, H,
// dv], contiguous float32; (dqk, dv) one of (16, 16), (64, 64), (128, 128),
// (256, 256), (96, 64), (192, 128), (32, 16); KH divides H; q's rows at
// positions qoff + [0, Sq) (flash_attn_tc_launch's rule); window the
// sliding window in positions, or <= 0 for none; causal 1 for the causal
// mask, 0 for none (then the window and qoff are ignored). Anything else
// returns cudaErrorInvalidValue without launching.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int Sq, int Sk, int qoff,
                                 int H, int KH, int dqk, int dv, int window,
                                 int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < Sq || qoff < 0 || KH <= 0 || H % KH != 0 ||
      Sq > 65535 * kBQ || (causal != 0 && qoff > Sk - Sq))
    return (int)cudaErrorInvalidValue;
  causal = causal != 0;
  // no window (or one without causality): no key outside it
  if (!causal || window <= 0 || window >= Sk) window = 1 << 30;
  if (!causal) qoff = 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dqk * 1000 + dv) {
    case 16016: return launch<16, 16>(q, k, v, o, B, Sq, Sk, qoff, H, KH, window, causal, scale, st);
    case 64064: return launch<64, 64>(q, k, v, o, B, Sq, Sk, qoff, H, KH, window, causal, scale, st);
    case 128128: return launch<128, 128>(q, k, v, o, B, Sq, Sk, qoff, H, KH, window, causal, scale, st);
    case 256256: return launch<256, 256>(q, k, v, o, B, Sq, Sk, qoff, H, KH, window, causal, scale, st);
    case 96064: return launch<96, 64>(q, k, v, o, B, Sq, Sk, qoff, H, KH, window, causal, scale, st);
    case 192128: return launch<192, 128>(q, k, v, o, B, Sq, Sk, qoff, H, KH, window, causal, scale, st);
    case 32016: return launch<32, 16>(q, k, v, o, B, Sq, Sk, qoff, H, KH, window, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

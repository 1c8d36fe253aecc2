// flash_attn_tc: the bf16 route of kernel K5 (online-softmax attention for
// the LM prefill: causal, optionally over a sliding window, or
// bidirectional) on Hopper tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn/kernel.py::
// flash_attention (body _body; wrapper ops.py::flash_attention) for bf16
// inputs. float32 inputs keep the CUDA-core kernel of flash_attn.cu. Plain
// version: repro_torch/kernels/flash_attn.py::flash_attention_plain.
//
// Computes, for q [B, S, H, DQK], k [B, S, KH, DQK] and v [B, S, KH, DV] in
// bf16 (KH divides H; (DQK, DV) one of (16, 16), (64, 64), (128, 128),
// recurrentgemma's (256, 256), and MLA's un-absorbed prefill dims (96, 64),
// (192, 128) and (32, 16)), o [B, S, H, DV] with
//   o[b, i, h] = sum_{i - W < j <= i} softmax_j(scale * q[b, i, h] .
//                k[b, j, g]) * v[b, j, g],      g = h / (H / KH),
// W the sliding window (the mask of the reference's _sdpa: kpos <= qpos and
// kpos > qpos - W; no window when the caller passes W <= 0), masked logits
// at -2e38, the softmax in float32, and o = bf16_rne(acc / max(l, 1e-30)).
// Without causality (causal = 0: the whisper encoder's self-attention) the
// sum runs over every key j < S and there is no window. The caller gives
// the scale.
//
// What bounds it: at the prefill's shape (B 4, S 2048, H 32, KH 8, hd 128)
// 2*B*H*S^2*hd = 1.37e11 causal operations, 0.139 ms at the bf16
// tensor-core peak; its 168 MB take 0.050 ms. At recurrentgemma-9b's
// (B 4, S 4096, H 16, KH 1, 256/256, W 2048) the window leaves 6,292,480
// pairs a (b, h): 4.12e11 operations, 0.417 ms, against 285 MB in 0.085
// ms. The operations bound it, so both products run on the tensor cores.
//
// Design. One block of 288 threads per (query tile of 128 rows, b*h),
// launched heaviest query tiles first (the index is on gridDim.x, which has
// no 65535 limit). Two consumer warpgroups own 64 query rows each; one
// producer warp issues every load. At DV 256 a block is 160 threads and
// 64 query rows: one consumer warpgroup and the producer warp.
// - Loads: TMA reads the model's [B, S, heads, hd] layout in place through
//   4-D tensor maps {dim, heads, S, B} (no fold, no KV repeat, no padding).
//   Rows at or past S come back as zeros. The query tile is loaded once; K
//   and V tiles of BK keys go through a ring of kStages stages, each with
//   a "K full", a "V full" and an "empty" mbarrier, so the loads of the
//   next tiles overlap the math on this one. A tile of D columns is D / c
//   column blocks side by side, each a TMA box of c columns whose rows are
//   c * 2 bytes with a swizzle of that width: c = 64 (128-byte swizzle)
//   when 64 divides D, else 32 (64-byte), else 16 (32-byte). So dims 64,
//   128 and 192 take 128-byte rows (192: three blocks), 96 three 64-byte
//   blocks, 32 one, and 16 one 32-byte block. Q and K follow DQK, V follows DV; each wgmma
//   descriptor uses its operand's swizzle.
// - S = Q.K^T: wgmma m64nBKk16, bf16 operands from shared memory, both
//   K-major, float32 accumulators, DQK/16 steps. Products of bf16 values
//   are exact in float32; only the order of the sums differs from the
//   plain version.
// - Online softmax in registers on the accumulator fragment: each thread
//   holds 2 rows x BK/4 keys; the row max is reduced over the 4 lanes of a
//   quad with shuffles, the row sum is kept per thread and reduced once at
//   the end. The scale is applied to the float32 logits inside
//   exp2(s * scale*log2(e) - m * scale*log2(e)). Keys past the diagonal
//   (when causal), at or past S, or at or before a row's position minus W
//   are set to -2e38 in the tiles that reach them: TMA fills the keys past
//   S of the last tile with zeros, which would otherwise take softmax mass
//   (at S = 1500, 36 zero keys). Without causality every warpgroup reads
//   every key tile, rows at or past S too (so every warp releases every
//   stage it is given), and only a last tile that reaches past S is
//   masked. Causal: key tiles wholly past a warpgroup's last row are
//   skipped (they would add exp(-2e38 - m) = 0 with alpha = 1), and so
//   are key tiles wholly before its first row's window: the producer
//   starts at the block's first needed tile, and a warpgroup whose window
//   starts a tile later waits for and releases the tiles it skips (the
//   ring's stages and phases count from the block's first tile). While a
//   row has seen masked keys only, its max is -2e38 and they add
//   exp2(-2e38 c) = 0, as the plain softmax weighs them.
// - O += P.V: P never goes to shared memory. The accumulator fragment of S
//   is, element for element, the bf16 A-register fragment of the next
//   product. P is split into hi = bf16(P) and lo = bf16(P - hi) and both
//   are multiplied (two wgmma m64nDVk16 with A in registers, V the
//   MN-major shared-memory B operand, transpose bit set), which keeps
//   about 16 bits of P: a single bf16 P would round each probability by up
//   to 2^-9, close to the bf16 output tolerance on rows with few keys.
// - Overlap inside a warpgroup (DV <= 128): S(j+1) = Q.K(j+1)^T and
//   O += P(j).V(j) are issued together; the softmax of tile j+1 runs on the
//   CUDA cores while the tensor cores take P(j).V(j), and O is rescaled
//   once that is done. The two warpgroups overlap each other besides.
// - Tiles: BK = 64 keys at every head dim. ptxas gives a thread of a
//   288-thread block at most 168 registers; at DV 128 the live
//   accumulators are O (64 floats), S(j+1) (32) and P(j) (32 words), at
//   DQK 192 as at 128 (Q.K^T takes 12 k16 steps in place of 8). At DV 256
//   O alone is 128 floats: that width drops the overlap (S(j), its
//   softmax, then P(j).V(j) as two m64n128 products a k step, so at most
//   O + S or O + P are live), and its block holds one consumer warpgroup,
//   so a thread may hold 255 registers (in a 288-thread block it spilled
//   660 bytes at 168; setmaxnreg did not change what ptxas allotted).
// - Shared memory at (192, 128): Q 48 KB + 3 stages x (K 24 KB + V 16 KB)
//   + the barriers + 1 KB of alignment = 173,136 bytes of the 227 KB; at
//   (256, 256) Q (64 rows) 32 KB + 3 x (32 + 32) KB + the barriers + 1 KB
//   = 230,480 bytes (with 128 query rows, 3 stages would take 263,248).
// - Epilogue: acc / max(l, 1e-30), round to nearest even, 4-byte stores;
//   no row at or past S is written.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;             // a block's shared memory
constexpr int kBK = 64;  // keys per tile (the width of wgmma_ss_n64)
constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;

// The column blocks of a tile with D columns (see the design notes).
template <int D>
struct Cols {
  static_assert(D % 16 == 0, "head dim");
  static constexpr int kCols = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kRowBytes = kCols * 2;        // 128, 64 or 32
  static constexpr int kBlocks = D / kCols;
  static constexpr int kAtomBytes = 8 * kRowBytes;   // 8-row swizzle atom
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint32_t kLayout =
      kRowBytes == 128 ? 1u : kRowBytes == 64 ? 2u : 3u;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
};

template <int DQK, int DV>
struct Tiles {
  using QK = Cols<DQK>;
  using V = Cols<DV>;
  // consumer warpgroups of 64 query rows: two, or one at DV 256, whose O
  // (128 floats a thread) needs more than the 168 registers ptxas leaves a
  // thread of a three-warpgroup block
  static constexpr int kWarpgroups = DV > 128 ? 1 : 2;
  static constexpr int kBQ = 64 * kWarpgroups;         // query rows a block
  static constexpr int kConsumerThreads = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumerThreads + 32;  // + the producer
  static constexpr int kQBytes = kBQ * DQK * 2;
  static constexpr int kKBytes = kBK * DQK * 2;      // one K tile
  static constexpr int kVBytes = kBK * DV * 2;       // one V tile
  // every tile starts on a 1024-byte boundary (the 128-byte swizzle's)
  static_assert(kQBytes % 1024 == 0 && kKBytes % 1024 == 0 &&
                kVBytes % 1024 == 0, "tile alignment");
  static constexpr int kStages = 3;                  // K/V ring depth
  // the tiles, a "Q full" barrier and three a stage, + 1024 so the tiles
  // can start on a 1024-byte boundary
  static constexpr int kSmemBytes = kQBytes + kStages * (kKBytes + kVBytes) +
                                    8 * (1 + 3 * kStages) + 1024;
  static_assert(kSmemBytes <= kMaxSmem, "shared memory");
  // S(j+1) and P(j).V(j) overlap where O leaves the registers for it
  static constexpr bool kOverlap = DV <= 128;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// phase that never completes (a load that cannot arrive) traps after ~2^30
// polls, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (polls == (1u << 30)) __trap();
  }
}

// One TMA load of a box at (c0 column, c1 head, c2 position, c3 batch) into
// shared memory; completion counts bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Keep the compiler from moving reads or writes of a register across an
// asynchronous wgmma that uses it.
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) keep(r[i]);
}

// d[32] (+)= A·B: A [64 x 16] and B [16 x 64] both K-major in shared
// memory (descriptors da, db); d is overwritten when accumulate is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[8] += A·B: A [64 x 16] bf16 in registers (a), B [16 x 16] MN-major
// in shared memory (descriptor db, transpose bit set).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A·B: A [64 x 16] bf16 in registers (a), B [16 x 64] MN-major
// in shared memory (descriptor db, transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A·B: A [64 x 16] bf16 in registers (a), B [16 x 128] MN-major
// in shared memory (descriptor db, transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 16 || N == 64 || N == 128, "head dim");
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The running max (raw logits) and this thread's share of the running sum
// of rows r and r + 8 of a warpgroup.
struct Rows {
  float m0, m1, l0, l1;
};

template <int N, int M>
__device__ __forceinline__ void keep(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int x = 0; x < M; ++x) keep(r[i][x]);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Issue S = Q.K^T for one key tile (DQK / 16 steps of 16 columns): qa is
// the warpgroup's 64 query rows of the block's BQ, ka the tile's first
// column block.
template <int DQK, int BQ>
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], uint32_t qa,
                                         uint32_t ka) {
  using C = Cols<DQK>;
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const int cb = kk * 16 / C::kCols;
    const uint32_t off = (kk * 16 % C::kCols) * 2;
    const uint64_t da = desc(qa + cb * BQ * C::kRowBytes + off, 16,
                             C::kAtomBytes, C::kLayout);
    const uint64_t db = desc(ka + cb * kBK * C::kRowBytes + off, 16,
                             C::kAtomBytes, C::kLayout);
    wgmma_ss_n64(s, da, db, kk > 0);
  }
}

// Issue O += P_hi.V + P_lo.V for one key tile (kBK / 16 steps of 16 keys);
// va is the V tile's first column block. DV 256 runs as two m64n128
// products a k step, each over two of the tile's four 64-column blocks and
// its half of o (columns 128 x + [0, 128) are o[64 x, 64 x + 64)).
template <int DV>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2],
                                         const uint32_t (&phi)[kBK / 16][4],
                                         const uint32_t (&plo)[kBK / 16][4],
                                         uint32_t va) {
  using C = Cols<DV>;
  constexpr int N = DV > 128 ? 128 : DV;  // columns a product
  static_assert(DV % N == 0 && N % C::kCols == 0, "head dim");
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < DV / N; ++x) {
      float(&ox)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&o[x * N / 2]);
      const uint64_t db =
          desc(va + x * (N / C::kCols) * kBK * C::kRowBytes +
                   kk * 16 * C::kRowBytes,
               kBK * C::kRowBytes, C::kAtomBytes, C::kLayout);
      wgmma_rs<N>(ox, phi[kk], db);
      wgmma_rs<N>(ox, plo[kk], db);
    }
}

// The online softmax of one key tile on the accumulator fragment, in place:
// mask (when the tile reaches past a row's keys or before its window), the
// new row max over the quad, p = exp2(s * c - m * c) with c = scale *
// log2(e), and this thread's share of the row sum. Returns the factors
// alpha that rescale the earlier sums and outputs.
// Rows r0 and r1 of the thread see keys in (lo, last]: last the row
// itself (causal) or S - 1, at most S - 1; lo the row minus the window.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], int k0,
                                             bool masked, int last0, int last1,
                                             int lo0, int lo1, int col_of,
                                             float scale_log2, Rows& st,
                                             float& alpha0, float& alpha1) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * i + col_of + e;
        if (col > last0 || col <= lo0) s[4 * i + e] = kNegInf;
        if (col > last1 || col <= lo1) s[4 * i + 2 + e] = kNegInf;
      }
  }
  float mx0 = st.m0, mx1 = st.m1;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  alpha0 = exp2f((st.m0 - mx0) * scale_log2);
  alpha1 = exp2f((st.m1 - mx1) * scale_log2);
  st.m0 = mx0;
  st.m1 = mx1;
  // A row with no key yet (every logit so far -2e38, as before a row's
  // window starts) subtracts 0, so its masked keys get exp2(-2e38 c) = 0:
  // fmaf(-2e38, c, -round(-2e38 c)) would leave the product's rounding
  // error, up to ~4e30, and exp2 of that is inf.
  const float mb0 = mx0 == kNegInf ? 0.0f : mx0 * scale_log2;
  const float mb1 = mx1 == kNegInf ? 0.0f : mx1 * scale_log2;
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    s[4 * i] = exp2f(fmaf(s[4 * i], scale_log2, -mb0));
    s[4 * i + 1] = exp2f(fmaf(s[4 * i + 1], scale_log2, -mb0));
    s[4 * i + 2] = exp2f(fmaf(s[4 * i + 2], scale_log2, -mb1));
    s[4 * i + 3] = exp2f(fmaf(s[4 * i + 3], scale_log2, -mb1));
    rs0 += s[4 * i] + s[4 * i + 1];
    rs1 += s[4 * i + 2] + s[4 * i + 3];
  }
  st.l0 = st.l0 * alpha0 + rs0;  // reduced over the quad at the end
  st.l1 = st.l1 * alpha1 + rs1;
}

// P as bf16 hi + lo A fragments: k step kk of the PV product takes
// s[8 kk, 8 kk + 8), which is element for element its A-register layout.
template <int BK>
__device__ __forceinline__ void split_p(const float (&s)[BK / 2],
                                        uint32_t (&phi)[BK / 16][4],
                                        uint32_t (&plo)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float p0 = s[8 * kk + 2 * x], p1 = s[8 * kk + 2 * x + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      phi[kk][x] = *reinterpret_cast<const uint32_t*>(&hi);
      plo[kk][x] = pack_bf16(p0 - hf.x, p1 - hf.y);
    }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(Tiles<DQK, DV>::kThreads, 1)
flash_attn_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     __nv_bfloat16* __restrict__ o, int S, int H, int KH,
                     int BH, int nq, int window, int causal,
                     float scale_log2) {
  using T = Tiles<DQK, DV>;
  using QK = typename T::QK;
  using VC = typename T::V;
  constexpr int BK = kBK, kBQ = T::kBQ;
  constexpr int kConsumerThreads = T::kConsumerThreads;
  constexpr int kS = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;                             // [col block][kBQ rows]
  const uint32_t ks = qs + T::kQBytes;                  // [stage][col block][BK]
  const uint32_t vs = ks + kS * T::kKBytes;
  const uint32_t bars = vs + kS * T::kVBytes;           // q, k full, v full, empty
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + kS + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kS + st); };

  const int tile = nq - 1 - static_cast<int>(blockIdx.x) / BH;  // heaviest first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / KH);
  const int q0 = tile * kBQ;
  // key tiles of the block: from the first row's window to the last row
  // (to the last key without causality)
  const int jb = max(0, q0 - window + 1) / BK;
  const int nk = ((causal ? min(q0 + kBQ, S) : S) - 1) / BK + 1;
  // tile j sits in stage (j - jb) % kS, in that stage's phase (j - jb) / kS
  auto stage = [&](int j) { return (j - jb) % kS; };
  auto phase = [&](int j) { return static_cast<uint32_t>((j - jb) / kS) & 1u; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kS; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kConsumerThreads / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerThreads / 32) {
    // producer: one thread issues every TMA load of the block
    if (lane == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int cb = 0; cb < QK::kBlocks; ++cb)
        tma_load(qs + cb * kBQ * QK::kRowBytes, &map_q, q_full,
                 cb * QK::kCols, h, q0, b);
      for (int j = jb; j < nk; ++j) {
        const int st = stage(j);
        if (j - jb >= kS) mbar_wait(empty(st), phase(j) ^ 1u);
        const uint32_t kt = ks + st * T::kKBytes, vt = vs + st * T::kVBytes;
        mbar_expect_tx(k_full(st), T::kKBytes);
        for (int cb = 0; cb < QK::kBlocks; ++cb)
          tma_load(kt + cb * BK * QK::kRowBytes, &map_k, k_full(st),
                   cb * QK::kCols, g, j * BK, b);
        mbar_expect_tx(v_full(st), T::kVBytes);
        for (int cb = 0; cb < VC::kBlocks; ++cb)
          tma_load(vt + cb * BK * VC::kRowBytes, &map_v, v_full(st),
                   cb * VC::kCols, g, j * BK, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64); this
  // thread holds rows r and r + 8 of them
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + lane / 4;
  const int row0 = q0 + wg * 64 + r, row1 = row0 + 8;
  const int wg_first = q0 + wg * 64;
  const int nkw =  // <= nk; nk itself without causality
      (causal ? min(wg_first + 63, S - 1) : S - 1) / BK + 1;
  // the first tile that holds a key of the warpgroup's first row's window
  // (a causal warpgroup wholly at or past S takes its last tile alone)
  const int jw = min(max(0, wg_first - window + 1) / BK, nkw - 1);  // >= jb
  const int col_of = 2 * (lane % 4);  // this thread's first column in an n8
  // the keys rows row0 and row1 see: (lo, last]
  const int last0 = causal ? min(row0, S - 1) : S - 1;
  const int last1 = causal ? min(row1, S - 1) : S - 1;
  const int lo0 = row0 - window, lo1 = row1 - window;

  const uint32_t qa = qs + wg * 64 * QK::kRowBytes;  // this warpgroup's rows
  float oacc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.0f;
  Rows st_rows{kNegInf, kNegInf, 0.0f, 0.0f};
  float sacc[BK / 2];
  uint32_t phi[BK / 16][4], plo[BK / 16][4];
  float alpha0, alpha1;
  // a tile reaches past the first row's diagonal (when causal) or S, or
  // holds a key at or before the last row's position minus the window
  auto masked = [&](int k0) {
    return (causal && k0 + BK - 1 > wg_first) || k0 + BK > S ||
           k0 <= wg_first + 63 - window;
  };
  auto release = [&](int st) {  // this warp is done with stage st
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };
  auto rescale = [&]() {
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      oacc[4 * c] *= alpha0;
      oacc[4 * c + 1] *= alpha0;
      oacc[4 * c + 2] *= alpha1;
      oacc[4 * c + 3] *= alpha1;
    }
  };

  // tiles before this warpgroup's window: loaded for the other one; wait
  // for them (so no stage is released before it is filled) and release
  for (int j = jb; j < jw; ++j) {
    mbar_wait(k_full(stage(j)), phase(j));
    mbar_wait(v_full(stage(j)), phase(j));
    release(stage(j));
  }
  mbar_wait(q_full, 0);

  if constexpr (T::kOverlap) {
    // tile jw: S, its softmax and P
    mbar_wait(k_full(stage(jw)), phase(jw));
    wgmma_fence();
    issue_qk<DQK, T::kBQ>(sacc, qa, ks + stage(jw) * T::kKBytes);
    wgmma_commit();
    wgmma_wait<0>();
    keep(sacc);
    softmax_tile<BK>(sacc, jw * BK, masked(jw * BK), last0, last1, lo0,
                     lo1, col_of, scale_log2, st_rows, alpha0, alpha1);
    split_p<BK>(sacc, phi, plo);

    // tile j < last: issue S(j + 1) = Q.K(j + 1)^T, then O += P(j).V(j);
    // the softmax of tile j + 1 runs while the tensor cores take P(j).V(j).
    // (No wgmma sits in a branch: ptxas serializes those.)
    for (int j = jw; j + 1 < nkw; ++j) {
      const int st = stage(j), sn = stage(j + 1);
      keep(oacc);
      keep(phi);
      keep(plo);
      mbar_wait(k_full(sn), phase(j + 1));
      mbar_wait(v_full(st), phase(j));
      wgmma_fence();
      issue_qk<DQK, T::kBQ>(sacc, qa, ks + sn * T::kKBytes);
      wgmma_commit();
      issue_pv<DV>(oacc, phi, plo, vs + st * T::kVBytes);
      wgmma_commit();
      wgmma_wait<1>();  // S(j + 1) is in; P(j).V(j) may still run
      keep(sacc);
      softmax_tile<BK>(sacc, (j + 1) * BK, masked((j + 1) * BK), last0,
                       last1, lo0, lo1, col_of, scale_log2, st_rows, alpha0,
                       alpha1);
      wgmma_wait<0>();
      keep(oacc);
      keep(phi);
      keep(plo);
      release(st);
      rescale();
      split_p<BK>(sacc, phi, plo);
    }
    {  // the last tile: O += P.V
      const int st = stage(nkw - 1);
      keep(oacc);
      keep(phi);
      keep(plo);
      mbar_wait(v_full(st), phase(nkw - 1));
      wgmma_fence();
      issue_pv<DV>(oacc, phi, plo, vs + st * T::kVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      keep(oacc);
      keep(phi);
      keep(plo);
      release(st);
    }
  } else {
    // one tile at a time: S(j), its softmax (O rescaled), then P(j).V(j)
    for (int j = jw; j < nkw; ++j) {
      const int st = stage(j);
      keep(oacc);
      mbar_wait(k_full(st), phase(j));
      wgmma_fence();
      issue_qk<DQK, T::kBQ>(sacc, qa, ks + st * T::kKBytes);
      wgmma_commit();
      wgmma_wait<0>();
      keep(sacc);
      softmax_tile<BK>(sacc, j * BK, masked(j * BK), last0, last1, lo0, lo1,
                       col_of, scale_log2, st_rows, alpha0, alpha1);
      rescale();
      split_p<BK>(sacc, phi, plo);
      keep(oacc);
      keep(phi);
      keep(plo);
      mbar_wait(v_full(st), phase(j));
      wgmma_fence();
      issue_pv<DV>(oacc, phi, plo, vs + st * T::kVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      keep(oacc);
      keep(phi);
      keep(plo);
      release(st);
    }
  }
  float l0 = st_rows.l0, l1 = st_rows.l1;

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const size_t step = static_cast<size_t>(H) * DV;  // elements per position
  __nv_bfloat16* ob = o + (static_cast<size_t>(b) * S * H + h) * DV + col_of;
  if (row0 < S) {
    uint32_t* out = reinterpret_cast<uint32_t*>(ob + row0 * step);
#pragma unroll
    for (int c = 0; c < DV / 8; ++c)
      out[4 * c] = pack_bf16(oacc[4 * c] / den0, oacc[4 * c + 1] / den0);
  }
  if (row1 < S) {
    uint32_t* out = reinterpret_cast<uint32_t*>(ob + row1 * step);
#pragma unroll
    for (int c = 0; c < DV / 8; ++c)
      out[4 * c] = pack_bf16(oacc[4 * c + 2] / den1, oacc[4 * c + 3] / den1);
  }
}

// cuTensorMapEncodeTiled, fetched from the driver the runtime has loaded
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map {D, heads, S, B} over a contiguous bf16 [B, S, heads, D]
// tensor, with boxes of {Cols<D>::kCols, 1, rows, 1} in Cols<D>'s swizzle.
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int B, int S, int heads,
            int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Cols<D>::kCols, 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            Cols<D>::kSwizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int window, int causal, float scale,
           cudaStream_t stream) {
  using T = Tiles<DQK, DV>;
  CUtensorMap mq, mk, mv;
  if (!encode<DQK>(&mq, q, B, S, H, T::kBQ) ||
      !encode<DQK>(&mk, k, B, S, KH, kBK) ||
      !encode<DV>(&mv, v, B, S, KH, kBK))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;  // above 48 KB only after opting in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_tc_kernel<DQK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int nq = (S + T::kBQ - 1) / T::kBQ;
  const long long blocks = (long long)nq * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attn_tc_kernel<DQK, DV><<<(unsigned)blocks, T::kThreads,
                                  T::kSmemBytes, stream>>>(mq, mk, mv, (__nv_bfloat16*)o, S,
                                            H, KH, B * H, nq, window,
                                            causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, S, H, dqk], k [B, S, KH, dqk], v [B, S, KH, dv] and o [B, S, H, dv]:
// contiguous bfloat16, 16-byte aligned; (dqk, dv) one of (16, 16),
// (64, 64), (128, 128), (256, 256), (96, 64), (192, 128), (32, 16); KH
// divides H; window the sliding window in positions, or <= 0 for none;
// causal 1 for the causal mask, 0 for none (then the window is ignored).
// Anything else returns cudaErrorInvalidValue without launching.
extern "C" int flash_attn_tc_launch(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int KH, int dqk, int dv,
                                    int window, int causal, float scale,
                                    void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorInvalidValue;
  // no window, one that covers the sequence, or no causality: no key is
  // outside it, and no tile is masked for it
  causal = causal != 0;
  if (!causal || window <= 0 || window >= S) window = 1 << 30;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dqk * 1000 + dv) {
    case 16016: return launch<16, 16>(q, k, v, o, B, S, H, KH, window, causal, scale, st);
    case 64064: return launch<64, 64>(q, k, v, o, B, S, H, KH, window, causal, scale, st);
    case 128128: return launch<128, 128>(q, k, v, o, B, S, H, KH, window, causal, scale, st);
    case 256256: return launch<256, 256>(q, k, v, o, B, S, H, KH, window, causal, scale, st);
    case 96064: return launch<96, 64>(q, k, v, o, B, S, H, KH, window, causal, scale, st);
    case 192128: return launch<192, 128>(q, k, v, o, B, S, H, KH, window, causal, scale, st);
    case 32016: return launch<32, 16>(q, k, v, o, B, S, H, KH, window, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory one block of the kernel takes at head dims
// (dqk, dv), in bytes (0 for a pair it does not take).
extern "C" int flash_attn_tc_smem_bytes(int dqk, int dv) {
  switch (dqk * 1000 + dv) {
    case 16016: return Tiles<16, 16>::kSmemBytes;
    case 64064: return Tiles<64, 64>::kSmemBytes;
    case 128128: return Tiles<128, 128>::kSmemBytes;
    case 256256: return Tiles<256, 256>::kSmemBytes;
    case 96064: return Tiles<96, 64>::kSmemBytes;
    case 192128: return Tiles<192, 128>::kSmemBytes;
    case 32016: return Tiles<32, 16>::kSmemBytes;
    default: return 0;
  }
}

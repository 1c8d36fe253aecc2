// flash_attn_bwd: the backward of kernel K5's bf16 route (causal attention,
// optionally over a sliding window, or bidirectional, for training), on
// Hopper: wgmma on tiles that TMA loads into an mbarrier ring, a producer
// warp and consumer warpgroups.
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
// forward's output o [B, S, H, DV], its low part o_lo (o + o_lo is the
// forward's float32 output to ~16 bits) and its row statistic lse [B, H, S]
// (base 2: lse = log2 sum_j exp2(s_ij c), s = q.k, c = scale * log2(e)),
// and the output's gradient do [B, S, H, DV], all bf16 but lse:
//   P_ij  = exp2(s_ij c - lse_i)          (0 where the mask drops (i, j))
//   D_i   = sum_d do_id (o_id + o_lo_id)  (float32: sum_j P_ij dP_ij)
//   dS_ij = P_ij (do_i . v_j - D_i)
//   dq_i  = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,
//   dv_j  = sum_i P_ij do_i,
// with g = h / (H / KH): dk and dv of KV head g sum the gradients of its
// G = H / KH query heads. The mask is the forward's: causal (j <= i), and
// with a window W also j > i - W; without causality (causal = 0, whisper's
// encoder) every key j < S. A masked P is set to 0 by a select, never by
// arithmetic on -2e38. Products take bf16 operands (P and dS rounded to
// bf16 once, from float32) and float32 accumulators; outputs are bf16
// (round to nearest even).
//
// What bounds it: five products of 2 hd operations a (query, key) pair: at
// starcoder2-3b's training shape (B 2, S 2048, H 24, KH 2, hd 128)
// 2,098,176 causal pairs a (b, h) x 48 x 10 x 128 = 1.29e11 operations,
// 0.130 ms at the bf16 tensor-core peak, against 63 MB in 0.019 ms. The
// operations bound it, so every product runs on the tensor cores.
//
// Design: two launches, each a block of consumer warpgroups (64 rows each)
// and one producer warp whose first lane issues every TMA load.
// 1. dQ (bwd_dq_kernel): one block per (tile of 128 queries, or 64 at
//    DV 256, b, h), the last tiles (the most keys) first. It first takes D
//    of its rows from o + o_lo and do (each lane of a quad a quarter of
//    the columns, then two xor shuffles: every lane holds the same sum;
//    from the bf16 o alone D would be off by ~2^-9 of |dO||O|, which where
//    dP - D cancels swamped whisper's encoder's dQ and dK) and
//    writes it to `delta` for launch 2; it also sets launch 2's tickets to
//    0. The Q and dO tiles are loaded once; K and V tiles of 64 keys stream
//    through a ring of 3 stages (2 at DV 256) over the block's keys: from
//    the tile of its first row's window (tile 0 without one) to the tile of
//    its last row (causal) or of key S - 1. A warpgroup whose window starts
//    a tile later waits for and releases the tiles it skips (stages and
//    phases count from the block's first tile). A tile: S = Q.K^T and dP =
//    dO.V^T (wgmma, both operands K-major in shared memory), P and dS in
//    registers on the accumulator fragment, then dQ += dS.K with dS packed
//    to bf16 as the register A operand and the K tile read MN-major
//    (transpose bit), as the forward reads V. Each query head owns its
//    rows: no partials.
// 2. dK/dV (bwd_dkdv_kernel): one block per (tile of 64 keys, b, KV head
//    g, split), the key tiles nearest the start (the most queries) first.
//    The block's K and V rows are loaded once; chunks of 64 queries (q, do
//    and their lse and D) stream through a ring of 4 stages (3 at Dqk 192,
//    2 at 256/256, as many as fit a block's shared memory), for each of
//    the split's G / splits query heads in turn: causal, from the tile's
//    first key to the last query its last key's window reaches (S - 1
//    without a window); without causality every chunk. The producer warp's
//    lanes copy the chunk's lse and D into the
//    stage and arrive on its barrier beside the TMA bytes (33 arrivals).
//    Keys are the wgmma rows, and the two consumer warpgroups split the
//    work on the same 64 keys: the P warpgroup takes S^T = K.Q^T, P^T and
//    dV += P^T.dO; the dS warpgroup takes dP^T = V.dO^T, dS^T = P^T (dP^T -
//    D) and dK += dS^T.Q. P^T goes from one to the other through shared
//    memory, float32 in the accumulator layout (thread t's element x at x
//    128 + t: no bank conflicts), in two buffers under named barriers
//    ("written", "read"), so the P warpgroup runs up to a chunk ahead. S^T
//    and dP^T use K and V as the K-major A operand; dV and dK take P^T and
//    dS^T packed to bf16 as the register A operand and read dO and Q
//    MN-major (transpose bit).
// Both orders put the most work first under every mask: a window leaves
// the early query tiles fewer keys and the late key tiles fewer queries,
// and without causality every tile has the same work.
// The five products run once in launch 2 (S^T, dP^T, dV, dK) and three in
// launch 1 (S, dP, dQ): seven, against the five that bound it, so the
// floor is 1.4x the bound (0.182 ms at starcoder2's shape). One kernel that
// also produced dQ would need a sum over key tiles across blocks: float
// atomics (whose order changes run to run) or per-key-tile dQ partials
// (~0.8 GB at that shape). Two launches keep every sum in a fixed order.
//
// The group sum. A block sums G / splits query heads of its KV head in
// registers; splits is the smallest divisor of G, at most 8, that gives at
// least 132 blocks (a wave: a block takes an SM), from the shape alone (see
// flash_attn.py::bwd_plan). With splits = 1 the block writes bf16 dk and dv
// itself. Otherwise every block writes float32 partials [splits, B, S, KH,
// D] of its keys, fences and takes a ticket (an atomicAdd on an int of its
// (key tile, b, g)); the block that draws the last ticket reads back the
// splits' partials (its own too, bitwise what it wrote), adds them in split
// order 0, 1, ..., splits - 1 into its accumulator and writes bf16. The
// ticket picks only which block adds, never the order of the adds, so the
// result is the same run to run. At starcoder2's shape splits = 2 (32 key
// tiles x B 2 x KH 2 x 2 = 256 blocks; 6 heads a block): 16.8 MB of
// partials written and read back (float32 partials of every query head
// would take 201 MB, written and read back). tools/kernel_timing.py
// --bwd-splits times every split count at that shape and at [2, 300, 16/1,
// 128].
//
// Registers. A thread of a 288-thread block gets at most 168 from ptxas
// (setmaxnreg with a producer warpgroup of 384 threads did not change what
// ptxas allotted: the dK/dV kernel still compiled at 168, with spills).
// Launch 1 at hd 128 holds dQ (64 floats a thread), S and dP (32 each) and
// dS (16 words). In launch 2 each warpgroup holds one accumulator, dV or dK
// (64 floats at hd 128), beside S^T or dP^T (32) and its packed operand
// (16). Neither spills at 128 (chip_smoke.py prints ptxas's registers,
// spills and shared memory). One warpgroup holding both dK and dV (64 keys
// a 160-thread block) ran at 255 registers with spills, and slower.
//
// Head dims. The same design is built at (DQK, DV) = (16, 16), (64, 64),
// (128, 128), (256, 256) and MLA's (96, 64), (192, 128) and (32, 16) (the
// smoke dims' 24 q.k columns zero-padded to 32 by the caller). dQ and dK
// are [.., DQK] and their products span DQK columns; dV, dO and O are [..,
// DV]. A product over N columns read MN-major (dS.K, dS^T.Q, P^T.dO) is
// one wgmma of N columns up to 128 (n16, n32, n64, n96, n128), two past it
// (192: n128 + n64; 256: two n128). At 16 a Q.K^T is one k16 step in a
// 32-byte swizzle. At DQK 192 the dQ accumulator and the dS warpgroup's dK
// are 96 floats a thread: ptxas spills there (dQ ~0.3 KB, its wgmma
// serialized; dK/dV ~0.8 KB; chip_smoke.py prints the counts). At 256/256
// the dQ block holds one consumer warpgroup of 64 queries (160 threads, up
// to 255 registers, as the forward at DV 256) and a 2-stage ring (two
// warpgroups fit only a 1-stage ring: nothing prefetched); the dK/dV block
// keeps both warpgroups with a 2-stage ring (231,472 bytes of the 232,448)
// and its 128-float accumulators spill at 168 registers. Splitting dK and
// dQ into column halves would remove the spills.
//
// Rows at or past S come back from TMA as zeros. Their P is set to 0 (a
// query at or past S in launch 2; a key at or past S in launch 1, which
// without causality every row would otherwise weigh exp2(0 - lse)), and
// nothing is written for them.
#include "flash_attn_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // a warpgroup's rows, a ring stage's rows
constexpr int kPBytes = 128 * 32 * 4;  // a warpgroup's P fragment

// The dK/dV block's shared memory with `stages` ring stages: K and V rows
// (kb + vb bytes), the q/do ring, each stage's lse and D (64 floats
// each), P's two buffers, a "K/V full" barrier, two a stage and the
// last-ticket flag, + 1024 so the tiles can start on a 1024-byte boundary.
constexpr int bwd_kv_smem(int kb, int vb, int stages) {
  return kb + vb + stages * (kb + vb) + stages * 2 * kRows * 4 + 2 * kPBytes +
         8 * (1 + 2 * stages) + 8 + 1024;
}

// The dQ block's shared memory with `wgs` consumer warpgroups and `stages`
// ring stages: the Q and dO tiles, the K/V ring, a "Q full" barrier and
// three a stage, + 1024 so the tiles can start on a 1024-byte boundary.
constexpr int bwd_q_smem(int kb, int vb, int wgs, int stages) {
  return wgs * (kb + vb) + stages * (kb + vb) + 8 * (1 + 3 * stages) + 1024;
}

template <int DQK, int DV>
struct Bwd {
  using QK = Cols<DQK>;
  using VC = Cols<DV>;
  static constexpr int kKBytes = kRows * DQK * 2;  // 64 rows of q or k
  static constexpr int kVBytes = kRows * DV * 2;   // 64 rows of do or v
  // launch 1 (dQ): two consumer warpgroups of 64 queries and the producer;
  // one at DV 256 (its dQ, S, dP and dS take ~210 registers a thread, more
  // than the 168 of a 288-thread block, and two warpgroups' tiles leave
  // room for a 1-stage ring only: 263,224 bytes at 2 stages)
  static constexpr int kQWarpgroups = DV > 128 ? 1 : 2;
  static constexpr int kBQ = kRows * kQWarpgroups;
  static constexpr int kQThreads = 128 * kQWarpgroups + 32;
  // a ring of 3 stages, 2 where 3 do not fit (256/256: 197,688 bytes)
  static constexpr int kQStages =
      bwd_q_smem(kKBytes, kVBytes, kQWarpgroups, 3) <= kMaxSmem ? 3 : 2;
  static constexpr int kQSmem =
      bwd_q_smem(kKBytes, kVBytes, kQWarpgroups, kQStages);
  // launch 2 (dK/dV): 64 keys a block, the P warpgroup (dV) and the dS
  // warpgroup (dK), and the producer; a ring of as many stages as fit, at
  // most 4 (at 192/128 four take 240,720 bytes, three 199,232; at 256/256
  // three take 297,536, two 231,472)
  static constexpr int kKVThreads = 2 * 128 + 32;
  static constexpr int kKVStages =
      bwd_kv_smem(kKBytes, kVBytes, 4) <= kMaxSmem   ? 4
      : bwd_kv_smem(kKBytes, kVBytes, 3) <= kMaxSmem ? 3
                                                     : 2;
  static constexpr int kKVSmem = bwd_kv_smem(kKBytes, kVBytes, kKVStages);
  static_assert(kKBytes % 1024 == 0 && kVBytes % 1024 == 0,
                "tile alignment");
  static_assert(kQSmem <= kMaxSmem && kKVSmem <= kMaxSmem, "shared memory");
};

// A named barrier over the consumer warps (the producer warp has left).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// acc += (a[i] + l[i]) d[i] over the N bf16 values at a, l and d, in
// order (a + l in float32: the forward's output from its two parts).
template <int N>
__device__ __forceinline__ void dot_pairs(float& acc, const void* a,
                                          const void* l, const void* d) {
  const __nv_bfloat162* ap = static_cast<const __nv_bfloat162*>(a);
  const __nv_bfloat162* lp = static_cast<const __nv_bfloat162*>(l);
  const __nv_bfloat162* dp = static_cast<const __nv_bfloat162*>(d);
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    const float2 af = __bfloat1622float2(ap[x]);
    const float2 lf = __bfloat1622float2(lp[x]);
    const float2 df = __bfloat1622float2(dp[x]);
    acc = fmaf(af.x + lf.x, df.x, acc);
    acc = fmaf(af.y + lf.y, df.y, acc);
  }
}

// D of row `row` of head h (0 at or past S) from o + o_lo: lane `quarter`
// of a quad sums its quarter of the columns in order (16-byte loads; at
// DV 16 a quarter is one 8-byte load), then two xor shuffles give every
// lane of the quad the same sum.
template <int DV>
__device__ __forceinline__ float row_delta(const bf16* __restrict__ o,
                                           const bf16* __restrict__ o_lo,
                                           const bf16* __restrict__ dout,
                                           int b, int row, int h, int S,
                                           int H, int quarter) {
  constexpr int kQuarter = DV / 4;
  static_assert(kQuarter % 8 == 0 || kQuarter == 4, "head dim");
  float acc = 0.0f;
  if (row < S) {
    const size_t off = ((static_cast<size_t>(b) * S + row) * H + h) * DV +
                       quarter * kQuarter;
    if constexpr (kQuarter == 4) {
      const uint2 a = *reinterpret_cast<const uint2*>(o + off);
      const uint2 l = *reinterpret_cast<const uint2*>(o_lo + off);
      const uint2 d = *reinterpret_cast<const uint2*>(dout + off);
      dot_pairs<4>(acc, &a, &l, &d);
    } else {
#pragma unroll
      for (int c = 0; c < kQuarter; c += 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(o + off + c);
        const uint4 l = *reinterpret_cast<const uint4*>(o_lo + off + c);
        const uint4 d = *reinterpret_cast<const uint4*>(dout + off + c);
        dot_pairs<8>(acc, &a, &l, &d);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// The accumulator fragment c[32] (64 rows x 64 columns) as the bf16 A
// operand of a product over its 64 columns: step kk takes c[8 kk, 8 kk + 8).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(c[8 * kk + 2 * x], c[8 * kk + 2 * x + 1]);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(Bwd<DQK, DV>::kQThreads, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const bf16* __restrict__ o, const bf16* __restrict__ o_lo,
              const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              bf16* __restrict__ dq, int* __restrict__ tickets,
              int n_tickets, int S, int H, int KH, int BH, int nq,
              int window, int causal, float scale, float scale_log2) {
  using T = Bwd<DQK, DV>;
  using QK = typename T::QK;
  using VC = typename T::VC;
  constexpr int kS = T::kQStages, kBQ = T::kBQ;
  constexpr int kConsumers = 128 * T::kQWarpgroups;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;                             // [col block][kBQ]
  const uint32_t dos = qs + T::kQWarpgroups * T::kKBytes;
  const uint32_t ks = dos + T::kQWarpgroups * T::kVBytes;  // [stage][cb][64]
  const uint32_t vs = ks + kS * T::kKBytes;
  const uint32_t bars = vs + kS * T::kVBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + kS + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kS + st); };

  const int tile = nq - 1 - static_cast<int>(blockIdx.x) / BH;  // heaviest first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H, g = h / (H / KH);
  const int q0 = tile * kBQ;
  // key tiles of the block: from the first row's window (tile 0 without
  // one) to the last row (to key S - 1 without causality)
  const int jb = max(0, q0 - window + 1) / kRows;
  const int nk = ((causal ? min(q0 + kBQ, S) : S) - 1) / kRows + 1;
  // tile j sits in stage (j - jb) % kS, in that stage's phase (j - jb) / kS
  auto stage = [&](int j) { return (j - jb) % kS; };
  auto phase = [&](int j) {
    return static_cast<uint32_t>((j - jb) / kS) & 1u;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kS; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kConsumers / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // launch 2's tickets start at 0
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_tickets; i += static_cast<long long>(gridDim.x) * blockDim.x)
    tickets[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {
    if (lane == 0) {
      mbar_expect_tx(q_full, T::kQWarpgroups * (T::kKBytes + T::kVBytes));
      for (int cb = 0; cb < QK::kBlocks; ++cb)
        tma_load(qs + cb * kBQ * QK::kRowBytes, &map_q, q_full,
                 cb * QK::kCols, h, q0, b);
      for (int cb = 0; cb < VC::kBlocks; ++cb)
        tma_load(dos + cb * kBQ * VC::kRowBytes, &map_do, q_full,
                 cb * VC::kCols, h, q0, b);
      for (int j = jb; j < nk; ++j) {
        const int st = stage(j);
        if (j - jb >= kS) mbar_wait(empty(st), phase(j) ^ 1u);
        const uint32_t kt = ks + st * T::kKBytes, vt = vs + st * T::kVBytes;
        mbar_expect_tx(k_full(st), T::kKBytes);
        for (int cb = 0; cb < QK::kBlocks; ++cb)
          tma_load(kt + cb * kRows * QK::kRowBytes, &map_k, k_full(st),
                   cb * QK::kCols, g, j * kRows, b);
        mbar_expect_tx(v_full(st), T::kVBytes);
        for (int cb = 0; cb < VC::kBlocks; ++cb)
          tma_load(vt + cb * kRows * VC::kRowBytes, &map_v, v_full(st),
                   cb * VC::kCols, g, j * kRows, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64); this
  // thread holds rows r and r + 8 of them
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + lane / 4;
  const int row0 = q0 + wg * kRows + r, row1 = row0 + 8;
  const int wg_first = q0 + wg * kRows;
  // the warpgroup's key tiles: to its last row's (a causal warpgroup wholly
  // past S takes them all; without causality nkw = nk), from the tile of
  // its first row's window (>= jb; a warpgroup wholly past S takes its
  // last tile alone)
  const int nkw =
      (causal ? min(wg_first + kRows - 1, S - 1) : S - 1) / kRows + 1;
  const int jw = min(max(0, wg_first - window + 1) / kRows, nkw - 1);
  const int col_of = 2 * (lane % 4);  // this thread's first column in an n8
  // the keys rows row0 and row1 see: (lo, last]
  const int last0 = causal ? row0 : S - 1, last1 = causal ? row1 : S - 1;
  const int lo0 = row0 - window, lo1 = row1 - window;
  // a tile is masked where it reaches past the first row's last key or
  // holds a key at or before the last row's first one
  const int mask_last = causal ? min(wg_first, S - 1) : S - 1;
  const int mask_first = wg_first + kRows - 1 - window;

  const float* lse_b = lse + static_cast<size_t>(bh) * S;
  const float l0 = row0 < S ? lse_b[row0] : 0.0f;
  const float l1 = row1 < S ? lse_b[row1] : 0.0f;
  const float d0 = row_delta<DV>(o, o_lo, dout, b, row0, h, S, H, lane % 4);
  const float d1 = row_delta<DV>(o, o_lo, dout, b, row1, h, S, H, lane % 4);
  if (lane % 4 == 0) {
    if (row0 < S) delta[static_cast<size_t>(bh) * S + row0] = d0;
    if (row1 < S) delta[static_cast<size_t>(bh) * S + row1] = d1;
  }

  const uint32_t qa = qs + wg * kRows * QK::kRowBytes;   // this warpgroup's rows
  const uint32_t da = dos + wg * kRows * VC::kRowBytes;
  float acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.0f;
  float s[32], dp[32];
  uint32_t ds[4][4];
  auto release = [&](int st) {  // this warp is done with stage st
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };


  // tiles before this warpgroup's window: loaded for the other one; wait
  // for them (so no stage is released before it is filled) and release
  for (int j = jb; j < jw; ++j) {
    mbar_wait(k_full(stage(j)), phase(j));
    mbar_wait(v_full(stage(j)), phase(j));
    release(stage(j));
  }
  mbar_wait(q_full, 0);
  for (int j = jw; j < nkw; ++j) {
    const int st = stage(j);
    const uint32_t kt = ks + st * T::kKBytes, vt = vs + st * T::kVBytes;
    keep(acc);
    mbar_wait(k_full(st), phase(j));
    mbar_wait(v_full(st), phase(j));
    wgmma_fence();
    issue_ss<DQK, kBQ>(s, qa, kt);
    issue_ss<DV, kBQ>(dp, da, vt);
    wgmma_commit();
    wgmma_wait<0>();
    keep(s);
    keep(dp);
    // dS = P (dP - D), P 0 (a select) outside a row's keys (lo, last], in a
    // tile that reaches past the warpgroup's first row (causal) or S, or
    // holds a key at or before its last row's position minus the window
    const int k0 = j * kRows;
    const bool masked = k0 + kRows - 1 > mask_last || k0 <= mask_first;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * i + col_of + e;
        float p0 = exp2f(fmaf(s[4 * i + e], scale_log2, -l0));
        float p1 = exp2f(fmaf(s[4 * i + 2 + e], scale_log2, -l1));
        if (masked) {
          if (col > last0 || col <= lo0) p0 = 0.0f;
          if (col > last1 || col <= lo1) p1 = 0.0f;
        }
        s[4 * i + e] = p0 * (dp[4 * i + e] - d0);
        s[4 * i + 2 + e] = p1 * (dp[4 * i + 2 + e] - d1);
      }
    pack_a(ds, s);
    keep(ds);
    wgmma_fence();
    issue_rs<DQK>(acc, ds, kt);
    wgmma_commit();
    wgmma_wait<0>();
    keep(acc);
    keep(ds);
    release(st);
  }

  const size_t step = static_cast<size_t>(H) * DQK;  // elements per position
  bf16* dqb = dq + (static_cast<size_t>(b) * S * H + h) * DQK + col_of;
  if (row0 < S) {
    uint32_t* out = reinterpret_cast<uint32_t*>(dqb + row0 * step);
#pragma unroll
    for (int c = 0; c < DQK / 8; ++c)
      out[4 * c] = pack_bf16(scale * acc[4 * c], scale * acc[4 * c + 1]);
  }
  if (row1 < S) {
    uint32_t* out = reinterpret_cast<uint32_t*>(dqb + row1 * step);
#pragma unroll
    for (int c = 0; c < DQK / 8; ++c)
      out[4 * c] = pack_bf16(scale * acc[4 * c + 2], scale * acc[4 * c + 3]);
  }
}

// The rows key0 and key0 + 8 of this thread's fragment of a [., S, KH, D]
// tensor: float32 partials out (part), or x scale, rounded to bf16 (out).
template <int D>
__device__ __forceinline__ void store_rows(float* part, bf16* out,
                                           const float (&c)[D / 2], int key0,
                                           int S, size_t stride, float scale) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = key0 + 8 * hf;
      if (key >= S) continue;
      const float x = c[4 * n + 2 * hf], y = c[4 * n + 2 * hf + 1];
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + key * stride + 8 * n) =
            make_float2(x, y);
      else
        *reinterpret_cast<uint32_t*>(out + key * stride + 8 * n) =
            pack_bf16(scale * x, scale * y);
    }
}

// c = the sum of the splits' partials at this thread's fragment, in split
// order from 0 (its own split read back too, bitwise what it wrote, so c
// itself is the accumulator: no second array of D / 2 floats, which at
// D 256 would not fit the registers): a split's loads all go out together,
// then their adds.
template <int D>
__device__ __forceinline__ void sum_rows(float (&c)[D / 2],
                                         const float* part, size_t split_size,
                                         int splits, int key0, int S,
                                         size_t stride) {
#pragma unroll
  for (int x = 0; x < D / 2; ++x) c[x] = 0.0f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* ps = part + sp * split_size;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int key = key0 + 8 * hf, x = 4 * n + 2 * hf;
        float2 p = make_float2(0.0f, 0.0f);
        if (key < S)
          p = __ldcg(reinterpret_cast<const float2*>(ps + key * stride +
                                                     8 * n));
        c[x] += p.x;
        c[x + 1] += p.y;
      }
  }
}

// A warpgroup's dV (or dK) of the block's keys to out: with splits > 1 its
// float32 partial to split `split` of part (split_size floats a split),
// then a ticket; the block that draws the last one adds the splits'
// partials in split order. Both consumer warpgroups call it.
template <int D>
__device__ __forceinline__ void finish(float (&c)[D / 2], bf16* out,
                                       float* part, size_t split_size,
                                       int splits, int split, int* ticket,
                                       int* last_flag, int key0, int S,
                                       size_t stride, float scale) {
  if (splits > 1) {
    store_rows<D>(part + split * split_size, nullptr, c, key0, S, stride,
                  1.0f);
    __threadfence();
    consumers_sync(256);
    if (threadIdx.x == 0) *last_flag = atomicAdd(ticket, 1) == splits - 1;
    consumers_sync(256);
    if (!*last_flag) return;
    __threadfence();
    sum_rows<D>(c, part, split_size, splits, key0, S, stride);
  }
  store_rows<D>(nullptr, out, c, key0, S, stride, scale);
}

// Named barriers between the two consumer warpgroups of a dK/dV block
// (0 is __syncthreads, 1 consumers_sync): "P of buffer x written" and "P of
// buffer x read", x = item % 2.
constexpr int kPFull = 2, kPEmpty = 4;
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

template <int DQK, int DV>
__global__ void __launch_bounds__(Bwd<DQK, DV>::kKVThreads, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_do,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, float* __restrict__ part,
                int* __restrict__ tickets, int B, int S, int H, int KH,
                int splits, int window, int causal, float scale,
                float scale_log2) {
  using T = Bwd<DQK, DV>;
  using QK = typename T::QK;
  using VC = typename T::VC;
  constexpr int kS = T::kKVStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const basep = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t ks = base;                         // [col block][64 keys]
  const uint32_t vs = ks + T::kKBytes;
  const uint32_t qs = vs + T::kVBytes;              // [stage][cb][64 queries]
  const uint32_t dos = qs + kS * T::kKBytes;
  const uint32_t rows_off = dos + kS * T::kVBytes - base;
  float* const lse_s = reinterpret_cast<float*>(basep + rows_off);  // [stage][64]
  float* const del_s = lse_s + kS * kRows;
  float* const pbuf = del_s + kS * kRows;           // [2][32][128 threads]
  const uint32_t bars = base + rows_off + kS * 2 * kRows * 4 + 2 * kPBytes;
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + kS + st); };
  int* const last_flag = reinterpret_cast<int*>(basep + (bars - base) +
                                                8 * (1 + 2 * kS));

  // key tiles nearest the start (they see the most queries) first
  const int per_tile = B * KH * splits;
  const int tile = static_cast<int>(blockIdx.x) / per_tile;
  int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int split = rest % splits;
  rest /= splits;
  const int g = rest % KH, b = rest / KH;
  const int G = H / KH, Gs = G / splits;
  const int h0 = g * G + split * Gs;  // the split's first query head
  const int k0 = tile * kRows;
  // chunks of 64 queries a head, from chunk cf: causal, from the tile's
  // first key to the last query the window of its last key reaches (the
  // tile's last key + W - 1, or S - 1 without a window); else every chunk
  const int cf = causal ? tile : 0;
  const int q_end = causal ? min(S, k0 + kRows - 1 + window) : S;
  const int nc = (q_end - 1) / kRows - cf + 1;
  const int items = Gs * nc;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kS; ++st) {
      mbar_init(full(st), 1 + 32);  // the TMA bytes' arrival + 32 lanes
      mbar_init(empty(st), 8);      // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 8) {
    // producer: lane 0 issues the TMA loads; every lane copies two rows'
    // lse and D of a chunk into its stage and arrives
    if (lane == 0) {
      mbar_expect_tx(kv_full, T::kKBytes + T::kVBytes);
      for (int cb = 0; cb < QK::kBlocks; ++cb)
        tma_load(ks + cb * kRows * QK::kRowBytes, &map_k, kv_full,
                 cb * QK::kCols, g, k0, b);
      for (int cb = 0; cb < VC::kBlocks; ++cb)
        tma_load(vs + cb * kRows * VC::kRowBytes, &map_v, kv_full,
                 cb * VC::kCols, g, k0, b);
    }
    for (int i = 0; i < items; ++i) {
      const int st = i % kS;
      if (i >= kS)
        mbar_wait(empty(st), (static_cast<uint32_t>(i / kS) & 1u) ^ 1u);
      const int h = h0 + i / nc, c0 = (cf + i % nc) * kRows;
      if (lane == 0) {
        const uint32_t qt = qs + st * T::kKBytes, dt = dos + st * T::kVBytes;
        mbar_expect_tx(full(st), T::kKBytes + T::kVBytes);
        for (int cb = 0; cb < QK::kBlocks; ++cb)
          tma_load(qt + cb * kRows * QK::kRowBytes, &map_q, full(st),
                   cb * QK::kCols, h, c0, b);
        for (int cb = 0; cb < VC::kBlocks; ++cb)
          tma_load(dt + cb * kRows * VC::kRowBytes, &map_do, full(st),
                   cb * VC::kCols, h, c0, b);
      }
      const size_t row = (static_cast<size_t>(b) * H + h) * S;
      for (int x = lane; x < kRows; x += 32) {
        const int qi = c0 + x;
        lse_s[st * kRows + x] = qi < S ? lse[row + qi] : 0.0f;
        del_s[st * kRows + x] = qi < S ? delta[row + qi] : 0.0f;
      }
      mbar_arrive(full(st));
    }
    return;
  }

  // consumers: both warpgroups take the block's 64 keys; this thread holds
  // keys r and r + 8 of them
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + lane / 4;
  const int key0 = k0 + r, key1 = key0 + 8;
  const int col_of = 2 * (lane % 4);  // this thread's first column in an n8
  // the queries that see keys key0 and key1: [qlo, qhi) (the key itself
  // to the key + W - 1 with causality, else every query before S)
  const int qlo0 = causal ? key0 : 0, qlo1 = causal ? key1 : 0;
  const int qhi0 = causal ? min(S, key0 + window) : S;
  const int qhi1 = causal ? min(S, key1 + window) : S;
  // a chunk is masked where it starts before the last key's first query
  // or ends at or past the first key's last one
  const int mask_lo = causal ? k0 + kRows - 1 : 0;
  const int mask_hi = causal ? min(S, k0 + window) : S;
  const size_t sk = static_cast<size_t>(KH) * DQK, sv = static_cast<size_t>(KH) * DV;
  const size_t off_b = static_cast<size_t>(b) * S;  // the batch's first row
  int* const ticket = tickets + (tile * B + b) * KH + g;
  float s[32];
  uint32_t a[4][4];
  auto release = [&](int st) {  // this warp is done with stage st
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };

  mbar_wait(kv_full, 0);
  if (wg == 0) {
    // the P warpgroup: S^T = K.Q^T, P^T (to the dS warpgroup through
    // pbuf), dV += P^T.dO
    float acc[DV / 2];
#pragma unroll
    for (int x = 0; x < DV / 2; ++x) acc[x] = 0.0f;
    for (int i = 0; i < items; ++i) {
      const int st = i % kS, c0 = (cf + i % nc) * kRows;
      const uint32_t qt = qs + st * T::kKBytes, dt = dos + st * T::kVBytes;
      const float* ls = lse_s + st * kRows;
      float* const pb = pbuf + (i % 2) * 32 * 128 + t;
      keep(acc);
      mbar_wait(full(st), static_cast<uint32_t>(i / kS) & 1u);
      wgmma_fence();
      issue_ss<DQK, kRows>(s, ks, qt);
      wgmma_commit();
      wgmma_wait<0>();
      keep(s);
      // P^T, 0 (a select) where the query is at or past S, before the key
      // (causal) or at or past the key + W: in the chunk on the diagonal,
      // one reaching past S, or one reaching the window's end
      const bool masked = c0 < mask_lo || c0 + kRows > mask_hi;
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i8 + col_of + e, qi = c0 + col;
          const float l = ls[col];
          float p0 = exp2f(fmaf(s[4 * i8 + e], scale_log2, -l));
          float p1 = exp2f(fmaf(s[4 * i8 + 2 + e], scale_log2, -l));
          if (masked) {
            if (qi < qlo0 || qi >= qhi0) p0 = 0.0f;
            if (qi < qlo1 || qi >= qhi1) p1 = 0.0f;
          }
          s[4 * i8 + e] = p0;
          s[4 * i8 + 2 + e] = p1;
        }
      if (i >= 2) bar_sync(kPEmpty + i % 2);  // P(i - 2) has been read
#pragma unroll
      for (int x = 0; x < 32; ++x) pb[x * 128] = s[x];
      bar_arrive(kPFull + i % 2);
      pack_a(a, s);
      keep(a);
      wgmma_fence();
      issue_rs<DV>(acc, a, dt);
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      keep(a);
      release(st);
    }
    float* const pv = part + static_cast<size_t>(splits) * B * S * sk +
                      off_b * sv + g * DV + col_of;
    finish<DV>(acc, dv + off_b * sv + g * DV + col_of, pv, B * S * sv,
               splits, split, ticket, last_flag, key0, S, sv, 1.0f);
  } else {
    // the dS warpgroup: dP^T = V.dO^T, dS^T = P^T (dP^T - D), dK += dS^T.Q
    float acc[DQK / 2];
#pragma unroll
    for (int x = 0; x < DQK / 2; ++x) acc[x] = 0.0f;
    for (int i = 0; i < items; ++i) {
      const int st = i % kS;
      const uint32_t qt = qs + st * T::kKBytes, dt = dos + st * T::kVBytes;
      const float* dl = del_s + st * kRows;
      const float* const pb = pbuf + (i % 2) * 32 * 128 + t;
      keep(acc);
      mbar_wait(full(st), static_cast<uint32_t>(i / kS) & 1u);
      wgmma_fence();
      issue_ss<DV, kRows>(s, vs, dt);
      wgmma_commit();
      wgmma_wait<0>();
      keep(s);
      bar_sync(kPFull + i % 2);  // P(i) is written
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = dl[8 * i8 + col_of + e];
          const int x0 = 4 * i8 + e, x1 = x0 + 2;
          s[x0] = pb[x0 * 128] * (s[x0] - d);
          s[x1] = pb[x1 * 128] * (s[x1] - d);
        }
      if (i + 2 < items) bar_arrive(kPEmpty + i % 2);
      pack_a(a, s);
      keep(a);
      wgmma_fence();
      issue_rs<DQK>(acc, a, qt);
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      keep(a);
      release(st);
    }
    float* const pk = part + off_b * sk + g * DQK + col_of;
    finish<DQK>(acc, dk + off_b * sk + g * DQK + col_of, pk, B * S * sk,
                splits, split, ticket, last_flag, key0, S, sk, scale);
  }
}

template <int DQK, int DV>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* o_lo, const bf16* dout, const float* lse, bf16* dq,
           bf16* dk, bf16* dv,
           float* delta, float* part, int* tickets, int B, int S, int H,
           int KH, int splits, int window, int causal, float scale,
           cudaStream_t stream) {
  using T = Bwd<DQK, DV>;
  // launch 1 reads kBQ-row Q and dO tiles, launch 2 64-row chunks; both
  // read K and V in 64-row tiles
  CUtensorMap mq, mdo, mk, mv, cq, cdo;
  if (!encode<DQK>(&mq, q, B, S, H, T::kBQ) ||
      !encode<DV>(&mdo, dout, B, S, H, T::kBQ) ||
      !encode<DQK>(&mk, k, B, S, KH, kRows) ||
      !encode<DV>(&mv, v, B, S, KH, kRows) ||
      !encode<DQK>(&cq, q, B, S, H, kRows) ||
      !encode<DV>(&cdo, dout, B, S, H, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // above 48 KB only after opting in
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dq_kernel<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::kQSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dkdv_kernel<DQK, DV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 T::kKVSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nq = (S + T::kBQ - 1) / T::kBQ;
  const int nk = (S + kRows - 1) / kRows;
  const long long q_blocks = static_cast<long long>(nq) * B * H;
  const long long kv_blocks = static_cast<long long>(nk) * B * KH * splits;
  const int n_tickets = splits > 1 ? nk * B * KH : 0;
  if (q_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * kLog2e;
  bwd_dq_kernel<DQK, DV><<<static_cast<unsigned>(q_blocks), T::kQThreads,
                           T::kQSmem, stream>>>(
      mq, mdo, mk, mv, o, o_lo, dout, lse, delta, dq, tickets, n_tickets, S,
      H, KH,
      B * H, nq, window, causal, scale, scale_log2);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_dkdv_kernel<DQK, DV><<<static_cast<unsigned>(kv_blocks), T::kKVThreads,
                             T::kKVSmem, stream>>>(
      cq, cdo, mk, mv, lse, delta, dk, dv, part, tickets, B, S, H, KH, splits,
      window, causal, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The (dqk, dv) pairs the backward is built for, as X(dqk, dv).
#define FA_BWD_PAIRS(X) \
  X(16, 16) X(64, 64) X(128, 128) X(256, 256) X(96, 64) X(192, 128) X(32, 16)

// q [B, S, H, dqk], k [B, S, KH, dqk], v [B, S, KH, dv], o, o_lo (the
// forward's output's low part) and dout [B, S, H, dv], dq [B, S, H, dqk],
// dk [B, S, KH, dqk], dv [B, S, KH, dv]:
// contiguous bfloat16, 16-byte aligned; lse [B, H, S] (the forward's, base
// 2) and the scratch delta [B, H, S]: float32. splits divides H / KH (see
// the design note); with splits > 1, part is float32 scratch of splits x B
// x S x KH x (dqk + dv) and tickets int32 scratch of ceil(S / keys a block)
// x B x KH (either may be null with splits = 1). (dqk, dv) one of
// FA_BWD_PAIRS; KH divides H; window the sliding window in positions, or
// <= 0 for none; causal 1 for the causal mask, 0 for none (then the window
// is ignored): the forward's mask (flash_attn_tc_launch). Two kernel
// launches on the stream. Anything else returns cudaErrorInvalidValue
// without launching.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* o_lo, const void* dout,
                                     const void* lse,
                                     void* dq, void* dk, void* dv,
                                     void* delta, void* part, void* tickets,
                                     int B, int S, int H, int KH, int dqk,
                                     int dv_, int window, int causal,
                                     int splits, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || splits <= 0 ||
      (H / KH) % splits != 0 ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(o_lo) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
       reinterpret_cast<uintptr_t>(part)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // no window, one that covers the sequence, or no causality: no key is
  // outside it (as the forward takes it)
  causal = causal != 0;
  if (!causal || window <= 0 || window >= S) window = 1 << 30;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_BWD_CASE(DQK, DV)                                                \
  case DQK * 1000 + DV:                                                     \
    return launch<DQK, DV>(                                                 \
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),           \
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),           \
        static_cast<const bf16*>(o_lo), static_cast<const bf16*>(dout),     \
        static_cast<const float*>(lse),                                     \
        static_cast<bf16*>(dq), static_cast<bf16*>(dk),                     \
        static_cast<bf16*>(dv), static_cast<float*>(delta),                 \
        static_cast<float*>(part), static_cast<int*>(tickets), B, S, H, KH, \
        splits, window, causal, scale, st);
  switch (dqk * 1000 + dv_) {
    FA_BWD_PAIRS(FA_BWD_CASE)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_BWD_CASE
}

// Dynamic shared memory one block of the dQ kernel (kernel 0) or of the
// dK/dV kernel (kernel 1) takes at head dims (dqk, dv), in bytes (0 for a
// pair it does not take).
extern "C" int flash_attn_bwd_smem_bytes(int dqk, int dv, int kernel) {
#define FA_BWD_SMEM(DQK, DV) \
  case DQK * 1000 + DV:      \
    return kernel ? Bwd<DQK, DV>::kKVSmem : Bwd<DQK, DV>::kQSmem;
  switch (dqk * 1000 + dv) {
    FA_BWD_PAIRS(FA_BWD_SMEM)
    default: return 0;
  }
#undef FA_BWD_SMEM
}

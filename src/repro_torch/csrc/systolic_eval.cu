// systolic_eval: the SoC cost model (VLSI-flow surrogate) on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/systolic_eval/kernel.py::
// soc_metrics (body _body -> repro/soc/model.py::_metrics_tile). Plain
// version: repro_torch/soc/model.py::metrics_tile, whose float32 math this
// kernel repeats op for op (it is built with -fmad=false so no product is
// fused into an add the plain version rounds separately).
//
// What bounds it here: at the main path's shapes (N = 2500 designs, or one
// design, x L = 54 resnet50 layers) the inputs are at most 260 KB and the
// output 30 KB, so the bytes take ~0.1 us at 3.35 TB/s; the ~130 float32
// operations per (design, layer) pair take ~0.3 us at 67 TFLOP/s. Both are
// far below one launch (~2.2 us), so what is left to cut is latency: the
// chain of IEEE divisions, ceilings and sums that one design walks. The
// first port ran one thread per design through all L layers twice (a
// round's one design: 108 layer evaluations in a row, ~20 us), and at 2500
// designs filled only 20 blocks of 128 threads.
//
// Design: a group of G lanes takes one design: a warp, or as many lanes as
// layers when L is small, so one design's chain is short; once the designs
// fill the card (2500 x 54), the fewest lanes that hold 4 layers each, so
// several designs share a warp's sums and epilogue. Lane t evaluates layers
// t, t + G, t + 2G, ... (the layer table [L, 5] is staged once per block in
// shared memory, by 16-byte loads all in flight at once). Pass 1 computes each
// layer's cost once and keeps what pass 2 needs (compute cycles, DRAM
// bytes, tiles) in registers while a lane holds at most KR layers, else in
// shared memory; pass 2 never calls layer_cost again. Every sum keeps the
// first port's order, one sequential chain over layers 0..L-1: each lane
// writes its layers' terms to the group's shared arrays, and then lanes 0,
// 1 and 2 add the DRAM bytes (the L2 working set, also the DRAM total),
// MACs and stream bytes side by side, and after pass 2 lanes 0 and 1 add the
// cycles and the host cycles. So the output is bitwise the first port's.
// decode and the per-design epilogue (powf, log2f, area) run once per
// design. The plan (G, KR, designs per block, shared bytes) comes from
// kernels/systolic_eval.py::launch_plan.
//
// The multi-workload entry (systolic_eval_multi_launch; the reference's
// soc_metrics_multi, repro/soc/model.py:170) evaluates W workloads, each on
// its own n designs, in one launch: vals [W, n, 26], layers [W, Lmax, 5]
// padded to a common depth and a prefix mask [W, Lmax]; the grid spans
// (design tile, workload). A block counts its workload's layers L_w from the
// mask and runs exactly the single-workload kernel on layers 0..L_w-1: each
// sum is still one chain over the workload's own layers, so a workload's
// slice is bitwise a single launch on its own table. The plan comes from
// Lmax.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// TABLE_I column order (repro_torch/core/space.py).
enum Feat : int {
  kHostCore = 0, kL2Bank, kL2Way, kL2Capa, kTileRow, kTileCol, kMeshRow,
  kMeshCol, kDataflow, kInputType, kAccType, kOutType, kSpBank, kSpCapa,
  kAccBank, kAccCapa, kLdQueue, kStQueue, kExQueue, kLdRes, kStRes, kExRes,
  kMemReq, kDMABus, kDMABytes, kTLBSize, kNumFeat
};

constexpr int kMaxThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

struct Design {
  float core, R, C, ib, ab, ob, dataflow, spad_bytes, spad_banks, acc_rows,
      acc_bytes, acc_banks, l2_bytes, l2_way, ldq, stq, exq, ldr, str_, exr,
      memreq, dmabus, dmabytes, tlb;
};

struct LayerCost {
  float compute, dram, stream, n_tiles, macs;
};

// model.py::_select — a where-chain over the host-core code.
__device__ __forceinline__ float select3(float core, float a, float b,
                                         float c) {
  float out = a;
  out = (core == 1.0f) ? b : out;
  out = (core == 2.0f) ? c : out;
  return out;
}

__device__ Design decode(const float* v) {
  Design d;
  d.R = v[kTileRow] * v[kMeshRow];
  d.C = v[kTileCol] * v[kMeshCol];
  d.ib = v[kInputType] / 8.0f;
  d.ab = v[kAccType] / 8.0f;
  d.ob = v[kOutType] / 8.0f;
  d.spad_bytes = v[kSpBank] * v[kSpCapa] * d.C * d.ib;
  d.acc_rows = v[kAccBank] * v[kAccCapa];
  d.acc_bytes = d.acc_rows * d.C * d.ab;
  d.l2_bytes = v[kL2Bank] * v[kL2Capa] * 1024.0f;
  d.core = v[kHostCore];
  d.dataflow = v[kDataflow];
  d.spad_banks = v[kSpBank];
  d.acc_banks = v[kAccBank];
  d.l2_way = v[kL2Way];
  d.ldq = v[kLdQueue];
  d.stq = v[kStQueue];
  d.exq = v[kExQueue];
  d.ldr = v[kLdRes];
  d.str_ = v[kStRes];
  d.exr = v[kExRes];
  d.memreq = v[kMemReq];
  d.dmabus = v[kDMABus];
  d.dmabytes = v[kDMABytes];
  d.tlb = v[kTLBSize];
  return d;
}

// model.py::_layer_cost for one (design, layer) pair.
__device__ __forceinline__ LayerCost layer_cost(const Design& d,
                                                const float* r) {
  const float M = r[0], K = r[1], N = r[2], reps = r[3], kind = r[4];
  const float R = d.R, C = d.C, ib = d.ib, ob = d.ob;
  // WS dataflow
  const float Mb = fminf(M, d.acc_rows);
  const float Kt = ceilf(K / R), Nt = ceilf(N / C), Mt = ceilf(M / Mb);
  const float compute_ws = reps * (Kt * Nt * (Mt * Mb + R) + Nt * C);
  const bool w_fits = (K * N * ib) <= 0.5f * d.spad_bytes;
  const bool a_fits = (Mb * K * ib) <= 0.5f * d.spad_bytes;
  const float w_dma_ws = K * N * ib * (w_fits ? 1.0f : Mt);
  const float a_dma_ws = M * K * ib * (a_fits ? 1.0f : Nt);
  const float dram_ws = reps * (w_dma_ws + a_dma_ws + M * N * ob);
  const float stream_ws =
      reps * (Kt * Nt * Mt * (Mb * R * ib + R * C * ib) + M * N * ob);
  // OS dataflow
  const float Mt2 = ceilf(M / R), Nt2 = ceilf(N / C);
  const float compute_os = reps * (Mt2 * Nt2 * (K + R + C));
  const float w_dma_os = K * N * ib * (w_fits ? 1.0f : Mt2);
  const bool a_fits2 = (M * K * ib) <= 0.5f * d.spad_bytes;
  const float a_dma_os = M * K * ib * (a_fits2 ? 1.0f : Nt2);
  const float dram_os = reps * (w_dma_os + a_dma_os + M * N * ob);
  const float stream_os = reps * (Mt2 * Nt2 * K * (R + C) * ib + M * N * ob);
  // dataflow select
  const bool use_os =
      (d.dataflow == 2.0f) ? (compute_os < compute_ws) : (d.dataflow == 1.0f);
  LayerCost c;
  c.compute = use_os ? compute_os : compute_ws;
  c.dram = use_os ? dram_os : dram_ws;
  c.stream = use_os ? stream_os : stream_ws;
  c.n_tiles = (use_os ? Mt2 * Nt2 : Mt * Kt * Nt) * reps;
  if (kind == 1.0f) c.dram = c.dram + 0.15f * K * N * ib * reps;
  c.macs = reps * M * K * N;
  return c;
}

// model.py::_area
__device__ float area(const Design& d) {
  const float pe = 1.6e-4f * powf(d.ib, 1.25f) * (1.0f + 0.25f * d.ab / 4.0f);
  float arr = d.R * d.C * pe;
  arr = arr * ((d.dataflow == 2.0f) ? 1.12f
                                    : ((d.dataflow == 1.0f) ? 1.05f : 1.0f));
  const float mb = 1.0f / (1024.0f * 1024.0f);
  const float sram = d.spad_bytes * mb * 0.90f + d.acc_bytes * mb * 1.35f +
                     d.l2_bytes * mb * 1.05f *
                         (1.0f + 0.02f * log2f(d.l2_way / 4.0f));
  const float queues =
      (d.ldq + d.stq + d.exq + d.ldr + d.str_ + d.exr) * 6.0e-4f;
  const float dma = d.dmabus / 8.0f * 2.0e-3f + d.tlb * 1.0e-3f;
  const float core = select3(d.core, 1.10f, 0.35f, 0.22f);
  return (arr + sram + queues + dma + core) * 1.08f;
}

// The design-level constants of pass 2 (model.py: bandwidth, host issue,
// double buffering), from the DRAM total of pass 1.
struct Pass2 {
  float bw, issue, host_scale, buf;
};

__device__ __forceinline__ Pass2 pass2_constants(const Design& d,
                                                 float working,
                                                 int n_layers) {
  // memory bandwidth (bytes / cycle)
  float l2_hit = 3.0f * d.l2_bytes / (working / (float)n_layers + 1.0f);
  l2_hit = fminf(fmaxf(l2_hit, 0.0f), 0.85f) *
           (1.0f + 0.05f * log2f(d.l2_way / 4.0f));
  const float mem_lat = l2_hit * 24.0f + (1.0f - l2_hit) * 120.0f;
  const float eff = d.dmabytes / (d.dmabytes + 16.0f);
  Pass2 p;
  p.bw = fminf(d.dmabus / 8.0f, d.memreq * d.dmabytes / mem_lat) * eff;
  // host / RoCC control
  p.issue = select3(d.core, 2.0f, 5.0f, 8.0f);
  const float q_eff = fminf(fminf(d.ldq, d.ldr), fminf(d.exq, d.exr));
  p.host_scale = 1.0f + 2.0f / q_eff;
  p.buf = fminf(fmaxf((d.spad_banks - 4.0f) / 12.0f, 0.0f), 1.0f) * 0.8f +
          fminf(fmaxf((d.acc_banks - 1.0f) / 7.0f, 0.0f), 1.0f) * 0.2f;
  return p;
}

// One layer's pass-2 terms: its cycles (overlap of compute, DMA and host)
// and its host cycles.
__device__ __forceinline__ void pass2_layer(const Design& d, const Pass2& p,
                                            float compute, float dram,
                                            float n_tiles, float* cyc,
                                            float* host) {
  const float pages = dram / 4096.0f;
  const float tlb_miss = fmaxf(pages - d.tlb * 8.0f, 0.0f);
  const float dma_cycles = dram / p.bw + tlb_miss * 40.0f;
  const float cmds = 4.0f * n_tiles + 24.0f;
  const float host_cycles = cmds * p.issue * p.host_scale;
  const float hi = fmaxf(fmaxf(compute, dma_cycles), host_cycles);
  const float rest = compute + dma_cycles + host_cycles - hi;
  *cyc = hi + (1.0f - p.buf) * 0.5f * rest + 400.0f * p.issue;
  *host = host_cycles;
}

// Copies n floats from device memory to shared memory with the block's
// threads: 16-byte loads, kBatch of them in flight a thread before their
// stores (one round trip to L2 for resnet50's table), scalar loads where
// the source is not 16-byte aligned.
constexpr int kBatch = 4;

__device__ __forceinline__ void stage_table(float* dst,
                                            const float* __restrict__ src,
                                            int n) {
  const int t = threadIdx.x, nt = blockDim.x;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int base = t; base < n4; base += kBatch * nt) {
      float4 w[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (base + u * nt < n4) w[u] = src4[base + u * nt];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (base + u * nt < n4) {
          float* o = dst + 4 * (base + u * nt);
          o[0] = w[u].x;
          o[1] = w[u].y;
          o[2] = w[u].z;
          o[3] = w[u].w;
        }
    }
    done = 4 * n4;
  }
#pragma unroll 4
  for (int e = done + t; e < n; e += nt) dst[e] = src[e];
}

// Lane `lane` (< 3) of a group adds arrays[lane][0..n) in order.
__device__ __forceinline__ float ordered_sum(const float* a, int n) {
  float acc = 0.0f;
#pragma unroll 4
  for (int l = 0; l < n; ++l) acc += a[l];
  return acc;
}

// The number of real layers of a prefix mask row [n_layers] (1.0 on real
// layers), counted by warp 0 of the block: -1 if the ones are not a prefix.
__device__ __forceinline__ int prefix_count(const float* __restrict__ mask,
                                            int n_layers) {
  int ones = 0, last = -1;
  for (int l = threadIdx.x; l < n_layers; l += 32)
    if (mask[l] != 0.0f) {
      ++ones;
      last = l;
    }
  ones = __reduce_add_sync(kFull, ones);
  last = __reduce_max_sync(kFull, last);
  return last + 1 == ones ? ones : -1;
}

// KR > 0: a lane keeps its (at most KR) layers' pass-1 values in
// registers; KR == 0: in the group's shared arrays (any L). Workload
// blockIdx.y of the batch: with a mask, its first L_w of n_layers layers
// (a mask that is not a prefix gives NaN outputs); without, all n_layers.
template <int KR>
__global__ void __launch_bounds__(kMaxThreads)
systolic_eval_kernel(const float* __restrict__ vals,
                     const float* __restrict__ layers,
                     const float* __restrict__ mask,
                     float* __restrict__ out, int n, int n_layers,
                     int g_log2, int stride) {
  extern __shared__ float smem[];
  __shared__ int s_count;
  const size_t w = blockIdx.y;
  vals += w * n * kNumFeat;
  layers += w * n_layers * 5;
  out += w * n * 3;
  if (mask != nullptr && threadIdx.x < 32) {
    const int c = prefix_count(mask + w * n_layers, n_layers);
    if (threadIdx.x == 0) s_count = c;
  }
  const int G = 1 << g_log2;
  const int lane = threadIdx.x & (G - 1);
  const int groups = blockDim.x >> g_log2;
  const int slot = blockIdx.x * groups + (threadIdx.x >> g_log2);
  // a group past the last design evaluates it again and stores nothing, so
  // every lane of a warp runs the same loops (shuffles and __syncwarp)
  const int i = slot < n ? slot : n - 1;
  constexpr int kArrays = KR > 0 ? 3 : 5;
  float* lay = smem;  // [n_layers, 5]
  // the group's arrays, `stride` floats each (odd: lanes 0..2 of a sum
  // read three banks): DRAM bytes, MACs then cycles, stream bytes then
  // host cycles, and with KR == 0 compute cycles and tiles
  float* s_dram =
      smem + 5 * n_layers + (threadIdx.x >> g_log2) * kArrays * stride;
  float* s_a = s_dram + stride;
  float* s_b = s_a + stride;
  float* s_comp = s_b + stride;
  float* s_tiles = s_comp + stride;

  float v[kNumFeat];
#pragma unroll
  for (int f = 0; f < kNumFeat; ++f) v[f] = vals[(size_t)i * kNumFeat + f];
  stage_table(lay, layers, 5 * n_layers);
  __syncthreads();
  const int counted = mask != nullptr ? s_count : n_layers;
  if (counted < 0) {  // not a prefix mask
    const float nan = __int_as_float(0x7fc00000);
    if (lane == 0 && slot < n)
      for (int k = 0; k < 3; ++k) out[(size_t)i * 3 + k] = nan;
    return;
  }
  const int L = counted;
  const Design d = decode(v);
  // the epilogue's per-design terms, early: their powf/log2f latency
  // overlaps pass 1
  const float a = area(d);
  const float e_mac = 0.25f * powf(d.ib, 1.7f);

  // pass 1: each layer's cost, once
  float r_comp[KR > 0 ? KR : 1], r_dram[KR > 0 ? KR : 1],
      r_tiles[KR > 0 ? KR : 1];
  if constexpr (KR > 0) {
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      const int l = lane + j * G;
      if (l < L) {
        const LayerCost c = layer_cost(d, lay + 5 * l);
        s_dram[l] = c.dram;
        s_a[l] = c.macs;
        s_b[l] = c.stream;
        r_comp[j] = c.compute;
        r_dram[j] = c.dram;
        r_tiles[j] = c.n_tiles;
      }
    }
  } else {
#pragma unroll 2
    for (int l = lane; l < L; l += G) {
      const LayerCost c = layer_cost(d, lay + 5 * l);
      s_dram[l] = c.dram;
      s_a[l] = c.macs;
      s_b[l] = c.stream;
      s_comp[l] = c.compute;
      s_tiles[l] = c.n_tiles;
    }
  }
  __syncwarp();
  // ordered sums over layers 0..L-1: lane 0 the DRAM bytes (the L2 working
  // set and the DRAM total alike), lane 1 the MACs, lane 2 the stream bytes
  const float sum1 = lane < 3 ? ordered_sum(s_dram + lane * stride, L) : 0.0f;
  __syncwarp();
  const float working = __shfl_sync(kFull, sum1, 0, G);
  const Pass2 p = pass2_constants(d, working, L > 0 ? L : 1);

  // pass 2: the per-layer cycles and host cycles, into the arrays of the
  // MACs and stream bytes (summed above)
  if constexpr (KR > 0) {
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      const int l = lane + j * G;
      if (l < L)
        pass2_layer(d, p, r_comp[j], r_dram[j], r_tiles[j], s_a + l, s_b + l);
    }
  } else {
#pragma unroll 2
    for (int l = lane; l < L; l += G)
      pass2_layer(d, p, s_comp[l], s_dram[l], s_tiles[l], s_a + l, s_b + l);
  }
  __syncwarp();
  const float sum2 = lane < 2 ? ordered_sum(s_a + lane * stride, L) : 0.0f;
  const float macs = __shfl_sync(kFull, sum1, 1, G);
  const float stream = __shfl_sync(kFull, sum1, 2, G);
  const float host = __shfl_sync(kFull, sum2, 1, G);
  if (lane != 0 || slot >= n) return;
  const float cycles = sum2, dram = working;
  const float latency_ms = cycles / 1.0e9f * 1.0e3f;
  const float pj = macs * e_mac + stream * 0.45f + dram * 18.0f;
  const float nj = pj * 1.0e-3f + host * select3(d.core, 0.35f, 0.18f, 0.12f);
  const float power_mw =
      (nj * 1.0e-9f) / (cycles / 1.0e9f) * 1.0e3f + 2.0f + 0.6f * a;
  out[(size_t)i * 3 + 0] = latency_ms;
  out[(size_t)i * 3 + 1] = power_mw;
  out[(size_t)i * 3 + 2] = a;
}

template <int KR>
cudaError_t launch(const float* vals, const float* layers, const float* mask,
                   float* out, int W, int n, int n_layers, int g_log2,
                   int threads, int stride, int smem_bytes, cudaStream_t st) {
  static int opted_in = 0;  // bytes this instance may use (opt in once)
  if (smem_bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        systolic_eval_kernel<KR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return err;
    opted_in = smem_bytes;
  }
  const int groups = threads >> g_log2;
  const dim3 grid((n + groups - 1) / groups, W);
  systolic_eval_kernel<KR><<<grid, threads, smem_bytes, st>>>(
      vals, layers, mask, out, n, n_layers, g_log2, stride);
  return cudaGetLastError();
}

// Checks a plan and launches W workloads (mask == nullptr: W = 1, no mask).
int launch_checked(const void* vals, const void* layers, const void* mask,
                   void* out, int W, int n, int n_layers, int g_log2, int kr,
                   int threads, int stride, int smem_bytes, void* stream) {
  const int G = 1 << g_log2;
  const int arrays = kr > 0 ? 3 : 5;
  const bool ok =
      W >= 1 && W <= 65535 && n > 0 && n_layers > 0 && g_log2 >= 2 &&
      g_log2 <= 5 && (kr == 0 || kr == 1 || kr == 2 || kr == 4) &&
      (kr == 0 || n_layers <= kr * G) && threads >= 32 &&
      threads <= kMaxThreads && threads % 32 == 0 && stride >= n_layers &&
      (size_t)4 * (5 * (size_t)n_layers +
                   (size_t)(threads / G) * arrays * stride) <=
          (size_t)smem_bytes;
  if (!ok) return (int)cudaErrorInvalidValue;
  const float* v = (const float*)vals;
  const float* l = (const float*)layers;
  const float* mk = (const float*)mask;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (kr) {
    case 1: err = launch<1>(v, l, mk, o, W, n, n_layers, g_log2, threads,
                            stride, smem_bytes, st); break;
    case 2: err = launch<2>(v, l, mk, o, W, n, n_layers, g_log2, threads,
                            stride, smem_bytes, st); break;
    case 4: err = launch<4>(v, l, mk, o, W, n, n_layers, g_log2, threads,
                            stride, smem_bytes, st); break;
    default: err = launch<0>(v, l, mk, o, W, n, n_layers, g_log2, threads,
                             stride, smem_bytes, st); break;
  }
  return (int)err;
}

}  // namespace

// vals [n, 26], layers [n_layers, 5], out [n, 3]; all float32, contiguous.
// The plan from kernels/systolic_eval.py::launch_plan: 2^g_log2 lanes a
// design (4..32), kr layers a lane in registers (1, 2 or 4; 0: shared
// memory), threads a block, the odd stride of the per-design arrays and the
// dynamic shared bytes; a plan that does not add up is refused.
extern "C" int systolic_eval_launch(const void* vals, const void* layers,
                                    void* out, int n, int n_layers,
                                    int g_log2, int kr, int threads,
                                    int stride, int smem_bytes,
                                    void* stream) {
  return launch_checked(vals, layers, nullptr, out, 1, n, n_layers, g_log2,
                        kr, threads, stride, smem_bytes, stream);
}

// W workloads in one launch: vals [W, n, 26], layers [W, lmax, 5], mask
// [W, lmax] (a prefix of 1.0 on each workload's real layers), out
// [W, n, 3]; the plan is launch_plan's at lmax.
extern "C" int systolic_eval_multi_launch(const void* vals,
                                          const void* layers,
                                          const void* mask, void* out, int W,
                                          int n, int lmax, int g_log2,
                                          int kr, int threads, int stride,
                                          int smem_bytes, void* stream) {
  if (mask == nullptr) return (int)cudaErrorInvalidValue;
  return launch_checked(vals, layers, mask, out, W, n, lmax, g_log2, kr,
                        threads, stride, smem_bytes, stream);
}

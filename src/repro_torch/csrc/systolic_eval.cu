// systolic_eval: the SoC cost model (VLSI-flow surrogate) on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/systolic_eval/kernel.py::
// soc_metrics (body _body -> repro/soc/model.py::_metrics_tile). Plain
// version: repro_torch/soc/model.py::metrics_tile, whose float32 math this
// kernel repeats op for op (it is built with -fmad=false so no product is
// fused into an add the plain version rounds separately).
//
// What bounds it here: at the main path's shapes (N = 2500 designs x L = 54
// resnet50 layers) the inputs are 260 KB and the output 30 KB, so the bytes
// take ~0.1 us at 3.35 TB/s; the ~100 float32 operations per (design, layer)
// pair take ~0.2 us at 67 TFLOP/s. Both are far below one launch, so the
// kernel is bound by launch latency and by the serial chain of divisions,
// ceilings and powf within one thread.
//
// Design: one thread per design, so nothing is reduced across threads. The
// layer table [L, 5] is staged once per block in shared memory (every thread
// reads every layer). Two passes over the layers: the first sums the DRAM
// bytes that the L2 hit rate needs (model.py: working / n_layers); the
// second recomputes each layer's cost and accumulates cycles, MACs, stream
// bytes and host cycles, so no [N, L] intermediate ever leaves registers
// (the plain version writes ~60 of them to device memory).
#include <cuda_runtime.h>

namespace {

// TABLE_I column order (repro_torch/core/space.py).
enum Feat : int {
  kHostCore = 0, kL2Bank, kL2Way, kL2Capa, kTileRow, kTileCol, kMeshRow,
  kMeshCol, kDataflow, kInputType, kAccType, kOutType, kSpBank, kSpCapa,
  kAccBank, kAccCapa, kLdQueue, kStQueue, kExQueue, kLdRes, kStRes, kExRes,
  kMemReq, kDMABus, kDMABytes, kTLBSize, kNumFeat
};

constexpr int kThreads = 128;

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
__device__ LayerCost layer_cost(const Design& d, float M, float K, float N,
                                float reps, float kind) {
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

__global__ void __launch_bounds__(kThreads)
systolic_eval_kernel(const float* __restrict__ vals,
                     const float* __restrict__ layers,
                     float* __restrict__ out, int n, int n_layers) {
  extern __shared__ float lay[];  // [n_layers, 5]
  for (int e = threadIdx.x; e < n_layers * 5; e += blockDim.x)
    lay[e] = layers[e];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[kNumFeat];
#pragma unroll
  for (int f = 0; f < kNumFeat; ++f) v[f] = vals[(size_t)i * kNumFeat + f];
  const Design d = decode(v);

  // pass 1: total DRAM traffic (the L2 working set)
  float working = 0.0f;
  for (int l = 0; l < n_layers; ++l) {
    const float* r = lay + 5 * l;
    working += layer_cost(d, r[0], r[1], r[2], r[3], r[4]).dram;
  }
  // memory bandwidth (bytes / cycle)
  float l2_hit = 3.0f * d.l2_bytes / (working / (float)n_layers + 1.0f);
  l2_hit = fminf(fmaxf(l2_hit, 0.0f), 0.85f) *
           (1.0f + 0.05f * log2f(d.l2_way / 4.0f));
  const float mem_lat = l2_hit * 24.0f + (1.0f - l2_hit) * 120.0f;
  const float eff = d.dmabytes / (d.dmabytes + 16.0f);
  const float bw = fminf(d.dmabus / 8.0f, d.memreq * d.dmabytes / mem_lat) * eff;
  // host / RoCC control
  const float issue = select3(d.core, 2.0f, 5.0f, 8.0f);
  const float q_eff = fminf(fminf(d.ldq, d.ldr), fminf(d.exq, d.exr));
  const float host_scale = 1.0f + 2.0f / q_eff;
  const float buf =
      fminf(fmaxf((d.spad_banks - 4.0f) / 12.0f, 0.0f), 1.0f) * 0.8f +
      fminf(fmaxf((d.acc_banks - 1.0f) / 7.0f, 0.0f), 1.0f) * 0.2f;

  // pass 2: per-layer overlap of compute, DMA and host cycles
  float cycles = 0.0f, macs = 0.0f, stream = 0.0f, dram = 0.0f, host = 0.0f;
  for (int l = 0; l < n_layers; ++l) {
    const float* r = lay + 5 * l;
    const LayerCost c = layer_cost(d, r[0], r[1], r[2], r[3], r[4]);
    const float pages = c.dram / 4096.0f;
    const float tlb_miss = fmaxf(pages - d.tlb * 8.0f, 0.0f);
    const float dma_cycles = c.dram / bw + tlb_miss * 40.0f;
    const float cmds = 4.0f * c.n_tiles + 24.0f;
    const float host_cycles = cmds * issue * host_scale;
    const float hi = fmaxf(fmaxf(c.compute, dma_cycles), host_cycles);
    const float rest = c.compute + dma_cycles + host_cycles - hi;
    cycles += hi + (1.0f - buf) * 0.5f * rest + 400.0f * issue;
    macs += c.macs;
    stream += c.stream;
    dram += c.dram;
    host += host_cycles;
  }
  const float latency_ms = cycles / 1.0e9f * 1.0e3f;
  const float e_mac = 0.25f * powf(d.ib, 1.7f);
  const float pj = macs * e_mac + stream * 0.45f + dram * 18.0f;
  const float nj = pj * 1.0e-3f + host * select3(d.core, 0.35f, 0.18f, 0.12f);
  const float a = area(d);
  const float power_mw =
      (nj * 1.0e-9f) / (cycles / 1.0e9f) * 1.0e3f + 2.0f + 0.6f * a;
  out[(size_t)i * 3 + 0] = latency_ms;
  out[(size_t)i * 3 + 1] = power_mw;
  out[(size_t)i * 3 + 2] = a;
}

}  // namespace

// vals [n, 26], layers [n_layers, 5], out [n, 3]; all float32, contiguous.
extern "C" int systolic_eval_launch(const void* vals, const void* layers,
                                    void* out, int n, int n_layers,
                                    void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * 5 * (size_t)n_layers;
  systolic_eval_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)vals, (const float*)layers, (float*)out, n, n_layers);
  return (int)cudaGetLastError();
}

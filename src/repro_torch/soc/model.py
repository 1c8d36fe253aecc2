"""Deterministic SoC performance/power/area model — the VLSI-flow surrogate.

The plain PyTorch version of the ``systolic_eval`` kernel
(``csrc/systolic_eval.cu``): a Gemmini-style systolic array with
scratchpad/accumulator SRAMs, a RoCC-attached host core, shared L2 and a DMA
engine, evaluated per (design, layer) pair and reduced over the layers of a
workload. Op for op the float32 math of ``repro.soc.model``; see that
module's docstring for what each term models. :func:`metrics_multi` is the
plain version of the kernel's multi-workload entry (:func:`soc_metrics_multi`
dispatches between the two): W workloads padded to a common depth, each
against its own designs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.space import TABLE_I

__all__ = ["metrics_tile", "metrics_multi", "soc_metrics_multi",
           "decode_design", "area_breakdown", "FEATI", "CONST"]

# Feature name -> column index in the design-value matrix.
FEATI = {f.name: i for i, f in enumerate(TABLE_I)}

CONST = dict(
    freq_hz=1.0e9,
    # memory system
    dram_lat=120.0,           # cycles, L2 miss
    l2_hit_lat=24.0,          # cycles
    tlb_miss_cost=40.0,       # cycles per missed page walk
    page_bytes=4096.0,
    dma_fixed_overhead=16.0,  # burst setup bytes-equivalent
    # host core: issue cycles per RoCC command; dynamic energy per cycle (nJ)
    core_issue=(2.0, 5.0, 8.0),        # c1 LargeBoom, c2 LargeRocket, c3 MedRocket
    core_energy=(0.35, 0.18, 0.12),    # nJ / cycle
    core_area=(1.10, 0.35, 0.22),      # mm²
    layer_launch_cmds=24.0,   # config/fence commands per layer
    # energy (pJ)
    e_mac8=0.25,              # pJ per 8-bit MAC; scales ^1.7 with byte width
    e_spad_byte=0.45,
    e_acc_byte=0.9,
    e_dram_byte=18.0,
    leak_mw_per_mm2=0.6,
    base_mw=2.0,
    # area (mm²)
    a_pe8=1.6e-4,             # 8-bit PE; scales ^1.25 with input bytes
    a_sram_mb=0.90,           # per MiB
    a_acc_sram_mb=1.35,       # wider ports
    a_l2_mb=1.05,
    a_queue_entry=6.0e-4,
    a_dma_per_byte_lane=2.0e-3,
    a_tlb_entry=1.0e-3,
    noc_overhead=1.08,
)


def decode_design(vals: torch.Tensor) -> dict[str, torch.Tensor]:
    """Design-value matrix [n, 26] -> named physical quantities (each [n])."""
    g = lambda name: vals[..., FEATI[name]]
    R = g("TileRow") * g("MeshRow")
    C = g("TileCol") * g("MeshCol")
    ib = g("InputType") / 8.0
    ab = g("AccType") / 8.0
    ob = g("OutType") / 8.0
    spad_bytes = g("SpBank") * g("SpCapa") * C * ib  # row = C elements
    acc_rows = g("AccBank") * g("AccCapa")
    acc_bytes = acc_rows * C * ab
    l2_bytes = g("L2Bank") * g("L2Capa") * 1024.0
    return dict(
        core=g("HostCore"), R=R, C=C, ib=ib, ab=ab, ob=ob,
        dataflow=g("Dataflow"),
        spad_bytes=spad_bytes, spad_banks=g("SpBank"),
        acc_rows=acc_rows, acc_bytes=acc_bytes, acc_banks=g("AccBank"),
        l2_bytes=l2_bytes, l2_way=g("L2Way"),
        ldq=g("LdQueue"), stq=g("StQueue"), exq=g("ExQueue"),
        ldr=g("LdRes"), str_=g("StRes"), exr=g("ExRes"),
        memreq=g("MemReq"), dmabus=g("DMABus"), dmabytes=g("DMABytes"),
        tlb=g("TLBSize"),
    )


def _select(core_idx: torch.Tensor, table: tuple[float, ...]) -> torch.Tensor:
    out = torch.full(core_idx.shape, table[0], dtype=torch.float32,
                     device=core_idx.device)
    for i, v in enumerate(table[1:], start=1):
        out = torch.where(core_idx == float(i), v, out)
    return out


def _layer_cost(d: dict[str, torch.Tensor], M, K, N, reps, kind):
    """Cycles / DRAM bytes / on-chip stream bytes / host commands for one
    (design, layer) pair; all inputs broadcastable."""
    R, C = d["R"], d["C"]
    ib, ob = d["ib"], d["ob"]
    ceil = lambda a, b: torch.ceil(a / b)

    is_act_b = (kind == 1.0)  # B operand is an activation (attention)
    # ---------------- WS dataflow ----------------
    Mb = torch.minimum(M, d["acc_rows"])          # output rows resident in acc
    Kt, Nt, Mt = ceil(K, R), ceil(N, C), ceil(M, Mb)
    compute_ws = reps * (Kt * Nt * (Mt * Mb + R) + Nt * C)
    w_fits = (K * N * ib) <= 0.5 * d["spad_bytes"]
    a_fits = (Mb * K * ib) <= 0.5 * d["spad_bytes"]
    w_dma_ws = K * N * ib * torch.where(w_fits, 1.0, Mt)
    a_dma_ws = M * K * ib * torch.where(a_fits, 1.0, Nt)
    dram_ws = reps * (w_dma_ws + a_dma_ws + M * N * ob)
    stream_ws = reps * (Kt * Nt * Mt * (Mb * R * ib + R * C * ib) + M * N * ob)

    # ---------------- OS dataflow ----------------
    Mt2, Nt2 = ceil(M, R), ceil(N, C)
    compute_os = reps * (Mt2 * Nt2 * (K + R + C))
    w_dma_os = K * N * ib * torch.where(w_fits, 1.0, Mt2)
    a_fits2 = (M * K * ib) <= 0.5 * d["spad_bytes"]
    a_dma_os = M * K * ib * torch.where(a_fits2, 1.0, Nt2)
    dram_os = reps * (w_dma_os + a_dma_os + M * N * ob)
    stream_os = reps * (Mt2 * Nt2 * K * (R + C) * ib + M * N * ob)

    # ---------------- dataflow select ----------------
    df = d["dataflow"]
    use_os = torch.where(df == 2.0, compute_os < compute_ws, df == 1.0)
    compute = torch.where(use_os, compute_os, compute_ws)
    dram = torch.where(use_os, dram_os, dram_ws)
    stream = torch.where(use_os, stream_os, stream_ws)
    n_tiles = torch.where(use_os, Mt2 * Nt2, Mt * Kt * Nt) * reps
    # attention: "weights" are activations — same traffic, no resident reuse
    dram = torch.where(is_act_b, dram + 0.15 * K * N * ib * reps, dram)

    macs = reps * M * K * N
    return dict(compute=compute, dram=dram, stream=stream,
                n_tiles=n_tiles, macs=macs)


def metrics_tile(vals: torch.Tensor, layers: torch.Tensor,
                 layer_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Evaluate designs ``vals`` [n, 26] on ``layers`` [L, 5] (float32).

    Returns [n, 3]: latency_ms, power_mw, area_mm2. The plain version of the
    ``systolic_eval`` kernel: every (design, layer) intermediate is an
    [n, L] tensor. ``layer_mask`` [L] (1.0 on real layers) silences padded
    layer rows as the reference's masked ``_metrics_tile`` does; None keeps
    the single-workload computation."""
    d = decode_design(vals)
    M, K, N, reps, kind = (layers[:, i] for i in range(5))
    dd = {k: v[:, None] for k, v in d.items()}
    c = _layer_cost(dd, M[None, :], K[None, :], N[None, :],
                    reps[None, :], kind[None, :])
    if layer_mask is None:
        n_layers = layers.shape[0]
    else:
        # pad rows carry reps = 0, so their traffic and MAC terms are 0
        # already; the mask silences the per-layer launch constants and
        # keeps the mean working set's denominator the real layer count
        c = {k: v * layer_mask[None, :] for k, v in c.items()}
        n_layers = torch.clamp_min(torch.sum(layer_mask), 1.0)

    # ----- memory bandwidth (bytes / cycle), per design -----
    working = torch.sum(c["dram"], dim=1)  # total DRAM traffic per design
    l2_hit = torch.clamp(3.0 * d["l2_bytes"] / (working / n_layers + 1.0),
                         0.0, 0.85) * (1.0 + 0.05 * torch.log2(d["l2_way"] / 4.0))
    mem_lat = l2_hit * CONST["l2_hit_lat"] + (1.0 - l2_hit) * CONST["dram_lat"]
    eff = d["dmabytes"] / (d["dmabytes"] + CONST["dma_fixed_overhead"])
    bw = torch.minimum(d["dmabus"] / 8.0,
                       d["memreq"] * d["dmabytes"] / mem_lat) * eff  # B/cyc

    # TLB reach: pages touched per layer vs TLB entries.
    pages = c["dram"] / CONST["page_bytes"]
    tlb_miss = torch.clamp_min(pages - d["tlb"][:, None] * 8.0, 0.0)
    dma_cycles = c["dram"] / bw[:, None] + tlb_miss * CONST["tlb_miss_cost"]

    # ----- host / RoCC control -----
    issue = _select(d["core"], CONST["core_issue"])[:, None]
    q_eff = torch.minimum(torch.minimum(d["ldq"], d["ldr"]),
                          torch.minimum(d["exq"], d["exr"]))[:, None]
    cmds = 4.0 * c["n_tiles"] + CONST["layer_launch_cmds"]
    host_cycles = cmds * issue * (1.0 + 2.0 / q_eff)
    if layer_mask is not None:  # no launch commands for padded layers
        host_cycles = host_cycles * layer_mask[None, :]

    # ----- overlap: double-buffered spad/acc overlaps DMA with compute -----
    three = torch.stack([c["compute"], dma_cycles, host_cycles], dim=-1)
    hi = torch.amax(three, dim=-1)
    rest = torch.sum(three, dim=-1) - hi
    buf = torch.clamp((d["spad_banks"][:, None] - 4.0) / 12.0, 0.0, 1.0) * 0.8 \
        + torch.clamp((d["acc_banks"][:, None] - 1.0) / 7.0, 0.0, 1.0) * 0.2
    layer_cycles = hi + (1.0 - buf) * 0.5 * rest + 400.0 * issue
    if layer_mask is not None:
        layer_cycles = layer_cycles * layer_mask[None, :]

    cycles = torch.sum(layer_cycles, dim=1)
    latency_ms = cycles / CONST["freq_hz"] * 1e3

    # ----- energy / power -----
    e_mac = CONST["e_mac8"] * d["ib"] ** 1.7  # pJ
    pj = (torch.sum(c["macs"], dim=1) * e_mac
          + torch.sum(c["stream"], dim=1) * CONST["e_spad_byte"]
          + torch.sum(c["dram"], dim=1) * CONST["e_dram_byte"])
    host_total = torch.sum(host_cycles, dim=1)
    nj = pj * 1e-3 + host_total * _select(d["core"], CONST["core_energy"])
    area = _area(d)
    power_mw = (nj * 1e-9) / (cycles / CONST["freq_hz"]) * 1e3 \
        + CONST["base_mw"] + CONST["leak_mw_per_mm2"] * area
    return torch.stack([latency_ms, power_mw, area], dim=1)


def metrics_multi(vals: torch.Tensor, layers: torch.Tensor,
                  layer_mask: torch.Tensor) -> torch.Tensor:
    """W workloads at once: ``vals`` [W, n, 26] against ``layers``
    [W, Lmax, 5] (padded with ``soc.workloads.pad_workloads``) under
    ``layer_mask`` [W, Lmax] -> [W, n, 3]; workload w is
    ``metrics_tile(vals[w], layers[w], layer_mask[w])``."""
    return torch.stack([metrics_tile(v, l, mk)
                        for v, l, mk in zip(vals, layers, layer_mask)])


def soc_metrics_multi(vals: torch.Tensor, layers: torch.Tensor,
                      layer_mask: torch.Tensor) -> torch.Tensor:
    """The reference's ``soc_metrics_multi``: :func:`metrics_multi` on CPU
    tensors, one launch of the ``systolic_eval`` kernel's multi-workload
    entry on CUDA tensors (``kernels.systolic_eval.soc_metrics_multi``,
    imported here at call time: that module imports this one)."""
    from repro_torch.kernels import systolic_eval

    return systolic_eval.soc_metrics_multi(vals, layers, layer_mask)


def _area_parts(d: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Component areas (mm², each [n]) before the NoC overhead."""
    pe = CONST["a_pe8"] * d["ib"] ** 1.25 * (1.0 + 0.25 * d["ab"] / 4.0)
    arr = d["R"] * d["C"] * pe
    arr = arr * torch.where(d["dataflow"] == 2.0, 1.12,
                            torch.where(d["dataflow"] == 1.0, 1.05, 1.0))
    mb = 1.0 / (1024.0 * 1024.0)
    return {
        "systolic_array": arr,
        "scratchpad": d["spad_bytes"] * mb * CONST["a_sram_mb"],
        "accumulator": d["acc_bytes"] * mb * CONST["a_acc_sram_mb"],
        "l2_cache": d["l2_bytes"] * mb * CONST["a_l2_mb"]
        * (1.0 + 0.02 * torch.log2(d["l2_way"] / 4.0)),
        "host_core": _select(d["core"], CONST["core_area"]),
        "ctrl_queues": (d["ldq"] + d["stq"] + d["exq"] + d["ldr"] + d["str_"]
                        + d["exr"]) * CONST["a_queue_entry"],
        "dma_tlb": d["dmabus"] / 8.0 * CONST["a_dma_per_byte_lane"]
        + d["tlb"] * CONST["a_tlb_entry"],
    }


def _area(d: dict[str, torch.Tensor]) -> torch.Tensor:
    p = _area_parts(d)
    sram = p["scratchpad"] + p["accumulator"] + p["l2_cache"]
    return (p["systolic_array"] + sram + p["ctrl_queues"] + p["dma_tlb"]
            + p["host_core"]) * CONST["noc_overhead"]


def area_breakdown(vals) -> dict[str, np.ndarray]:
    """Component-wise area (mm², float32 [n] each) of designs ``vals``
    [n, 26] for Fig. 7(b), computed on ``vals``' device; the components
    times ``CONST["noc_overhead"]`` sum to the model's area."""
    vals = torch.as_tensor(vals, dtype=torch.float32)
    return {k: v.cpu().numpy()
            for k, v in _area_parts(decode_design(vals)).items()}

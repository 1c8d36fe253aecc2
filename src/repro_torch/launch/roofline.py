"""Roofline terms of a dry-run record on an NVIDIA H100 SXM
(``benchmarks/roofline.py``'s ``terms``, with the card's published peaks).

Each constant is NVIDIA's data-sheet figure for the H100 SXM at its full
700 W power limit; a card set below it runs slower under load. These are
bounds from the dry run's per-device counts, not measurements.
"""
from __future__ import annotations

from repro_torch.configs import SHAPES, get_config

__all__ = ["H100_SXM_BF16_FLOPS", "H100_SXM_HBM3_BYTES_S",
           "H100_SXM_NVLINK_ONE_WAY_BYTES_S", "model_flops", "terms"]

#: dense bf16 tensor-core peak, H100 SXM at 700 W
H100_SXM_BF16_FLOPS = 989e12
#: HBM3 bandwidth, H100 SXM
H100_SXM_HBM3_BYTES_S = 3.35e12
#: NVLink 4 of one H100 SXM: 900 GB/s both ways over its 18 links, so
#: 450 GB/s each way (the collective term's link)
H100_SXM_NVLINK_ONE_WAY_BYTES_S = 450e9


def model_flops(arch: str, shape_name: str) -> float:
    """6·N·D (active parameters x tokens) for a train step, 2·N·D for a
    prefill, 2·N·B for a decode step."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.n_active_params()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch


def terms(rec: dict) -> dict:
    """The three roofline terms (seconds a step, per device) of a dry-run
    record: its dot flops over the bf16 peak, its dot bytes over HBM3, its
    collective bytes over one NVLink direction; the bottleneck and the
    share of the bf16 peak the model's own flops would reach if the
    largest term set the step time."""
    t_comp = rec["dot_flops"] / H100_SXM_BF16_FLOPS
    t_mem = rec["dot_bytes"] / H100_SXM_HBM3_BYTES_S
    t_coll = rec["collective_total"] / H100_SXM_NVLINK_ONE_WAY_BYTES_S
    dom = max(("compute", t_comp), ("memory", t_mem),
              ("collective", t_coll), key=lambda kv: kv[1])
    mf = model_flops(rec["arch"], rec["shape"]) / rec["devices"]
    step = max(t_comp, t_mem, t_coll)
    return {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
            "bottleneck": dom[0], "model_flops_per_device": mf,
            "useful_ratio": mf / max(rec["dot_flops"], 1.0),
            "roofline_frac": mf / max(step, 1e-12) / H100_SXM_BF16_FLOPS}

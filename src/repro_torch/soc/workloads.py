"""DNN workloads lowered to systolic-array layer lists.

A workload is an array [L, 5] of (M, K, N, reps, kind) GEMMs (convolutions
are im2col'd):
  kind 0 — weights stream from DRAM (conv / linear)
  kind 1 — both operands are activations (attention score / AV)
  kind 2 — depthwise-style: ``reps`` tiny GEMMs (poor array utilization)

The paper's benchmarks (§IV-A): ResNet-50, MobileNet(V1), Transformer (6
decoder blocks). A copy of ``repro.soc.workloads``; the LM-architecture
workloads are not ported yet.
"""
from __future__ import annotations

import numpy as np

__all__ = ["WORKLOADS", "get_workload", "resnet50", "mobilenet", "transformer"]


def _l(M, K, N, reps=1, kind=0):
    return [float(M), float(K), float(N), float(reps), float(kind)]


def resnet50() -> np.ndarray:
    L = [_l(112 * 112, 3 * 49, 64)]  # conv1 7x7/2
    c_in = 64
    stages = [(64, 256, 3, 56), (128, 512, 4, 28), (256, 1024, 6, 14),
              (512, 2048, 3, 7)]
    for c_mid, c_out, blocks, out_hw in stages:
        for b in range(blocks):
            m = out_hw * out_hw
            L.append(_l(m, c_in if b == 0 else c_out, c_mid))      # 1x1 reduce
            L.append(_l(m, 9 * c_mid, c_mid))                      # 3x3
            L.append(_l(m, c_mid, c_out))                          # 1x1 expand
            if b == 0:
                L.append(_l(m, c_in, c_out))                       # shortcut 1x1
        c_in = c_out
    L.append(_l(1, 2048, 1000))  # fc
    return np.asarray(L, np.float64)


def mobilenet() -> np.ndarray:
    L = [_l(112 * 112, 27, 32)]  # conv 3x3/2
    # (channels_in, channels_out, stride) for the 13 dw/pw pairs
    plan = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
            (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 \
        + [(512, 1024, 2), (1024, 1024, 1)]
    hw = 112
    for cin, cout, s in plan:
        hw = hw // s
        L.append(_l(hw * hw, 9, 1, reps=cin, kind=2))  # depthwise 3x3
        L.append(_l(hw * hw, cin, cout))               # pointwise 1x1
    L.append(_l(1, 1024, 1000))
    return np.asarray(L, np.float64)


def transformer(seq: int = 128, d: int = 512, heads: int = 8,
                ffn: int = 2048, blocks: int = 6) -> np.ndarray:
    hd = d // heads
    L = []
    for _ in range(blocks):
        L.append(_l(seq, d, 3 * d))                      # QKV
        L.append(_l(seq, hd, seq, reps=heads, kind=1))   # scores
        L.append(_l(seq, seq, hd, reps=heads, kind=1))   # AV
        L.append(_l(seq, d, d))                          # out proj
        L.append(_l(seq, d, ffn))                        # FFN up
        L.append(_l(seq, ffn, d))                        # FFN down
    return np.asarray(L, np.float64)


WORKLOADS = {
    "resnet50": resnet50,
    "mobilenet": mobilenet,
    "transformer": transformer,
}


def get_workload(name: str) -> np.ndarray:
    if name in WORKLOADS:
        return WORKLOADS[name]()
    raise KeyError(
        f"workload {name!r} is not yet ported to repro_torch (DNN workloads: "
        f"{tuple(WORKLOADS)}; LM-architecture workloads wait for the "
        "configs port, ROADMAP queue 1)")

"""The "simplified analytical model" baseline ([6], SCALE-Sim-like).

Per-layer systolic cycles at perfect utilization, with no memory, host or
control modelling: the class of tool the paper shows produces misleading
Pareto fronts (Fig. 4(c)). Plain PyTorch on the tensors' device, as the
reference's is a plain ``jax.jit`` function (no Pallas kernel); the math of
``repro.soc.simplified``.
"""
from __future__ import annotations

import torch

from .model import CONST, decode_design

__all__ = ["simplified_metrics"]


def simplified_metrics(vals: torch.Tensor, layers: torch.Tensor) -> torch.Tensor:
    """Designs ``vals`` [n, 26] on ``layers`` [L, 5] -> [n, 3] float32
    (latency ms, power mW, area mm²)."""
    vals = torch.as_tensor(vals, dtype=torch.float32)
    layers = torch.as_tensor(layers, dtype=torch.float32)
    d = decode_design(vals)
    M, K, N, reps, _ = (layers[:, i] for i in range(5))
    R, C = d["R"][:, None], d["C"][:, None]
    # SCALE-Sim's WS estimate: (2R + C + K - 2) per (M/R x N/C) fold, ideal.
    folds = torch.ceil(M[None] / R) * torch.ceil(N[None] / C)
    cycles = torch.sum(folds * (2.0 * R + C + K[None] - 2.0) * reps[None], dim=1)
    latency_ms = cycles / CONST["freq_hz"] * 1e3
    macs = torch.sum(M * K * N * reps)
    e_mac = CONST["e_mac8"] * d["ib"] ** 1.7
    power_mw = (macs * e_mac * 1e-12) / (cycles / CONST["freq_hz"]) * 1e3
    pe = CONST["a_pe8"] * d["ib"] ** 1.25
    mb = 1.0 / (1024.0 * 1024.0)
    area = d["R"] * d["C"] * pe + d["spad_bytes"] * mb * CONST["a_sram_mb"] \
        + d["acc_bytes"] * mb * CONST["a_acc_sram_mb"]
    return torch.stack([latency_ms, power_mw, area], dim=1)

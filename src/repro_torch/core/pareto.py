"""Pareto-set machinery (paper Definitions 2-3, Eq. 12).

Convention: **all objectives are minimized** (latency, power, area).
Dominance is compared in float32 on the tensor's device, like the reference
(``repro.core.tuner._front`` hands float64 to JAX with x64 off, so its
fronts are float32 fronts); ADRS is float64 numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import pareto_count as _pareto_count

__all__ = ["dominance_counts", "pareto_mask", "pareto_front", "adrs"]


def dominance_counts(y: torch.Tensor) -> torch.Tensor:
    """Number of rows that strictly dominate each row of ``y`` [N, m]
    (int32 [N]); the ``pareto_count`` kernel on a CUDA tensor."""
    return _pareto_count.dominance_counts(y)


def pareto_mask(y: torch.Tensor) -> torch.Tensor:
    """Boolean mask [N] of non-dominated rows (the Pareto optimal set)."""
    return dominance_counts(y) == 0


def pareto_front(y: np.ndarray, device=None) -> np.ndarray:
    """Rows of ``y`` forming the Pareto front, sorted by the first objective.
    Dominance is decided in float32 on ``device`` (default ``cuda``)."""
    y = np.asarray(y)
    yt = torch.as_tensor(y, dtype=torch.float32,
                         device=resolve_device(device)).contiguous()
    mask = pareto_mask(yt).cpu().numpy()
    front = y[mask]
    return front[np.argsort(front[:, 0])]


def adrs(reference: np.ndarray, learned: np.ndarray,
         normalizer: np.ndarray | None = None) -> float:
    """Average Distance to Reference Set (Eq. 12).

    ``ADRS(Γ, Ω) = (1/|Γ|) Σ_{γ∈Γ} min_{ω∈Ω} ||γ - ω||₂`` over metrics
    scale-normalized by the per-dimension range of Γ.
    """
    ref = np.asarray(reference, dtype=np.float64)
    lrn = np.asarray(learned, dtype=np.float64)
    if ref.size == 0 or lrn.size == 0:
        return float("inf")
    if normalizer is None:
        normalizer = np.maximum(ref.max(axis=0) - ref.min(axis=0), 1e-12)
    ref = ref / normalizer
    lrn = lrn / normalizer
    d = np.linalg.norm(ref[:, None, :] - lrn[None, :, :], axis=-1)
    return float(d.min(axis=1).mean())

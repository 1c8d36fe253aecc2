"""Pareto-set machinery (paper Definitions 2-3, Eq. 12).

Convention: **all objectives are minimized** (latency, power, area).
Dominance is compared in float32 on the tensor's device, like the reference
(``repro.core.tuner._front`` hands float64 to JAX with x64 off, so its
fronts are float32 fronts); ADRS, the hypervolume sweeps and the
nondominated sort's bookkeeping are float64 numpy on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import pareto_count as _pareto_count

__all__ = ["dominance_counts", "pareto_mask", "pareto_front", "adrs",
           "hypervolume", "nondominated_sort"]


def dominance_counts(y: torch.Tensor) -> torch.Tensor:
    """Number of rows that strictly dominate each row of ``y`` [N, m]
    (int32 [N]); the ``pareto_count`` kernel on a CUDA tensor."""
    return _pareto_count.dominance_counts(y)


def pareto_mask(y: torch.Tensor) -> torch.Tensor:
    """Boolean mask [N] of non-dominated rows (the Pareto optimal set)."""
    return dominance_counts(y) == 0


def front_mask(y: np.ndarray, dev: torch.device) -> np.ndarray:
    """:func:`pareto_mask` of host rows ``y``, decided in float32 on
    ``dev``, as a numpy bool array."""
    yt = torch.as_tensor(y, dtype=torch.float32, device=dev).contiguous()
    return pareto_mask(yt).cpu().numpy()


def pareto_front(y: np.ndarray, device=None) -> np.ndarray:
    """Rows of ``y`` forming the Pareto front, sorted by the first objective.
    Dominance is decided in float32 on ``device`` (default ``cuda``)."""
    y = np.asarray(y)
    front = y[front_mask(y, resolve_device(device))]
    return front[np.argsort(front[:, 0])]


def nondominated_sort(y: np.ndarray, max_fronts: int = 32,
                      device=None) -> np.ndarray:
    """NSGA-style front index per row of ``y`` (0 = the Pareto front); rows
    beyond ``max_fronts`` fronts get ``max_fronts``. One dominance count a
    front, in float32 on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    y = np.asarray(y)
    rank = np.full(y.shape[0], -1, dtype=np.int32)
    remaining = np.arange(y.shape[0])
    for r in range(max_fronts):
        if remaining.size == 0:
            break
        mask = front_mask(y[remaining], dev)
        rank[remaining[mask]] = r
        remaining = remaining[~mask]
    rank[rank < 0] = max_fronts
    return rank


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


def hypervolume(front: np.ndarray, ref_point: np.ndarray,
                device=None) -> float:
    """Dominated hypervolume for minimization, exact for m <= 3 (sweeps in
    float64 on the host); points beyond ``ref_point`` are clipped out. Each
    sweep's front is one dominance count in float32 on ``device`` (default
    ``cuda``); m = 3 sweeps z-levels over m = 2 slabs."""
    return _hypervolume(front, ref_point, resolve_device(device))


def _hypervolume(front, ref_point, dev: torch.device) -> float:
    f = np.asarray(front, dtype=np.float64)
    r = np.asarray(ref_point, dtype=np.float64)
    f = f[np.all(f <= r, axis=1)]
    if f.size == 0:
        return 0.0
    m = f.shape[1]
    if m == 1:
        return float(r[0] - f[:, 0].min())
    if m == 2:
        p = f[front_mask(f, dev)]
        p = p[np.argsort(p[:, 0])]
        hv, prev_y = 0.0, r[1]
        for x, y in p:
            hv += (r[0] - x) * (prev_y - y)
            prev_y = y
        return float(hv)
    if m == 3:
        # sweep over sorted z; the 2D hypervolume of the slab between levels
        p = f[front_mask(f, dev)]
        p = p[np.argsort(p[:, 2])]
        hv = 0.0
        zs = list(p[:, 2]) + [r[2]]
        active: list[np.ndarray] = []
        for i in range(len(p)):
            active.append(p[i, :2])
            dz = zs[i + 1] - zs[i]
            if dz <= 0:
                continue
            hv += _hypervolume(np.asarray(active), r[:2], dev) * dz
        return float(hv)
    raise NotImplementedError("hypervolume only implemented for m<=3")

"""Algorithm 1 — ICD(X, n): Inter-Cluster-Distance feature importance.

A few (``n``) designs are pushed through the evaluation flow; for each feature
the metric vectors are clustered by the feature's candidate value, and the
importance is the mean pairwise L2 distance between cluster centroids
(line 9), normalized at the end. Float64 numpy, a copy of ``repro.core.icd``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .space import DesignSpace

__all__ = ["icd", "icd_from_data"]


def icd_from_data(space: DesignSpace, idx: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Importance vector ``v`` [d] from already-evaluated (idx, y) pairs.

    ``y`` is z-score normalized per metric first so that latency and area
    contribute comparably to the centroid distances.
    """
    idx = np.asarray(idx)
    y = np.asarray(y, dtype=np.float64)
    mu, sd = y.mean(axis=0), y.std(axis=0) + 1e-12
    yn = (y - mu) / sd
    v = np.zeros(space.d, dtype=np.float64)
    for i, f in enumerate(space.features):
        centroids = []
        for j in range(f.t):  # cluster Y' by candidate j of feature i (line 4)
            sel = idx[:, i] == j
            if sel.sum() == 0:
                continue  # candidate unseen in the n trials: no centroid
            centroids.append(yn[sel].mean(axis=0))  # lines 5-8
        k = len(centroids)
        if k < 2:
            v[i] = 0.0
            continue
        M = np.asarray(centroids)
        d = np.linalg.norm(M[:, None, :] - M[None, :, :], axis=-1)
        v[i] = d[np.triu_indices(k, 1)].sum() / (k * (k - 1) / 2)  # line 9
    # line 12, normalize(v): L2 (see repro.core.icd for why not the sum)
    s = np.linalg.norm(v)
    return (v / s if s > 0 else np.full_like(v, 1.0 / np.sqrt(space.d)))


def icd(space: DesignSpace, flow: Callable[[np.ndarray], np.ndarray], n: int,
        draws) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full Algorithm 1: draw ``n`` designs (``draws.designs``, a
    :class:`repro_torch.random.TunerDraws`), evaluate them, return
    ``(v, idx, y)``; the trial evaluations come back so a caller can reuse
    them."""
    idx = np.asarray(draws.designs(space, n))  # line 1: Sample(X, n)
    y = np.asarray(flow(idx))  # line 1: VLSIFlow(...)
    return icd_from_data(space, idx, y), idx, y

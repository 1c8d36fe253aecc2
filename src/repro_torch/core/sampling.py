"""Algorithm 2 — SoC-Init(X, u, b, v, v_th): importance-guided TED init.

Line 1 prunes (pins) unimportant features; line 2 maps the candidate pool to
ICD space ``x' = v ⊙ x``; lines 3-8 run Transductive Experimental Design
greedily over a Gaussian kernel with a median-heuristic bandwidth: pick the
point whose kernel column has the largest energy, then deflate the kernel
with the rank-1 downdate. A port of ``repro.core.sampling``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import pairdist as _pairdist

from .space import DesignSpace

__all__ = ["soc_init", "ted_select", "transform_to_icd", "median_bandwidth",
           "pairwise_sqdist", "TED_MAX_POOL", "TED_CAP_STATS", "fold_ted_stats"]

#: Default TED candidate cap: the greedy loop is O(b·N²) time and O(N²)
#: memory. Above the cap, ``ted_select`` runs on an even-stride subsample and
#: maps the selection back; pools at or below it take the full path.
TED_MAX_POOL = 4096

#: Host-side cap accounting: every capped ``ted_select`` call bumps
#: ``capped_calls`` and adds the candidates the stride dropped to
#: ``dropped_candidates``. Reset by assigning zeros.
TED_CAP_STATS = {"capped_calls": 0, "dropped_candidates": 0}


def fold_ted_stats(registry) -> None:
    """Fold the (cumulative) TED cap counters into a
    :class:`repro_torch.obs.MetricsRegistry` (duck-typed). Fold once per
    finished run, like ``EngineStats``."""
    if TED_CAP_STATS["capped_calls"]:
        registry.counter(
            "ted_capped_calls_total",
            "ted_select calls that ran on the even-stride subsample",
        ).inc(TED_CAP_STATS["capped_calls"])
        registry.counter(
            "ted_dropped_candidates_total",
            "candidates excluded from TED by the max_pool stride cap",
        ).inc(TED_CAP_STATS["dropped_candidates"])


def transform_to_icd(space: DesignSpace, idx: torch.Tensor,
                     v: np.ndarray) -> torch.Tensor:
    """Line 2: X' = { v ⊙ x } over normalized features, ``v`` rescaled so
    max(v) = 1. Returns float32 on ``idx``'s device."""
    v = np.asarray(v, dtype=np.float32)
    v = v / max(v.max(), 1e-12)
    x = space.encode(idx)
    return x * torch.as_tensor(v, device=x.device)[None, :]


def _median_bandwidth_from_sqdist(d2: torch.Tensor) -> float:
    """sqrt of the median upper-triangle squared distance. ``jnp.median``
    averages the two middle values of an even count (``torch.median`` would
    return the lower one), so this sorts and takes the midpoint."""
    n = d2.shape[0]
    if n > 1:
        iu = torch.triu_indices(n, n, 1, device=d2.device)
        off = d2[iu[0], iu[1]]
    else:
        off = d2.reshape(-1)
    srt = torch.sort(off).values
    k = off.numel()
    med = (srt[(k - 1) // 2] + srt[k // 2]) * 0.5
    return float(torch.sqrt(torch.clamp_min(med, 1e-12)))


def median_bandwidth(x: torch.Tensor) -> float:
    """Median pairwise distance heuristic for the TED kernel bandwidth."""
    return _median_bandwidth_from_sqdist(pairwise_sqdist(x, x))


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """‖a_i − b_j‖² [N, M] (the ``pairdist`` kernel on CUDA tensors)."""
    return _pairdist.pairdist(a, b)


def _ted_loop(K: torch.Tensor, b: int, mu: float) -> np.ndarray:
    """Greedy TED: lines 4-8 of Algorithm 2. Argmax ties go to the first
    index; chosen rows are masked to -inf. ``K`` is deflated in place."""
    n = K.shape[0]
    taken = torch.zeros(n, dtype=torch.bool, device=K.device)
    chosen = torch.empty(b, dtype=torch.int64, device=K.device)
    neg_inf = torch.tensor(float("-inf"), device=K.device)
    for step in range(b):
        norm = torch.sum(K * K, dim=0)  # ||K_x||² (column energy)
        score = norm / (torch.diagonal(K) + mu)  # line 5
        score = torch.where(taken, neg_inf, score)
        z = torch.argmax(score)
        Kz = K[:, z].clone()
        K -= torch.outer(Kz, Kz) / (K[z, z] + mu)  # line 7 downdate
        taken[z] = True
        chosen[step] = z
    return chosen.cpu().numpy()


def ted_select(x: torch.Tensor, b: int, mu: float = 0.1,
               bandwidth: float | None = None,
               max_pool: int | None = TED_MAX_POOL) -> np.ndarray:
    """Select ``b`` maximally informative rows of ``x`` [N, d] (TED).

    ``bandwidth`` defaults to the median heuristic. ``max_pool`` caps the
    O(N²) greedy loop: above it, selection runs on an even-stride subsample
    of ``max_pool`` rows and the chosen indices are mapped back to the full
    pool. ``max_pool=None`` opts out; the [N, N] kernel matrix is then one
    ``pairdist`` call at any N, as on the reference's kernel path.
    """
    N = x.shape[0]
    if max_pool is not None and N > max_pool:
        dropped = int(N) - int(max_pool)
        TED_CAP_STATS["capped_calls"] += 1
        TED_CAP_STATS["dropped_candidates"] += dropped
        warnings.warn(
            f"ted_select: pool of {N} exceeds max_pool={max_pool}; TED init "
            f"runs on an even-stride subsample, dropping {dropped} "
            "candidates from consideration (selection differs from the "
            "uncapped O(N²) run — pass max_pool=None to opt out)",
            stacklevel=2)
        sel = (np.arange(max_pool, dtype=np.int64) * N) // max_pool
        rows = ted_select(x[torch.as_tensor(sel, device=x.device)].contiguous(),
                          b, mu, bandwidth=bandwidth, max_pool=None)
        return np.asarray(sel[rows])
    d2 = pairwise_sqdist(x, x)
    if bandwidth is None:
        bandwidth = _median_bandwidth_from_sqdist(d2)  # median heuristic
    K = torch.exp(-d2 / (2.0 * bandwidth**2 + 1e-12))
    return _ted_loop(K, b, float(mu))


def soc_init(space: DesignSpace, pool_idx: np.ndarray, v: np.ndarray,
             v_th: float, b: int, mu: float = 0.1,
             ted_pool: int | None = TED_MAX_POOL,
             device=None) -> tuple[np.ndarray, DesignSpace, torch.Tensor]:
    """Full Algorithm 2 over a candidate pool.

    Returns ``(init_rows, pruned_space, pool_icd)``: ``init_rows`` indexes
    ``pool_idx``, ``pool_icd`` [N, d] float32 (on ``device``, default
    ``cuda``) is the whole pool in ICD space, reused as the GP features.
    ``ted_pool`` caps the TED selection (see :func:`ted_select`).
    """
    pruned = space.prune(np.asarray(v), v_th)  # line 1
    pool = torch.tensor(np.asarray(pool_idx), device=resolve_device(device))
    pool_icd = transform_to_icd(space, pruned.apply_pins(pool), v)  # line 2
    rows = ted_select(pool_icd, b=b, mu=mu, max_pool=ted_pool)  # lines 3-8
    return rows, pruned, pool_icd

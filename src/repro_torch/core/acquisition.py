"""IMOO — information-gain multi-objective acquisition (paper Eqs. 5-11).

Monte-Carlo over S sampled Pareto frontiers Y*_s, each objective treated as
a truncated Gaussian bounded by the frontier maximum (the MES closed form of
Eq. 8):

    AF(i, x') = Σ_s [ γ_s^i(x')·φ(γ_s^i) / (2·Φ(γ_s^i)) − ln Φ(γ_s^i) ]
    γ_s^i(x') = (y*_{s,i} − µ_i(x')) / σ_i(x')
    I(x')     = Σ_i AF(i, x')

Objectives are NEGATED by the caller (MES maximizes). A port of
``repro.core.acquisition``.
"""
from __future__ import annotations

import math

import torch

from .gp import GPState, gp_joint_samples, gp_predict, take

__all__ = ["frontier_maxima", "mes_information_gain", "imoo_scores",
           "imoo_scores_batch"]


def frontier_maxima(state: GPState, cand: torch.Tensor,
                    eps: torch.Tensor) -> torch.Tensor:
    """Per-objective maxima y*_s [S, m] of S joint posterior draws over
    ``cand`` (the MESMO reduction: the per-objective maximum over a sampled
    Pareto set equals the maximum over the whole sample)."""
    return torch.amax(gp_joint_samples(state, cand, eps), dim=1)


def _norm_pdf(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.stats.norm.pdf``'s form: exp((log 2π + x²) / −2)."""
    log_norm = torch.log(torch.tensor(2 * math.pi, dtype=x.dtype,
                                      device=x.device))
    return torch.exp((log_norm + x * x) / -2.0)


def _ndtr(x: torch.Tensor) -> torch.Tensor:
    """Φ(x) in ``jax.scipy.special.ndtr``'s form: ``1 + erf`` near 0 and
    ``erfc`` in the tails. ``torch.special.ndtr`` in float32 loses the lower
    tail (it returns 0 at x = -5.4, where Φ = 2.8e-8), which moves the 1e-9
    clip below and with it the scores."""
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    w = x * half_sqrt_2
    z = torch.abs(w)
    y = torch.where(z < half_sqrt_2, 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def mes_information_gain(mean: torch.Tensor, std: torch.Tensor,
                         ystar: torch.Tensor,
                         weights: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. (8)+(9): I(x') [q] from posterior (mean, std) [q, m] and y* [S, m];
    ``weights`` [m] scalarizes the per-objective gain (None = uniform)."""
    gamma = (ystar[:, None, :] - mean[None, :, :]) / std[None, :, :]  # [S,q,m]
    pdf = _norm_pdf(gamma)
    cdf = torch.clamp(_ndtr(gamma), 1e-9, 1.0)
    af = gamma * pdf / (2.0 * cdf) - torch.log(cdf)
    per_obj = torch.mean(af, dim=0)  # (1/S) Σ_s — Eq. (7)
    if weights is not None:
        per_obj = per_obj * weights[None, :]
    return torch.sum(per_obj, dim=-1)  # Σ_i — Eq. (9)


def imoo_scores(state: GPState, cand: torch.Tensor, eps: torch.Tensor,
                frontier_cand: torch.Tensor | None = None,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """Acquisition score for every candidate row (maximization convention).

    ``frontier_cand`` (default: ``cand``) is the subset used for the O(q³)
    joint frontier sampling; ``eps`` [m, q, S] are its standard normals."""
    fc = cand if frontier_cand is None else frontier_cand
    ystar = frontier_maxima(state, fc, eps)
    mean, std = gp_predict(state, cand)
    return mes_information_gain(mean, std, ystar, weights)


def imoo_scores_batch(states: GPState, cand: torch.Tensor, eps: torch.Tensor,
                      frontier_cand: torch.Tensor | None = None,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """IMOO scores of S scenarios -> [S, N]: scenario i is
    :func:`imoo_scores` of ``take(states, i)`` (a batched state from
    ``fit_gp_batch``) over ``cand[i]``, with its frontier subset
    ``frontier_cand[i]`` (default ``cand[i]``), its normals ``eps[i]``
    (``eps`` [S, m, q, s]) and its weights ``weights[i]`` (``weights`` [S, m],
    or None for uniform weights)."""
    return torch.stack([
        imoo_scores(take(states, i), cand[i], eps[i],
                    frontier_cand=None if frontier_cand is None
                    else frontier_cand[i],
                    weights=None if weights is None else weights[i])
        for i in range(cand.shape[0])])

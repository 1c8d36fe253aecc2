"""Gaussian-process surrogates (paper Eqs. 3-4).

One independent GP per objective, the objectives a batch dimension;
hyperparameters θ = (ARD log-lengthscales, log-variance, log-noise) are fit
by maximizing the exact marginal likelihood with Adam (Alg. 3 line 9). A
port of ``repro.core.gp``: the same padding, standardization, priors, Adam
schedule and clamps, with Adam written out so it rounds like the reference.

Only inference kernel matrices go through the ``pairdist`` kernel; the NLL
gradient path stays on differentiable PyTorch ops.

:func:`fit_gp_batch` fits S scenarios at once by folding the scenario axis
into the objective axis that ``_nll`` already batches: one Adam step for S
scenarios launches what one step for one scenario launches.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import pairdist as _pairdist

__all__ = ["GPParams", "GPState", "fit_gp", "fit_gp_batch", "pad_training",
           "gp_predict", "gp_joint_samples", "default_params", "JITTER",
           "PAD_BUCKET"]

JITTER = 1e-5
#: padding granularity of the growing training set
PAD_BUCKET = 8


class GPParams(NamedTuple):
    log_ls: torch.Tensor     # [m, d] ARD log-lengthscales
    log_var: torch.Tensor    # [m] log signal variance
    log_noise: torch.Tensor  # [m] log noise variance (σ_e² in Eq. 4)


class GPState(NamedTuple):
    params: GPParams
    x: torch.Tensor       # [n, d] training inputs (ICD space), padded
    y: torch.Tensor       # [n, m] standardized targets
    y_mean: torch.Tensor  # [m]
    y_std: torch.Tensor   # [m]
    chol: torch.Tensor    # [m, n, n] Cholesky of K + σ²I
    alpha: torch.Tensor   # [m, n]  (K+σ²I)⁻¹ y


def _nan_where_failed(L: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """JAX's Cholesky returns a lower triangle of NaN where the
    factorization fails; PyTorch's raises. ``cholesky_ex`` plus this mask
    gives JAX's behaviour."""
    return torch.where((info > 0)[..., None, None],
                       torch.tril(torch.full_like(L, float("nan"))), L)


def _cholesky(K: torch.Tensor) -> torch.Tensor:
    L, info = torch.linalg.cholesky_ex(K)
    return _nan_where_failed(L, info)


def _kernel(log_ls: torch.Tensor, log_var: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """ARD RBF kernel of one objective for inference (``pairdist`` kernel on
    CUDA tensors)."""
    ls = torch.exp(log_ls)
    d2 = _pairdist.pairdist((a / ls[None, :]).contiguous(),
                            (b / ls[None, :]).contiguous())
    return torch.exp(log_var) * torch.exp(-0.5 * d2)


def _kernels(params: GPParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[m, |a|, |b|] inference kernel matrices, one per objective."""
    return torch.stack([_kernel(params.log_ls[i], params.log_var[i], a, b)
                        for i in range(params.log_var.shape[0])])


def _nll(log_ls, log_var, log_noise, x, y, mask) -> torch.Tensor:
    """Summed exact negative log marginal likelihood of B independent GPs
    (``repro.core.gp._nll_one`` batched), with the weak log-normal
    hyperpriors. Differentiable. ``y`` is [n, B]; ``x`` [n, d] and ``mask``
    [n] are shared by the B GPs (the m objectives of one scenario) or given
    per GP as [B, n, d] and [B, n] (the folded scenarios of
    :func:`fit_gp_batch`)."""
    n = x.shape[-2]
    xb = x if x.dim() == 3 else x[None, :, :]
    a = xb / torch.exp(log_ls)[:, None, :]                      # [B, n, d]
    aa = torch.sum(a * a, dim=-1)
    d2 = torch.maximum(aa[:, :, None] + aa[:, None, :]
                       - 2.0 * (a @ a.transpose(1, 2)), x.new_zeros(()))
    K = torch.exp(log_var)[:, None, None] * torch.exp(-0.5 * d2)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    K = K + (torch.exp(log_noise) + JITTER)[:, None, None] * eye
    K = K + (torch.diag(1e6 * mask) if mask.dim() == 1
             else torch.diag_embed(1e6 * mask))
    L = _cholesky(K)
    yt = y.T                                                    # [B, n]
    alpha = torch.cholesky_solve(yt[:, :, None], L)[:, :, 0]
    nll = (torch.sum(0.5 * yt * alpha, dim=-1)
           + torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
           + 0.5 * n * math.log(2 * math.pi))
    prior = 0.05 * (torch.sum(log_ls ** 2, dim=-1) + log_var ** 2
                    + (log_noise + 4.0) ** 2)
    return torch.sum(nll + prior)


def _fit(params: GPParams, x, y, mask, steps: int = 200,
         lr: float = 5e-2) -> GPParams:
    """Adam on the summed per-objective NLL, written out: the same update
    order, bias correction at ``t + 1`` in float32 and clamps as
    ``repro.core.gp._fit`` (``torch.optim.Adam`` rounds differently)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    p = [t.detach().clone() for t in params]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    lo = (-3.0, -3.0, -7.0)   # log_ls, log_var, log_noise clamp bands
    hi = (3.5, 3.0, 2.0)
    for t in range(steps):
        leaves = [q.requires_grad_(True) for q in p]
        g = torch.autograd.grad(_nll(*leaves, x, y, mask), leaves)
        # bias corrections in float32, as the reference computes them
        tf = np.float32(t + 1.0)
        bc1 = float(np.float32(1.0) - np.power(np.float32(b1), tf))
        bc2 = float(np.float32(1.0) - np.power(np.float32(b2), tf))
        with torch.no_grad():
            for i in range(3):
                m[i] = b1 * m[i] + (1 - b1) * g[i]
                v[i] = b2 * v[i] + (1 - b2) * g[i] * g[i]
                mh = m[i] / bc1
                vh = v[i] / bc2
                # clamp to a numerically safe band: noiseless smooth targets
                # push noise->0 / var->inf and the f32 Cholesky NaNs
                p[i] = torch.clamp(p[i].detach() - lr * mh / (torch.sqrt(vh) + eps),
                                   lo[i], hi[i])
    return GPParams(*p)


def fold(params: GPParams) -> GPParams:
    """Scenario-major hyperparameters [S, m, ...] -> [S·m, ...] (a view)."""
    return GPParams(*(t.reshape(-1, *t.shape[2:]) for t in params))


def unfold(params: GPParams, S: int) -> GPParams:
    """[S·m, ...] -> [S, m, ...] (a view): the inverse of :func:`fold`."""
    return GPParams(*(t.reshape(S, -1, *t.shape[1:]) for t in params))


def _fit_batch(params: GPParams, x, yn, mask, steps: int) -> GPParams:
    """:func:`_fit` of S scenarios in one Adam loop: ``params`` [S, m, ...],
    ``x`` [S, P, d], standardized ``yn`` [S, P, m], ``mask`` [S, P]. Each
    scenario's m objectives become m of the S·m GPs that ``_nll`` batches,
    each with its scenario's rows; for S = 1 every operation sees the
    values ``_fit`` sees."""
    S, P, m = yn.shape
    x_f = x.repeat_interleave(m, dim=0)                         # [S·m, P, d]
    y_f = yn.permute(1, 0, 2).reshape(P, S * m)
    mask_f = mask.repeat_interleave(m, dim=0)                   # [S·m, P]
    return unfold(_fit(fold(params), x_f, y_f, mask_f, steps=steps), S)


def _posterior_cache(params: GPParams, x, y, mask):
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    K = (_kernels(params, x, x)
         + (torch.exp(params.log_noise) + JITTER)[:, None, None] * eye)
    K = K + torch.diag(1e6 * mask)
    L = _cholesky(K)
    alpha = torch.cholesky_solve(y.T[:, :, None], L)[:, :, 0]
    return L, alpha


def pad_training(x: torch.Tensor, y: torch.Tensor, bucket: int = PAD_BUCKET):
    """Pad (x [n,d], y [n,m]) to the next multiple of ``bucket`` with inert
    rows; returns ``(x_pad, y_pad, mask)`` with ``mask`` 1.0 on padded rows.
    Padded rows copy the last real row, shifted by +10 in x, and are
    silenced in the GP by a 1e6 per-point noise."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    n = x.shape[0]
    pad = (-n) % bucket
    mask = torch.cat([torch.zeros(n, device=x.device),
                      torch.full((pad,), 1.0, device=x.device)])
    if pad:
        x = torch.cat([x, x[-1:].repeat(pad, 1) + 10.0], dim=0)
        y = torch.cat([y, y[-1:].repeat(pad, 1)], dim=0)
    return x, y, mask


def default_params(m: int, d: int, device) -> GPParams:
    return GPParams(
        log_ls=torch.zeros((m, d), device=device) - 0.5,
        log_var=torch.zeros((m,), device=device),
        log_noise=torch.zeros((m,), device=device) - 4.0,
    )


def _standardize(y: torch.Tensor, mask: torch.Tensor):
    """Per-objective standardization over REAL rows only (mask=1 on padding)."""
    w = (1.0 - mask)[:, None]
    cnt = torch.clamp_min(torch.sum(w), 1.0)
    y_mean = torch.sum(y * w, dim=0) / cnt
    y_std = torch.sqrt(torch.sum((y - y_mean) ** 2 * w, dim=0) / cnt) + 1e-9
    return (y - y_mean) / y_std, y_mean, y_std


def fit_gp(x: torch.Tensor, y: torch.Tensor, steps: int = 200,
           params: GPParams | None = None,
           bucket: int = PAD_BUCKET) -> GPState:
    """Fit m independent GPs on (x [n,d], y [n,m]); y standardized
    internally, the training set padded to a multiple of ``bucket``. Adam
    starts from ``params`` (a warm start) or, when None, from the default
    hyperparameters (a cold fit)."""
    x, y, mask = pad_training(x, y, bucket)
    yn, y_mean, y_std = _standardize(y, mask)
    if params is None:
        params = default_params(y.shape[1], x.shape[1], x.device)
    params = _fit(params, x, yn, mask, steps=steps)
    chol, alpha = _posterior_cache(params, x, yn, mask)
    return GPState(params, x, yn, y_mean, y_std, chol, alpha)


def take(tree, i):
    """Scenario ``i`` (an index or an index tensor) of every leaf of a
    batched ``GPParams`` / ``GPState``."""
    return type(tree)(*(take(t, i) if isinstance(t, tuple) else t[i]
                        for t in tree))


def fit_gp_batch(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                 steps: int = 200, params: GPParams | None = None) -> GPState:
    """Fit S independent multi-objective GPs in one Adam loop.

    ``x`` [S, P, d], ``y`` [S, P, m], ``mask`` [S, P] (1.0 on inert padded
    rows: build each scenario's slice with :func:`pad_training`). Returns a
    ``GPState`` whose every field carries a leading scenario axis (index one
    out with :func:`take`). Each scenario is what :func:`fit_gp` fits on its
    rows; the Adam loop runs once for all (see :func:`_fit_batch`), the
    standardization and the posterior caches once a scenario."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    mask = mask.to(torch.float32)
    S, _, m = y.shape
    stats = [_standardize(y[i], mask[i]) for i in range(S)]
    yn, y_mean, y_std = (torch.stack([s[k] for s in stats]) for k in range(3))
    if params is None:
        p0 = default_params(m, x.shape[-1], x.device)
        params = GPParams(*(t.expand(S, *t.shape) for t in p0))
    params = _fit_batch(params, x, yn, mask, steps)
    caches = [_posterior_cache(take(params, i), x[i], yn[i], mask[i])
              for i in range(S)]
    return GPState(params, x, yn, y_mean, y_std,
                   torch.stack([c[0] for c in caches]),
                   torch.stack([c[1] for c in caches]))


def _cross_terms(state: GPState, xq: torch.Tensor):
    """Posterior mean [m, q] and ``Vs = L⁻¹ K(x, xq)`` [m, n, q]."""
    Ks = _kernels(state.params, state.x, xq)                   # [m, n, q]
    mean = (Ks.transpose(1, 2) @ state.alpha[:, :, None])[:, :, 0]
    Vs = torch.linalg.solve_triangular(state.chol, Ks, upper=False)
    return mean, Vs


def gp_predict(state: GPState, xq: torch.Tensor):
    """Posterior mean/std at query points, de-standardized: ([q,m], [q,m])."""
    mean, Vs = _cross_terms(state, xq)
    var = torch.exp(state.params.log_var)[:, None] - torch.sum(Vs * Vs, dim=1)
    std = torch.sqrt(torch.clamp_min(var, 1e-10))
    return mean.T * state.y_std + state.y_mean, std.T * state.y_std


def gp_joint_samples(state: GPState, xq: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """Joint posterior samples at ``xq`` [q, d] -> [s, q, m], from the
    standard normals ``eps`` [m, q, s] (one [q, s] block per objective)."""
    q = xq.shape[0]
    mean, Vs = _cross_terms(state, xq)
    Kqq = _kernels(state.params, xq, xq)
    cov = Kqq - Vs.transpose(1, 2) @ Vs
    # prior-scaled jitter: the f32 subtraction leaves small negative
    # eigenvalues when the posterior collapses (long lengthscales)
    jit = 1e-4 * torch.exp(state.params.log_var) + 1e-6
    eye = torch.eye(q, dtype=xq.dtype, device=xq.device)
    Lq = _cholesky(cov + jit[:, None, None] * eye)
    samp = mean[:, :, None] + Lq @ eps                         # [m, q, s]
    samp = samp.permute(2, 1, 0)                               # [s, q, m]
    return samp * state.y_std[None, None, :] + state.y_mean[None, None, :]

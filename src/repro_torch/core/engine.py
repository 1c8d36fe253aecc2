"""The BO engines: persistent surrogates + acquisition rounds.

A port of ``repro.core.engine``: :class:`BOEngine` runs one scenario,
:class:`BatchedBOEngine` a fleet of S scenarios (see its docstring); both
share their pool, chunk and snapshot code in ``_EngineBase``. Two paths:

* ``incremental=False`` (the exact path): each round is a ``fit_gp`` on every
  observation so far (cold, or warm from the last round's hyperparameters
  with ``warm_start``), IMOO scoring of the whole pool with frontier sampling
  over ``sub_rows``, never-re-evaluate masking and a host argmax.
* ``incremental=True``: the surrogate lives across rounds. Adam resumes from
  the last round's hyperparameters for ``warm_steps`` steps; the Cholesky
  factor ``L`` of the padded training set is extended by a rank-k block
  update of its trailing rows, and refactored only on bucket growth or when
  the fitted hyperparameters drift more than ``drift_tol`` from the ones
  ``L`` was built with (``params_ref``). The pool is cut into ``nc`` column
  chunks of ``C`` candidates (``pool_chunk``), and the cache
  ``V = L⁻¹·K(train, pool)`` is kept as ``[nc, m, P, C]``. The V update,
  the posterior moments, the MES scores, the mask and the argmax of a round
  are one call of the ``round_fused`` kernel (K4): its plain version on a
  CPU pool, its CUDA kernel on a GPU pool. Picks do not depend on the chunk
  size.

The refactor decision is taken on the host: the drift, a float32 scalar, is
compared with ``float32(drift_tol)`` exactly as the reference's in-graph
``lax.cond`` does. Where the reference donates its state buffers to the
jitted round, K4 here writes the new rows of V **in place** into the cached
tensor; :meth:`BOEngine.state_dict` therefore copies every array it returns.

q-batches (:meth:`BOEngine.select_q`) impute each pick's outcome (posterior
mean or a constant liar), extend L by the same block update and re-score the
pool under the round's frozen frontier sample ``y*``. A fantasy step's V
update and its re-score are one K4 call (the reference runs the append
staged and then a score-only launch; the pick is the same). Fantasy rows
live only in the trailing ``[s0, P)`` rows that the next real round
recomputes.

The pool is mutable (``_EngineBase``): ``pool_append`` and ``pool_replace``
edit unevaluated columns (evaluated rows are observation keys and never
change), stamp fresh ``candidate_ids`` and, with a live factorization,
refresh only the dirty V chunks by one K4 call at s0 = 0 a scenario;
``pool_scores`` is one score-only K4 call a scenario that writes every
column's masked score (the proposer's victims). A snapshot of an edited
engine carries the reference's ``pool_edit`` block.

The factor and frontier helpers below batch G scenarios' m objectives as
one batch of G·m factors; :class:`BOEngine` calls them with G = 1.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import round_fused as _rf

from .acquisition import imoo_scores, imoo_scores_batch
from .gp import (JITTER, PAD_BUCKET, GPParams, _cholesky, _fit, _fit_batch,
                 _kernels, _standardize, default_params, fit_gp, fit_gp_batch,
                 fold, pad_training, take)

__all__ = ["BOEngine", "BatchedBOEngine", "EngineStats", "EngineState",
           "FANTASY_MODES", "PROFILE_STAGES", "ENGINE_STATE_FORMAT",
           "auto_chunk"]

#: imputation rules of fantasy (q-batch / pending) selection: ``"mean"`` —
#: posterior mean at the pick; ``"cl_min"`` / ``"cl_max"`` — constant liar at
#: the worst / best observed target per objective (in the engine's negated,
#: standardized target space).
FANTASY_MODES = ("mean", "cl_min", "cl_max")

#: version tag of the ``state_dict`` layout (the reference's)
ENGINE_STATE_FORMAT = 1

#: stage keys a profiled select round fills, in execution order; the last is
#: the round's one ``round_fused`` call (one K4 launch on a GPU pool)
PROFILE_STAGES = ("fit", "factor", "frontier", "round_fused")

#: memory budget of one pool chunk under ``pool_chunk="auto"``
DEFAULT_CHUNK_BUDGET_MB = 64


def auto_chunk(n: int, *, bytes_per_col: int = 4 * 3 * 256,
               budget_mb: int = DEFAULT_CHUNK_BUDGET_MB,
               floor: int = 2048) -> int:
    """Column-chunk size for an ``n``-wide pool under a memory budget
    (``repro.kernels.backend.auto_chunk``): ``bytes_per_col`` models one
    column of V (m = 3 objectives × P = 256 rows × float32); the result is
    clamped to ``[min(floor, n), n]``."""
    if n < 1:
        raise ValueError(f"auto_chunk: n must be >= 1, got {n}")
    c = (budget_mb << 20) // max(bytes_per_col, 1)
    return int(min(n, max(floor, c)))


@dataclasses.dataclass
class EngineStats:
    """Host-side counters for one engine run (the reference's fields)."""

    rounds: int = 0
    refactors: int = 0       # full O(P³) factorizations
    block_updates: int = 0   # rank-k trailing-block updates
    dispatches: int = 0      # round programs (exact: 5 stages per round)
    fantasy_steps: int = 0   # rank-1 fantasy appends (q-batch / pending)
    frontier_resamples: int = 0  # joint frontier draws (1 per round)
    last_drift: float = 0.0  # max |params − params_ref| at the last round
    # per-scenario factorization decisions (batched engine): in a mixed
    # round only the drifting scenarios refactor, the rest block-update
    scenario_refactors: int = 0
    scenario_block_updates: int = 0
    mixed_rounds: int = 0    # rounds where the fleet split ref/update
    # mutable-pool bookkeeping: columns appended/replaced and the V chunks
    # recomputed for them (never a full refactor)
    pool_appends: int = 0
    pool_replacements: int = 0
    v_chunk_refreshes: int = 0
    #: cumulative wall seconds per stage of profiled rounds
    #: (``profile_stages=True``): the ``PROFILE_STAGES`` keys plus
    #: ``"round_total"`` around the whole round
    stage_wall_s: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EngineStats":
        """Build from a snapshot dict: unknown keys are dropped, missing keys
        keep their defaults; ``stage_wall_s`` is copied."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kept = {k: v for k, v in d.items() if k in fields}
        if kept.get("stage_wall_s") is not None:
            kept["stage_wall_s"] = {str(k): float(v)
                                    for k, v in kept["stage_wall_s"].items()}
        return cls(**kept)

    def fold_into(self, registry, *, prefix: str = "engine") -> None:
        """Add this run's counters to a metrics registry (duck-typed:
        anything with ``counter(name, help).inc(v, **labels)``, such as the
        reference's ``repro.obs.MetricsRegistry``). Call once per finished
        engine (the stats are cumulative); ``stage_wall_s`` lands as
        ``engine_stage_seconds_total{stage=...}``."""
        for k in ("rounds", "refactors", "block_updates", "dispatches",
                  "fantasy_steps", "frontier_resamples",
                  "scenario_refactors", "scenario_block_updates",
                  "mixed_rounds", "pool_appends", "pool_replacements",
                  "v_chunk_refreshes"):
            v = float(getattr(self, k))
            if v:
                registry.counter(f"{prefix}_{k}_total",
                                 f"engine {k.replace('_', ' ')}").inc(v)
        for stage, sec in (self.stage_wall_s or {}).items():
            registry.counter(
                f"{prefix}_stage_seconds_total",
                "profiled per-stage wall seconds"
                " (profile_stages=True rounds only)",
            ).inc(float(sec), stage=str(stage))


class EngineState(NamedTuple):
    """The incremental engine's state between rounds."""

    params: GPParams      # warm-evolving fit hyperparameters
    params_ref: GPParams  # hyperparameters of the current factorization
    L: torch.Tensor       # [m, P, P] Cholesky of K(params_ref) + noise
    V: torch.Tensor       # [nc, m, P, C] L⁻¹·K(train_pad, pool chunk)


def _np(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (``Tensor.numpy()`` on the CPU shares memory)."""
    return t.detach().cpu().numpy().copy()


def _params_to_np(p: GPParams) -> dict:
    return {"log_ls": _np(p.log_ls), "log_var": _np(p.log_var),
            "log_noise": _np(p.log_noise)}


def _params_from_np(d: dict, device) -> GPParams:
    return GPParams(*(torch.tensor(np.asarray(d[k], np.float32), device=device)
                      for k in ("log_ls", "log_var", "log_noise")))


def _drift(params: GPParams, params_ref: GPParams) -> torch.Tensor:
    """max |Δ| over all log-domain hyperparameter leaves (float32)."""
    return torch.stack([torch.max(torch.abs(a - b))
                        for a, b in zip(params, params_ref)]).max()


# ------------------------------------------------------------ factorization
# The factor, whitening and frontier helpers take G scenarios at once:
# hyperparameters [G, m, ...], L [G, m, P, P], x [G, P, d], mask [G, P],
# yn [G, P, m]. The G·m factors are one batch of the linear algebra, as the
# fit's objectives are; only the inference kernel matrices (``pairdist``)
# are built one (scenario, objective) at a time. The single-scenario names
# below lift their arguments to G = 1.
def _one(params: GPParams) -> GPParams:
    """One scenario's hyperparameters [m, ...] as G = 1: [1, m, ...]."""
    return GPParams(*(t[None] for t in params))


def _kernels_batch(params: GPParams, a, b) -> torch.Tensor:
    """[G·m, |a|, |b|] inference kernel matrices of ``a`` [G, na, d] and
    ``b`` [G, nb, d], scenario-major."""
    return torch.cat([_kernels(take(params, g), a[g], b[g])
                      for g in range(a.shape[0])])


def _noise_diag(params: GPParams, mask, n: int, device):
    """The noise + jitter diagonals [G·m, 1, 1]·I and the pad rows' 1e6
    [G·m, n, n] of ``mask`` [G, n]."""
    m = params.log_var.shape[1]
    eye = torch.eye(n, device=device)
    return ((torch.exp(fold(params).log_noise) + JITTER)[:, None, None] * eye,
            torch.diag_embed(1e6 * mask.repeat_interleave(m, dim=0)))


def _chol_refactor_batch(params: GPParams, x, mask) -> torch.Tensor:
    """[G, m, P, P] full train Cholesky factors (no pool work)."""
    G, P, _ = x.shape
    noise, pads = _noise_diag(params, mask, P, x.device)
    L = _cholesky(_kernels_batch(params, x, x) + noise + pads)
    return L.reshape(G, -1, P, P)


def _chol_block_batch(params_ref: GPParams, L, x, mask, s0: int) -> torch.Tensor:
    """Rank-k extension of L [G, m, P, P]: rows [s0, P) recomputed, rows
    above kept.

    For ``K = [[K11, K12], [K21, K22]]``: ``L21 = (L11⁻¹ K12)ᵀ`` and
    ``L22 = chol(K22 − L21 L21ᵀ)``, what a full factorization gives, at
    O(P²·k). Valid while rows [0, s0) of ``x`` are unchanged since ``L``
    was built."""
    G, P, _ = x.shape
    xa, xb = x[:, :s0], x[:, s0:]
    noise, pads = _noise_diag(params_ref, mask[:, s0:], P - s0, x.device)
    K12 = _kernels_batch(params_ref, xa, xb)                    # [G·m, s0, B]
    K22 = _kernels_batch(params_ref, xb, xb) + noise + pads
    Lf = L.reshape(-1, P, P)
    L21 = torch.linalg.solve_triangular(Lf[:, :s0, :s0], K12,
                                        upper=False).transpose(1, 2)
    L22 = _cholesky(K22 - L21 @ L21.transpose(1, 2))
    out = Lf.clone()
    out[:, s0:, :s0] = L21
    out[:, s0:, s0:] = L22
    return out.reshape(G, -1, P, P)


def _chol_refactor(params: GPParams, x, mask) -> torch.Tensor:
    """One scenario's [m, P, P] full train Cholesky factors."""
    return _chol_refactor_batch(_one(params), x[None], mask[None])[0]


def _chol_block(params_ref: GPParams, L, x, mask, s0: int) -> torch.Tensor:
    """One scenario's rank-k extension of L [m, P, P] (rows [s0, P))."""
    return _chol_block_batch(_one(params_ref), L[None], x[None], mask[None],
                             s0)[0]


# ----------------------------------------------------------------- scoring
def _col_moments(log_var, beta, V):
    """Posterior mean/std [B, C] of V blocks [B, P, C] for whitened targets
    ``beta`` [B, P], in the fixed sequential order (never a matmul: the
    chunk-size invariance of the picks rests on it)."""
    return _rf.col_moments_plain(torch.exp(log_var), beta, V)


def _train_beta_batch(L, yn) -> torch.Tensor:
    """[G, m, P] whitened targets β = L⁻¹·y per scenario and objective."""
    G, m, P, _ = L.shape
    yt = yn.transpose(1, 2).reshape(G * m, P)
    beta = torch.linalg.solve_triangular(L.reshape(G * m, P, P),
                                         yt[:, :, None], upper=False)
    return beta[:, :, 0].reshape(G, m, P)


def _train_beta(L, yn) -> torch.Tensor:
    """One scenario's [m, P] whitened targets."""
    return _train_beta_batch(L[None], yn[None])[0]


def _frontier_ystar_batch(params_ref: GPParams, L, beta, x, xq, y_mean,
                          y_std, eps) -> torch.Tensor:
    """[G, s, m] sampled Pareto-frontier maxima over the ``xq`` [G, q, d]
    subsets, from the standard normals ``eps`` [G, m, q, s] (the joint draw
    of ``gp_joint_samples`` + ``frontier_maxima``)."""
    G, m, P, _ = L.shape
    q, s = xq.shape[1], eps.shape[-1]
    pf = fold(params_ref)
    Ks = _kernels_batch(params_ref, x, xq)                      # [G·m, P, q]
    Vs = torch.linalg.solve_triangular(L.reshape(G * m, P, P), Ks,
                                       upper=False)
    mean_q, _ = _col_moments(pf.log_var, beta.reshape(G * m, P), Vs)
    cov = _kernels_batch(params_ref, xq, xq) - Vs.transpose(1, 2) @ Vs
    jit = 1e-4 * torch.exp(pf.log_var) + 1e-6
    eye = torch.eye(q, dtype=xq.dtype, device=xq.device)
    Lq = _cholesky(cov + jit[:, None, None] * eye)
    samp = mean_q[:, :, None] + Lq @ eps.reshape(G * m, q, s)   # [G·m, q, s]
    samp = (samp.reshape(G, m, q, s).permute(0, 3, 2, 1)
            * y_std[:, None, None, :] + y_mean[:, None, None, :])  # [G,s,q,m]
    return torch.amax(samp, dim=2)


def _frontier_ystar(params_ref: GPParams, L, beta, x, xq, y_mean, y_std,
                    eps) -> torch.Tensor:
    """One scenario's [s, m] frontier maxima over ``xq`` [q, d]."""
    return _frontier_ystar_batch(_one(params_ref), L[None], beta[None],
                                 x[None], xq[None], y_mean[None],
                                 y_std[None], eps[None])[0]


def _beta_ystar_batch(params_ref: GPParams, L, x, yn, y_mean, y_std,
                      pool_flat, sub, eps):
    """Whitened targets [G, m, P] and ONE sampled frontier maximum [G, s, m]
    a scenario for a round; ``sub`` [G, q] indexes ``pool_flat`` [G, N, d]."""
    beta = _train_beta_batch(L, yn)
    xq = pool_flat[torch.arange(sub.shape[0], device=sub.device)[:, None],
                   sub]
    ystar = _frontier_ystar_batch(params_ref, L, beta, x, xq, y_mean, y_std,
                                  eps)
    return beta, ystar


def _beta_ystar(params_ref: GPParams, L, x, yn, y_mean, y_std, pool_flat,
                sub, eps):
    """One scenario's whitened targets and frontier maximum for a round."""
    beta, ystar = _beta_ystar_batch(_one(params_ref), L[None], x[None],
                                    yn[None], y_mean[None], y_std[None],
                                    pool_flat[None], sub[None], eps[None])
    return beta[0], ystar[0]


def _round_fused(params_ref: GPParams, L, V, x, beta, ystar, pool_c,
                 evalm_c, y_mean, y_std, weights, s0: int):
    """K4 on the engine's state: ``(V, pick)`` with V updated in place."""
    return _rf.round_select(torch.exp(params_ref.log_ls),
                            torch.exp(params_ref.log_var), L, V, x, beta,
                            ystar, pool_c, evalm_c, y_mean, y_std, weights,
                            s0=s0)


#: :func:`repro_torch.kernels.round_fused.round_select`'s arguments, in order
_K4_ARGS = ("ls", "var", "L", "V", "x", "beta", "ystar", "pool_c", "evalm_c",
            "y_mean", "y_std", "weights")


def _untimed(name: str, fn, *args, **kwargs):
    """The default stage hook of :func:`_round_seq`: just ``fn(...)``."""
    return fn(*args, **kwargs)


def _round_seq(state: EngineState, x, yn, y_mean, y_std, mask, pool_c,
               evalm_c, sub, eps, force_refactor: bool, drift_tol: float,
               weights, *, steps: int, s0: int, timed=_untimed):
    """One incremental round: warm fit → drift check → block update or
    refactor → frontier sample → one K4 call (V update, scores, argmax).

    ``timed(name, fn, *args)`` runs each stage (the ``PROFILE_STAGES``);
    profile mode passes a hook that times it. Returns ``(state, pick,
    refactored, drift, ystar)``; ``pick`` is a 0-dim int32 tensor on the
    pool's device."""
    params = timed("fit", _fit, state.params, x, yn, mask, steps=steps)
    drift = _drift(params, state.params_ref)
    do_ref = (s0 <= 0 or force_refactor
              or bool(np.float32(float(drift)) > np.float32(drift_tol)))
    params_ref = params if do_ref else state.params_ref
    L = (timed("factor", _chol_refactor, params_ref, x, mask) if do_ref
         else timed("factor", _chol_block, params_ref, state.L, x, mask, s0))
    beta, ystar = timed("frontier", _beta_ystar, params_ref, L, x, yn, y_mean,
                        y_std, pool_c.reshape(-1, pool_c.shape[-1]), sub, eps)
    V, nxt = timed("round_fused", _round_fused, params_ref, L, state.V, x,
                   beta, ystar, pool_c, evalm_c, y_mean, y_std, weights,
                   0 if do_ref else s0)
    return EngineState(params, params_ref, L, V), nxt, do_ref, drift, ystar


# ------------------------------------------------------- fantasy (q-batch)
def _liar_target(liar: str, mean_std, yn, mask) -> torch.Tensor:
    """Imputed standardized target [m] of one fantasy row."""
    if liar == "mean":
        return mean_std
    pad = mask[:, None] > 0
    if liar == "cl_min":
        return torch.where(pad, math.inf, yn).amin(dim=0)
    return torch.where(pad, -math.inf, yn).amax(dim=0)


def _fantasy_step(params_ref: GPParams, L, V, rows_pad, yn, mask, pool_c,
                  evalm_c, weights, y_mean, y_std, ystar, pick: int,
                  pos: int, *, s0: int, liar: str):
    """Append ONE fantasy observation and re-score under the frozen
    ``ystar``: the picked row takes pad position ``pos``, its target is
    imputed under the current posterior (the moments' fixed order), L gets
    the trailing block update from ``s0`` (the bucket floor of the real
    rows), and one K4 call updates V in place and picks again."""
    _, C, d = pool_c.shape
    beta = _train_beta(L, yn)
    Vcol = V[pick // C, :, :, pick % C, None]                   # [m, P, 1]
    mean_std = _col_moments(params_ref.log_var, beta, Vcol)[0][:, 0]
    target = _liar_target(liar, mean_std, yn, mask)
    rows2, mask2, yn2 = rows_pad.clone(), mask.clone(), yn.clone()
    rows2[pos] = pick
    mask2[pos] = 0.0
    yn2[pos] = target
    x2 = pool_c.reshape(-1, d)[rows2] + 10.0 * mask2[:, None]
    L2 = (_chol_refactor(params_ref, x2, mask2) if s0 <= 0
          else _chol_block(params_ref, L, x2, mask2, s0))
    evalm2 = evalm_c.clone()
    evalm2[pick // C, pick % C] = True
    V2, nxt = _round_fused(params_ref, L2, V, x2, _train_beta(L2, yn2), ystar,
                           pool_c, evalm2, y_mean, y_std, weights, max(s0, 0))
    return L2, V2, rows2, mask2, yn2, evalm2, nxt


class _EngineBase:
    """Knobs, chunk grid, lifecycle and the shared half of the snapshot of
    both engines (the reference's ``_EngineBase``). ``self.pool`` is [N, d]
    (:class:`BOEngine`) or [S, N, d] (:class:`BatchedBOEngine`); every
    helper here works on either."""

    def _configure(self, pool_icd, *, incremental: bool,
                   warm_start: bool | None, gp_steps: int,
                   warm_steps: int | None, drift_tol: float, bucket: int,
                   s_frontiers: int, weights, pool_chunk, device,
                   hold_pool: bool = True) -> torch.Tensor:
        """Set the knobs; returns the pool as a float32 tensor. Unless
        ``hold_pool`` (a mesh's fleet, whose scenario groups hold it), the
        pool, its chunk grid and its ids stay off this engine."""
        self.device = resolve_device(device)
        pool = torch.as_tensor(pool_icd, dtype=torch.float32)
        self.N, self.d = pool.shape[-2:]
        self.incremental = bool(incremental)
        self.warm_start = (self.incremental if warm_start is None
                           else bool(warm_start))
        self.gp_steps = int(gp_steps)
        self.warm_steps = (max(10, self.gp_steps // 10) if warm_steps is None
                           else int(warm_steps))
        self.drift_tol = float(drift_tol)
        self.bucket = int(bucket)
        self.s_frontiers = int(s_frontiers)
        self.weights = (None if weights is None else torch.as_tensor(
            np.asarray(weights), dtype=torch.float32, device=self.device))
        self.stats = EngineStats()
        self._C = self._resolve_chunk(pool_chunk, self.N)
        self.pool = self._pool_c = None
        if hold_pool:
            self.pool = pool.to(self.device).contiguous()
            self._regrid()
            self._init_pool_ids()
        self._state: EngineState | None = None
        self._last_params: GPParams | None = None   # exact-path warm start
        self._P = 0                              # current padded train size
        self._n_at_last_select = 0
        self._last_batch = None                  # (rows_pad, y_pad, mask)
        self._last_ystar: torch.Tensor | None = None
        return pool

    # ---------------------------------------------------------- chunk grid
    def _fit_schedule(self, first: bool) -> tuple[bool, int]:
        """(cold, steps) of this round's Adam fit."""
        cold = first or not self.warm_start
        return cold, self.gp_steps if cold else self.warm_steps

    def _resolve_chunk(self, pool_chunk, n: int) -> int:
        """``pool_chunk`` -> chunk width C in [1, n]: ``None`` is one chunk,
        ``"auto"`` is :func:`auto_chunk`."""
        if pool_chunk is None:
            return n
        if not self.incremental:
            raise ValueError(
                "pool_chunk requires incremental=True: the exact path scores "
                "the pool in one piece")
        if pool_chunk == "auto":
            return auto_chunk(n)
        c = int(pool_chunk)
        if c < 1:
            raise ValueError(f"pool_chunk must be >= 1, got {pool_chunk}")
        return min(c, n)

    def _regrid(self) -> None:
        """The chunked pool [..., nc, C, d]: padded to nc·C with copies of
        row 0 (pad columns are always masked, see :meth:`_evalm_chunks`)."""
        self._nc = -(-self.N // self._C)
        self._N_pad = self._nc * self._C
        pool = self.pool
        pad = self._N_pad - self.N
        if pad:
            pool = torch.cat([pool, pool[..., :1, :].expand(
                *pool.shape[:-2], pad, self.d)], dim=-2)
        self._pool_c = pool.reshape(*pool.shape[:-2], self._nc, self._C,
                                    self.d).contiguous()

    def _evalm_chunks(self) -> torch.Tensor:
        """[..., nc, C] never-re-evaluate mask; pad columns always masked."""
        em = self._eval_mask
        pad = self._N_pad - self.N
        if pad:
            em = torch.cat([em, torch.ones(*em.shape[:-1], pad,
                                           dtype=torch.bool,
                                           device=self.device)], dim=-1)
        return em.reshape(*em.shape[:-1], self._nc, self._C).contiguous()

    def _eps(self, eps) -> torch.Tensor:
        """The round's normals as one float32 tensor on the engine's device
        (a per-scenario sequence is stacked)."""
        if isinstance(eps, (list, tuple)):
            return torch.stack([self._eps(e) for e in eps])
        return torch.as_tensor(eps, dtype=torch.float32, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _padded_batch(rows: list[int], y: np.ndarray, P: int):
        """Pad (rows, raw y) to P with ``pad_training``'s conventions: pad
        rows repeat the last real row (the +10 x shift is applied in the
        round), targets are negated; ``mask`` is 1.0 on pad rows."""
        n = len(rows)
        rows_pad = np.asarray(rows + [rows[-1]] * (P - n), np.int32)
        y_neg = -np.asarray(y, np.float32)
        y_pad = np.concatenate([y_neg, np.tile(y_neg[-1:], (P - n, 1))], 0)
        mask = np.concatenate([np.zeros(n, np.float32),
                               np.ones(P - n, np.float32)])
        return rows_pad, y_pad, mask

    def _alloc_state(self, params0: GPParams, P: int,
                     fresh: bool) -> EngineState:
        """The round's starting state: the live one with ``params0``, or
        zero factors [..., m, P, P] and V cache [..., nc, m, P, C]."""
        if self._state is not None and not fresh:
            return self._state._replace(params=params0)
        lead, m = self.pool.shape[:-2], self.m
        L = torch.zeros((*lead, m, P, P), device=self.device)
        V = torch.zeros((*lead, self._nc, m, P, self._C), device=self.device)
        ref = (GPParams(*(t.clone() for t in params0)) if self._state is None
               else self._state.params_ref)
        return EngineState(params0, ref, L, V)

    # ------------------------------------------------------ pool mutation
    # The mutable-pool contract: evaluated rows are the engine's observation
    # keys, so `pool_replace` refuses them and a row, once evaluated, names
    # the same design forever. Unevaluated columns may be replaced and new
    # ones appended; every edit stamps fresh stable ids (`candidate_ids`).
    # With a live factorization, only the V chunks whose columns changed are
    # recomputed, by one K4 call at s0 = 0 on those chunks a scenario.

    def _init_pool_ids(self) -> None:
        self._ids = np.arange(self.N, dtype=np.int64)
        self._next_id = int(self.N)
        self._pool_edited = False

    @property
    def candidate_ids(self) -> np.ndarray:
        """Stable per-column ids [N]: assigned at construction, fresh ones on
        every appended or replaced column, kept by ``state_dict``."""
        return self._ids.copy()

    def _check_cols(self, cols, what: str) -> torch.Tensor:
        cols = torch.as_tensor(cols, dtype=torch.float32, device=self.device)
        want = len(self._pool_shape())
        ok = cols.dim() == want and cols.shape[-1] == self.d and (
            want == 2 or cols.shape[0] == self.S)
        if not ok:
            lead = "[k, d]" if want == 2 else "[S, k, d]"
            raise ValueError(
                f"{what}: expected columns shaped {lead} with d={self.d}"
                + ("" if want == 2 else f", S={self.S}")
                + f", got {tuple(cols.shape)}")
        return cols.contiguous()

    def pool_append(self, cols) -> np.ndarray:
        """Append candidate columns ([k, d]; batched [S, k, d]) to the pool
        and return their row indices [k]. Existing rows are untouched; the
        chunk width C stays (the pool may gain chunks); with a live
        factorization the old tail chunk and the new chunks are refreshed."""
        self._check_live()
        cols = self._check_cols(cols, "pool_append")
        k = int(cols.shape[-2])
        if k == 0:
            return np.empty((0,), np.int64)
        n_old = self.N
        self.pool = torch.cat([self.pool, cols], dim=-2).contiguous()
        self.N = int(self.pool.shape[-2])
        self._ids = np.concatenate([
            self._ids,
            np.arange(self._next_id, self._next_id + k, dtype=np.int64)])
        self._next_id += k
        self._pool_edited = True
        grow = torch.zeros((*self._eval_mask.shape[:-1], k), dtype=torch.bool,
                           device=self.device)
        self._eval_mask = torch.cat([self._eval_mask, grow], dim=-1)
        self._regrid()
        self._refresh_v(list(range(n_old // self._C, self._nc)))
        self.stats.pool_appends += k
        return np.arange(n_old, self.N, dtype=np.int64)

    def pool_replace(self, rows, cols) -> None:
        """Replace the unevaluated pool columns ``rows`` [k] with ``cols``
        ([k, d]; batched [S, k, d]: each scenario's encoding of the same k
        designs). Raises if a row has been evaluated in any scenario, is out
        of range or repeats. Replaced columns get fresh ids; with a live
        factorization only the chunks holding them are refreshed (and the
        pad chunk when row 0 changes: pad columns copy row 0)."""
        self._check_live()
        rows, cols = self._check_replace(rows, cols)
        if len(rows) == 0:
            return
        pool = self.pool.clone()  # never write into a caller's tensor
        pool[..., torch.as_tensor(rows, device=self.device), :] = cols
        self.pool = pool
        self._ids[rows] = np.arange(self._next_id,
                                    self._next_id + len(rows),
                                    dtype=np.int64)
        self._next_id += len(rows)
        self._pool_edited = True
        dirty = {int(r) // self._C for r in rows}
        if 0 in rows and self._N_pad > self.N:
            dirty.add(self._nc - 1)  # pad columns are copies of row 0
        self._regrid()
        self._refresh_v(sorted(dirty))
        self.stats.pool_replacements += len(rows)

    def _check_replace(self, rows, cols) -> tuple:
        """:meth:`pool_replace`'s arguments validated: (rows [k], cols)."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        cols = self._check_cols(cols, "pool_replace")
        if int(cols.shape[-2]) != len(rows):
            raise ValueError(f"pool_replace: {len(rows)} rows but "
                             f"{int(cols.shape[-2])} replacement columns")
        if len(rows) == 0:
            return rows, cols
        if rows.min() < 0 or rows.max() >= self.N:
            raise ValueError(f"pool_replace: row indices must be in "
                             f"[0, {self.N}), got {rows.tolist()}")
        if len(np.unique(rows)) != len(rows):
            raise ValueError("pool_replace: duplicate target rows")
        bad = rows[self._evaluated_any()[rows]]
        if bad.size:
            raise ValueError(
                f"pool_replace: rows {bad.tolist()} have been evaluated — "
                "evaluated rows are observation keys and can never be "
                "replaced (append instead)")
        return rows, cols

    def _evaluated_any(self) -> np.ndarray:
        """[N] bool: the rows evaluated in any scenario."""
        return self._eval_mask.reshape(-1, self.N).any(0).cpu().numpy()

    def _pool_shape(self) -> list:
        return list(self.pool.shape)

    def _frozen_args(self, si: int | None, scored: bool = True) -> dict:
        """K4's arguments under the last round's frozen state, for scenario
        ``si`` (None: the sequential engine): the factorization's
        hyperparameters, L and V, the last padded batch's rows (+10 on pad
        rows) and whitened targets, the round's y*, the chunked pool, the
        evaluated mask and the weights. Unless ``scored``, the targets are
        neutral (beta 0, y_mean 0, y_std 1): only the scores read them, and
        a chunk refresh discards its scores."""
        def pick(t):
            return t if si is None else t[si]

        st, dev = self._state, self.device
        rows_np, y_pad, mask_np = self._last_batch
        pr = st.params_ref if si is None else take(st.params_ref, si)
        mask = torch.as_tensor(pick(mask_np), device=dev)
        pool_c = pick(self._pool_c)
        x = (pool_c.reshape(-1, self.d)[torch.as_tensor(
            pick(rows_np), dtype=torch.int64, device=dev)]
             + 10.0 * mask[:, None])
        L = pick(st.L)
        if scored:
            yn, y_mean, y_std = _standardize(
                torch.as_tensor(pick(y_pad), device=dev), mask)
            beta = _train_beta(L, yn)
        else:
            beta = torch.zeros(L.shape[:2], device=dev)
            y_mean = torch.zeros(self.m, device=dev)
            y_std = torch.ones(self.m, device=dev)
        return dict(ls=torch.exp(pr.log_ls), var=torch.exp(pr.log_var), L=L,
                    V=pick(st.V), x=x, beta=beta,
                    ystar=pick(self._last_ystar), pool_c=pool_c,
                    evalm_c=pick(self._evalm_chunks()), y_mean=y_mean,
                    y_std=y_std, weights=pick(self._weights()))

    def _scenarios(self) -> list:
        return [None] if self.pool.dim() == 2 else list(range(self.S))

    def _refresh_v(self, dirty: list) -> None:
        """Recompute the V chunks ``dirty`` under the current factorization
        (params_ref, L): one K4 call at s0 = 0 a scenario on copies of those
        chunks, scattered back. Rows [0, s0) of a refreshed chunk are
        bitwise what a full refactor under the same params_ref gives (K4's
        arithmetic for a column does not depend on the chunks beside it);
        the trailing rows are recomputed by the next round either way."""
        if self._state is None or not dirty:
            return
        V = self._state.V
        nc_have = V.shape[-4]
        if nc_have != self._nc:  # appends added chunks
            grow = torch.zeros((*V.shape[:-4], self._nc - nc_have,
                                *V.shape[-3:]), device=self.device)
            V = torch.cat([V, grow], dim=-4)
            self._state = self._state._replace(V=V)
        if self._last_batch is None:
            return
        didx = torch.as_tensor(np.asarray(dirty, np.int64), device=self.device)
        for si in self._scenarios():
            a = self._frozen_args(si, scored=False)
            cache = a["V"]  # this scenario's [nc, m, P, C] cache
            # gathered copies of the dirty chunks, never a view of the cache
            a.update(V=cache[didx], pool_c=a["pool_c"][didx],
                     evalm_c=a["evalm_c"][didx])
            _rf.refresh_chunks(*(a[k] for k in _K4_ARGS), nc_full=self._nc)
            cache[didx] = a["V"]
        self.stats.v_chunk_refreshes += len(dirty)

    def pool_scores(self) -> np.ndarray:
        """Acquisition scores of every pool column, [N] (sequential) or
        [S, N] (batched), under the last round's frozen state: cached V,
        whitened targets of the last padded batch and the round's y*.
        Evaluated columns score -inf. One score-only K4 call a scenario
        (s0 >= P, V untouched) that writes the masked scores its argmax
        reads; the between-round proposer ranks its victims with them."""
        self._check_live()
        if not self.incremental:
            raise RuntimeError(
                "pool_scores() requires incremental=True: the exact "
                "historical path keeps no V cache to score from")
        if (self._state is None or self._last_ystar is None
                or self._last_batch is None):
            raise RuntimeError(
                "pool_scores() requires a completed round (no frozen "
                "state yet — call select/select_q first)")
        out = []
        for si in self._scenarios():
            a = self._frozen_args(si)
            sc = torch.empty((self._nc, self._C), device=self.device)
            _rf.round_select(*(a[k] for k in _K4_ARGS), s0=self._P,
                             scores=sc)
            out.append(sc.reshape(-1)[: self.N])
        if self.pool.dim() == 2:
            return out[0].cpu().numpy()
        return torch.stack(out).cpu().numpy()

    # --------------------------------------------------- lifecycle hooks
    def _check_live(self) -> None:
        if getattr(self, "_released", False):
            raise RuntimeError(
                "engine has been released: its device arrays are gone. "
                "Build a fresh engine and load_state_dict() a snapshot "
                "taken BEFORE release() to continue this trajectory")

    def device_bytes(self) -> int:
        """Bytes of the engine's persistent arrays (chunked pool, evaluated
        mask, incremental state, last padded batch, frozen y*): exactly what
        :meth:`release` frees."""
        if getattr(self, "_released", False):
            return 0
        arrays = [self._pool_c, self._eval_mask, self._last_ystar]
        if self._state is not None:
            arrays += [*self._state.params, *self._state.params_ref,
                       self._state.L, self._state.V]
        if self._last_batch is not None:
            arrays += list(self._last_batch)
        return sum(a.nbytes if isinstance(a, np.ndarray)
                   else a.numel() * a.element_size()
                   for a in arrays if a is not None)

    def release(self) -> None:
        """Drop every persistent array; later observe/select/state_dict
        calls raise. Idempotent."""
        self._released = True
        self._state = None
        self._last_params = None
        self._last_batch = None
        self._last_ystar = None
        self._eval_mask = None
        self._pool_c = None
        self.pool = None

    # -------------------------------------------- state (de)serialization
    def _base_state_dict(self) -> dict:
        """The snapshot's shared half in the reference's key layout: numpy
        copies (never views of live state) and JSON-able scalars."""
        self._check_live()
        d = {"format": ENGINE_STATE_FORMAT, "kind": type(self).__name__,
             "incremental": self.incremental, "bucket": self.bucket,
             "pool_shape": self._pool_shape(), "P": self._P,
             "n_at_last_select": self._n_at_last_select,
             "stats": self.stats.as_dict()}
        if self._state is not None:
            d["state"] = {"params": _params_to_np(self._state.params),
                          "params_ref": _params_to_np(self._state.params_ref),
                          "L": _np(self._state.L), "V": _np(self._state.V)}
        if self._last_params is not None:
            d["last_params"] = _params_to_np(self._last_params)
        if self._last_batch is not None:
            rp, yp, mk = self._last_batch
            d["last_batch"] = {"rows_pad": rp.copy(), "y_pad": yp.copy(),
                               "mask": mk.copy()}
        if self._last_ystar is not None:
            d["last_ystar"] = _np(self._last_ystar)
        if self._pool_edited:
            # only edited engines carry this block (the reference's layout):
            # resume rebuilds the engine on the live pool, and C is pinned
            # because the grid can no longer be derived from that pool
            d["pool_edit"] = {"pool": _np(self.pool), "ids": self._ids.copy(),
                              "next_id": int(self._next_id),
                              "C": int(self._C)}
        return d

    def _check_snapshot(self, d: dict) -> None:
        """Refuse a snapshot of another format, engine kind,
        bucket/incremental flags or pool shape."""
        self._check_live()
        if d.get("format") != ENGINE_STATE_FORMAT:
            raise ValueError(
                f"engine snapshot format {d.get('format')!r} is not the "
                f"supported format {ENGINE_STATE_FORMAT}")
        if d.get("kind") != type(self).__name__:
            raise ValueError(f"snapshot was taken from a {d.get('kind')!r}, "
                             f"not a {type(self).__name__}")
        for key in ("incremental", "bucket"):
            if d.get(key) != getattr(self, key):
                raise ValueError(
                    f"snapshot {key}={d.get(key)!r} does not match this "
                    f"engine's {key}={getattr(self, key)!r}")
        if list(d.get("pool_shape", [])) != self._pool_shape():
            raise ValueError(
                f"snapshot pool shape {d.get('pool_shape')} does not match "
                f"this engine's pool {self._pool_shape()}: resume must "
                "use the identical candidate pool")

    def _load_base_state_dict(self, d: dict) -> None:
        """Restore the shared half (validates it with
        :meth:`_check_snapshot`, and the chunk grid)."""
        self._check_snapshot(d)
        pe = d.get("pool_edit")
        if pe is not None:
            if not np.array_equal(np.asarray(pe["pool"], np.float32),
                                  self.pool.cpu().numpy()):
                raise ValueError(
                    "snapshot was taken after pool edits and its pool "
                    "content does not match this engine's pool — rebuild "
                    "the engine on the live (edited) pool the driver "
                    "checkpointed alongside this snapshot")
            self._ids = np.asarray(pe["ids"], np.int64).copy()
            self._next_id = int(pe["next_id"])
            self._pool_edited = True
            if int(pe["C"]) != self._C:
                # the snapshot's C was resolved against the original pool
                self._C = int(pe["C"])
                self._regrid()
        self._P = int(d["P"])
        self._n_at_last_select = int(d["n_at_last_select"])
        self.stats = EngineStats.from_dict(d["stats"])
        if "state" in d:
            st = d["state"]
            V = np.asarray(st["V"], np.float32)
            if V.shape[-1] != self._C or V.shape[-4] != self._nc:
                raise ValueError(
                    f"snapshot V cache has chunk grid nc={V.shape[-4]}, "
                    f"C={V.shape[-1]} but this engine resolved nc="
                    f"{self._nc}, C={self._C}: resume with the pool_chunk "
                    "the snapshot was taken with")
            self._state = EngineState(
                _params_from_np(st["params"], self.device),
                _params_from_np(st["params_ref"], self.device),
                torch.tensor(np.asarray(st["L"], np.float32),
                             device=self.device),
                torch.tensor(V, device=self.device))
        else:
            self._state = None
        self._last_params = (_params_from_np(d["last_params"], self.device)
                             if "last_params" in d else None)
        lb = d.get("last_batch")
        self._last_batch = (None if lb is None else
                            (np.array(lb["rows_pad"], np.int32),
                             np.array(lb["y_pad"], np.float32),
                             np.array(lb["mask"], np.float32)))
        self._last_ystar = (None if d.get("last_ystar") is None else
                            torch.tensor(np.asarray(d["last_ystar"],
                                                    np.float32),
                                         device=self.device))


class BOEngine(_EngineBase):
    """Persistent surrogate + acquisition engine for one scenario::

        engine = BOEngine(pool_icd, gp_steps=150)    # on cuda by default
        engine.observe(init_rows, y_init)            # raw (minimized) metrics
        for _ in range(T):
            sub, eps = draws.round(N, 512, m, s)
            nxt = engine.select(eps, sub)            # one BO round
            engine.observe([nxt], flow(pool_idx[nxt][None]))

    The pool ``pool_icd`` [N, d] (numpy or tensor) is moved to ``device``
    (default ``cuda``; the CPU only when asked for) and every round runs
    there. See the module docstring for the two paths. ``pool_chunk``
    (``None`` | int | ``"auto"``, incremental only) sets the chunk width;
    any width picks the same rows. ``profile_stages`` (incremental only)
    times each stage of a select round (``PROFILE_STAGES``: the fit, the
    factor update, the frontier sample and the round's one K4 call), each
    ended by a device synchronize, into ``stats.stage_wall_s``; the round
    computes what it computes unprofiled.
    """

    #: round stages of one exact round (fit, posterior cache, frontier
    #: sampling, predict, scoring) — the ``dispatches`` counter's unit
    EXACT_DISPATCHES_PER_ROUND = 5

    def __init__(self, pool_icd, *, incremental: bool = True,
                 warm_start: bool | None = None, gp_steps: int = 150,
                 warm_steps: int | None = None, drift_tol: float = 1.0,
                 bucket: int = PAD_BUCKET, s_frontiers: int = 10,
                 weights=None, pool_chunk: int | str | None = None,
                 profile_stages: bool = False, device=None):
        self._configure(pool_icd, incremental=incremental,
                        warm_start=warm_start, gp_steps=gp_steps,
                        warm_steps=warm_steps, drift_tol=drift_tol,
                        bucket=bucket, s_frontiers=s_frontiers,
                        weights=weights, pool_chunk=pool_chunk, device=device)
        if profile_stages and not self.incremental:
            raise ValueError("profile_stages requires incremental=True: the "
                             "exact path has no profiled round")
        self.profile_stages = bool(profile_stages)
        self._rows: list[int] = []
        self._y: np.ndarray | None = None       # [k, m] raw minimized metrics
        self._eval_mask = torch.zeros(self.N, dtype=torch.bool,
                                      device=self.device)

    # ------------------------------------------------------------- observe
    def observe(self, rows, y) -> None:
        """Append flow evaluations: pool rows + raw (minimized) metrics."""
        self._check_live()
        rows = [int(r) for r in np.asarray(rows).reshape(-1)]
        y = np.atleast_2d(np.asarray(y, np.float32))
        if len(rows) != y.shape[0]:
            raise ValueError(f"observe: {len(rows)} rows but {y.shape[0]} metric rows")
        if not rows:
            return
        self._rows.extend(rows)
        self._y = y if self._y is None else np.concatenate([self._y, y], 0)
        self._eval_mask[torch.as_tensor(rows, device=self.device)] = True

    @property
    def m(self) -> int:
        if self._y is None:
            raise RuntimeError("engine has no observations yet")
        return self._y.shape[1]

    def _weights(self) -> torch.Tensor:
        return (torch.ones(self.m, device=self.device) if self.weights is None
                else self.weights)

    # -------------------------------------------------------------- select
    def select(self, eps, sub_rows=None) -> int:
        """Run one BO round and return the next pool row to evaluate.

        ``eps`` [m, q, s] are the standard normals of the joint frontier
        draw over ``sub_rows`` (q rows; the whole pool when None)."""
        self._check_live()
        if self._y is None or not self._rows:
            raise RuntimeError("select() before observe(): nothing to fit")
        if self.incremental:
            return self._select_incremental(eps, sub_rows)
        return self._select_exact(eps, sub_rows)

    def select_q(self, eps, q: int = 1, sub_rows=None, *,
                 pending: Sequence[int] = (),
                 fantasy: str = "mean") -> list[int]:
        """Select ``q`` distinct candidates in one round via fantasy updates.

        After the round's first pick its outcome is imputed (``fantasy`` in
        ``FANTASY_MODES``), L is block-updated, the pool re-scored under the
        round's frozen ``y*`` and the next candidate picked. ``pending`` rows
        (evaluations still in flight) are fantasized before any new pick.
        ``q=1`` with no ``pending`` is :meth:`select`."""
        self._check_live()
        pending = [int(r) for r in pending]
        if q < 1:
            raise ValueError(f"select_q: q must be >= 1, got {q}")
        if fantasy not in FANTASY_MODES:
            raise ValueError(f"select_q: fantasy must be one of "
                             f"{FANTASY_MODES}, got {fantasy!r}")
        if q == 1 and not pending:
            return [self.select(eps, sub_rows)]
        if not self.incremental:
            raise ValueError(
                "q-batch / pending fantasy selection requires "
                "incremental=True: fantasy appends reuse the incremental "
                "engine's trailing Cholesky + V-cache updates")
        if self._y is None or not self._rows:
            raise RuntimeError("select_q() before observe(): nothing to fit")
        n_fant = len(pending) + q - 1
        if len(set(self._rows)) + len(pending) + q > self.N:
            raise ValueError("select_q: pool has too few unevaluated rows "
                             f"for q={q} with {len(pending)} pending")

        # Round phase: fit + update-or-refactor + ONE frontier sample (+ the
        # first pick when nothing is pending); `reserve` pads rows for the
        # whole chain so no append grows the bucket mid-round.
        pick0 = self._select_incremental(eps, sub_rows, reserve=n_fant,
                                         do_select=not pending)
        n = self._n_at_last_select
        state = self._state
        rows_np, y_pad, mask_np = self._last_batch
        rows_pad = torch.as_tensor(rows_np, dtype=torch.int64,
                                   device=self.device)
        mask = torch.as_tensor(mask_np, device=self.device)
        yn, y_mean, y_std = _standardize(
            torch.as_tensor(y_pad, device=self.device), mask)
        s0 = (n // self.bucket) * self.bucket
        L, V, evalm = state.L, state.V, self._evalm_chunks()
        weights = self._weights()

        picks: list[int] = [] if pending else [pick0]
        to_append = list(pending)
        appended = 0
        try:
            while len(picks) < q:
                if not to_append:
                    to_append.append(picks[-1])
                row = to_append.pop(0)
                L, V, rows_pad, mask, yn, evalm, nxt = _fantasy_step(
                    state.params_ref, L, V, rows_pad, yn, mask, self._pool_c,
                    evalm, weights, y_mean, y_std, self._last_ystar, row,
                    n + appended, s0=s0, liar=fantasy)
                appended += 1
                self.stats.fantasy_steps += 1
                self.stats.dispatches += 1
                if not to_append:  # the last append before a fresh pick
                    picks.append(int(nxt))
        except BaseException:
            # K4 updates V in place; a broken chain leaves it half written.
            # Drop to a cold rebuild (observations are on the host).
            self._state = None
            self._P = 0
            raise
        # fantasy rows live in [s0, P), which the next round recomputes
        self._state = state._replace(L=L, V=V)
        return picks

    def _select_exact(self, eps, sub_rows) -> int:
        """A from-scratch round (``fit_gp`` + ``imoo_scores`` + host argmax)."""
        rows = np.asarray(self._rows)
        state = fit_gp(self.pool[torch.as_tensor(rows, device=self.device)],
                       torch.as_tensor(-self._y, device=self.device),
                       steps=self.gp_steps,
                       params=self._last_params if self.warm_start else None,
                       bucket=self.bucket)
        self._last_params = state.params
        fc = (self.pool if sub_rows is None else
              self.pool[torch.as_tensor(np.asarray(sub_rows),
                                        device=self.device)].contiguous())
        scores = imoo_scores(state, self.pool, self._eps(eps),
                             frontier_cand=fc,
                             weights=self.weights).cpu().numpy()
        scores[rows] = -np.inf  # never re-evaluate
        self.stats.rounds += 1
        self.stats.dispatches += self.EXACT_DISPATCHES_PER_ROUND
        self._n_at_last_select = len(self._rows)
        return int(np.argmax(scores))

    def _select_incremental(self, eps, sub_rows, *, reserve: int = 0,
                            do_select: bool = True) -> int:
        """One incremental round. ``reserve`` extra pad rows are provisioned
        for a following fantasy chain; ``do_select=False`` discards the pick
        (returns -1)."""
        n = len(self._rows)
        P = n + reserve
        P = P + (-P) % self.bucket
        grew = P != self._P
        first = self._state is None
        rows_np, y_pad, mask_np = self._padded_batch(self._rows, self._y, P)
        sub = (torch.arange(self.N, device=self.device) if sub_rows is None
               else torch.as_tensor(np.asarray(sub_rows, np.int64),
                                    device=self.device))
        cold, steps = self._fit_schedule(first)
        params0 = (default_params(self.m, self.d, self.device) if cold
                   else self._state.params)
        s0 = 0 if (first or grew) else \
            (self._n_at_last_select // self.bucket) * self.bucket
        state = self._alloc_state(params0, P, first or grew)
        mask = torch.as_tensor(mask_np, device=self.device)
        x = (self._pool_c.reshape(-1, self.d)[
                torch.as_tensor(rows_np, dtype=torch.int64, device=self.device)]
             + 10.0 * mask[:, None])
        yn, y_mean, y_std = _standardize(
            torch.as_tensor(y_pad, device=self.device), mask)
        force, eps_t, weights = bool(first or grew), self._eps(eps), \
            self._weights()
        t_round = time.perf_counter()
        state, nxt, did_ref, drift, ystar = _round_seq(
            state, x, yn, y_mean, y_std, mask, self._pool_c,
            self._evalm_chunks(), sub, eps_t, force, self.drift_tol, weights,
            steps=steps, s0=s0,
            timed=self._timed if self.profile_stages else _untimed)
        if self.profile_stages:
            acc = self.stats.stage_wall_s
            acc["round_total"] = (acc.get("round_total", 0.0)
                                  + (time.perf_counter() - t_round))
            # a profiled round runs its stages one by one: one dispatch each
            # (the bookkeeping below counts one)
            self.stats.dispatches += len(PROFILE_STAGES) - 1

        self._state = state
        self._P = P
        self._n_at_last_select = n
        self._last_batch = (rows_np, y_pad, mask_np)
        self._last_ystar = ystar
        self.stats.rounds += 1
        self.stats.dispatches += 1
        self.stats.frontier_resamples += 1
        self.stats.last_drift = float(drift)
        if did_ref:
            self.stats.refactors += 1
        else:
            self.stats.block_updates += 1
        return int(nxt) if do_select else -1

    def _timed(self, name: str, fn, *args, **kwargs):
        """The profile-mode stage hook of :func:`_round_seq`: ``fn(...)``
        ended by a device synchronize, its wall seconds added to
        ``stats.stage_wall_s[name]``."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self._sync()
        acc = self.stats.stage_wall_s
        acc[name] = acc.get(name, 0.0) + (time.perf_counter() - t0)
        return out

    # ------------------------------------------------------------- helpers
    def refactor_residual(self) -> float:
        """max |L_incremental − L_full| under the current ``params_ref``: the
        block-update error a full factorization would remove (a test hook;
        runs a full O(P³) factorization)."""
        if self._state is None or self._last_batch is None:
            raise RuntimeError("no incremental state yet")
        rows_np, _, mask_np = self._last_batch
        mask = torch.as_tensor(mask_np, device=self.device)
        x = (self._pool_c.reshape(-1, self.d)[
                torch.as_tensor(rows_np, dtype=torch.int64, device=self.device)]
             + 10.0 * mask[:, None])
        L_full = _chol_refactor(self._state.params_ref, x, mask)
        return float(torch.max(torch.abs(self._state.L - L_full)))

    # -------------------------------------------- state (de)serialization
    def state_dict(self) -> dict:
        """Complete engine snapshot in the reference's key layout: a nested
        dict of numpy arrays (copies, never views of live state) and
        JSON-able scalars. :meth:`load_state_dict` on a fresh engine (same
        pool, same knobs) continues the trajectory bit-exactly."""
        d = self._base_state_dict()
        d["rows"] = np.asarray(self._rows, np.int64)
        d["y"] = None if self._y is None else self._y.copy()
        return d

    def load_state_dict(self, d: dict) -> None:
        """Restore a :meth:`state_dict` snapshot (validates format, engine
        kind, bucket/incremental flags, pool shape and chunk grid)."""
        self._load_base_state_dict(d)
        self._rows = [int(r) for r in np.asarray(d["rows"]).reshape(-1)]
        self._y = (None if d.get("y") is None
                   else np.array(d["y"], np.float32))
        self._eval_mask = torch.zeros(self.N, dtype=torch.bool,
                                      device=self.device)
        if self._rows:
            self._eval_mask[torch.as_tensor(self._rows,
                                            device=self.device)] = True


def _drift_batch(params: GPParams, params_ref: GPParams) -> torch.Tensor:
    """[S] max |Δ| over each scenario's log-domain hyperparameter leaves."""
    return torch.stack([torch.abs(a - b).reshape(a.shape[0], -1).amax(1)
                        for a, b in zip(params, params_ref)]).amax(0)


def _scatter(old: torch.Tensor, new: torch.Tensor, idx: torch.Tensor):
    """``old`` with the scenarios ``idx`` taken from ``new`` (a copy)."""
    out = old.clone()
    out[idx] = new[idx]
    return out


def _on(device: torch.device):
    """The guard a scenario group's work runs under: its card current (so
    each kernel launches on that card's stream), nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _part(x, sl: slice):
    """A scenario group's slice of a per-scenario input (None stays
    None)."""
    return None if x is None else x[sl]


class BatchedBOEngine(_EngineBase):
    """:class:`BOEngine` with a leading scenario axis [S]: the fleet's
    backend (``repro.core.engine.BatchedBOEngine``)::

        engine = BatchedBOEngine(pool_icd_stack)     # [S, N, d], on cuda
        engine.observe(rows_per_scenario, ys_per_scenario)
        picks = engine.select(eps, sub_rows)         # eps [S, m, q, s]

    ``eps`` holds each scenario's normals (one ``TunerDraws.round`` a
    scenario; a sequence of S arrays is stacked), ``sub_rows`` [S, q] its
    frontier subsets (None: the whole pool).

    The exact path (``incremental=False``) runs the reference's fleet round:
    ``pad_training`` to the fleet-wide padded size, ``fit_gp_batch`` (one
    Adam loop for the whole fleet), ``imoo_scores_batch``, then masking and
    a first-index argmax per scenario on the host.

    The incremental path: the warm fits of every scenario in one Adam loop
    and each scenario's drift (phase 1); then, decided on the host per
    scenario in float32 against ``drift_tol``, a refactor or a block update
    of its factors (phase 2). A fresh or grown padded size refactors the
    whole fleet; otherwise only the drifting scenarios refactor, and a
    mixed round runs each group on its own and scatters L, V, y* and the
    picks back, with ``params_ref`` mixed per scenario. The factors and the
    frontier samples of a group are one batch of G·m.

    **K4 runs once per scenario a round, one scenario after another on one
    stream**, as the reference's vmapped round calls ``round_score_auto``
    once a scenario: every K4 call on a device shares one scratch buffer
    (``kernels/round_fused.py::_scratch``), so scenarios on streams of their
    own need a scratch a stream first. K4 writes each scenario's V rows in
    place into the cached [S, nc, m, P, C] tensor.

    ``mesh`` (a :class:`repro_torch.parallel.sharding.Mesh`; the
    reference's ``shard_map`` of the scenario axis) splits the fleet into
    scenario groups, one a device of the mesh axis ``mesh_axis`` (default:
    the mesh's first axis; over any other axis the reference replicates,
    and the port runs each group once, on the first device of its slice).
    ``S`` must divide evenly over that axis, and a mesh requires
    ``incremental=True``. Scenarios ``[g·S/G, (g+1)·S/G)`` live on device
    g: a batched engine of their own holds their pool slice, factors, V
    cache, masks and hyperparameters, and no tensor of one group touches
    another device inside a round. A round issues phase 1 on every group
    before the host reads any group's drift, then phase 2 on every group,
    and gathers the [S] picks in scenario order. As in the reference, the
    refactor decision under a mesh is **fleet-wide**: a fresh or grown
    padded size, or nothing reusable (s0 <= 0), refactors every scenario,
    and so does any one scenario's drift past ``drift_tol``. A mesh run
    therefore picks what the unsharded run picks only where the unsharded
    run has no mixed round; there it does so bit for bit on the card too,
    as each group pads its batched GP work to the fleet's S
    (:meth:`_fleet_index`). This engine then keeps only the host's
    bookkeeping (observations, the refactor decision, ``stats``, which
    count fleet rounds as one engine does); the groups hold every device
    array. :meth:`state_dict` gathers the groups into the unsharded layout
    and :meth:`load_state_dict` scatters it.
    """

    #: fit_gp_batch, frontier + predict, scores: the ``dispatches`` unit
    EXACT_DISPATCHES_PER_ROUND = 3

    def __init__(self, pool_icd, *, incremental: bool = True,
                 warm_start: bool | None = None, gp_steps: int = 150,
                 warm_steps: int | None = None, drift_tol: float = 1.0,
                 bucket: int = PAD_BUCKET, s_frontiers: int = 10,
                 weights=None, pool_chunk: int | str | None = None,
                 mesh=None, mesh_axis: str | None = None, device=None):
        # weights: [S, m] per-scenario acquisition weights or None (None
        # stays None: the unweighted scores, bit for bit)
        pool = self._configure(pool_icd, incremental=incremental,
                               warm_start=warm_start, gp_steps=gp_steps,
                               warm_steps=warm_steps, drift_tol=drift_tol,
                               bucket=bucket, s_frontiers=s_frontiers,
                               weights=weights, pool_chunk=pool_chunk,
                               device=device, hold_pool=mesh is None)
        if pool.dim() != 3:
            raise ValueError("BatchedBOEngine: pool_icd must be [S, N, d], "
                             f"got {tuple(pool.shape)}")
        self.S = pool.shape[0]
        self._rows: list[list[int]] = [[] for _ in range(self.S)]
        self._ys: list[np.ndarray | None] = [None] * self.S
        self.mesh = mesh
        self.mesh_axis = None
        self._groups: list[BatchedBOEngine] | None = None
        self._slices = [slice(0, self.S)]
        #: the batch a mesh group pads its GP work to (the fleet's S)
        self._batch_S: int | None = None
        if mesh is None:
            self._eval_mask = torch.zeros((self.S, self.N), dtype=torch.bool,
                                          device=self.device)
            return
        if not self.incremental:
            raise ValueError(
                "mesh sharding requires incremental=True: the exact "
                "historical path is host-driven per round")
        self.mesh_axis = mesh_axis or mesh.axis_names[0]
        ndev = dict(zip(mesh.axis_names, mesh.devices.shape))[self.mesh_axis]
        if self.S % ndev:
            raise ValueError(
                f"fleet size S={self.S} must divide evenly over the "
                f"{ndev} devices of mesh axis {self.mesh_axis!r}")
        size = self.S // ndev
        self._slices = [slice(g * size, (g + 1) * size) for g in range(ndev)]
        self._groups = []
        for sl, dev in zip(self._slices, mesh.axis_devices(self.mesh_axis)):
            grp = BatchedBOEngine(
                pool[sl], incremental=True, warm_start=self.warm_start,
                gp_steps=self.gp_steps, warm_steps=self.warm_steps,
                drift_tol=self.drift_tol, bucket=self.bucket,
                s_frontiers=self.s_frontiers,
                weights=(None if self.weights is None
                         else self.weights[sl].cpu().numpy()),
                pool_chunk=self._C, device=dev)
            grp._batch_S = self.S
            self._groups.append(grp)

    @property
    def m(self) -> int:
        if self._ys[0] is None:
            raise RuntimeError("engine has no observations yet")
        return self._ys[0].shape[1]

    def _engines(self) -> list:
        """The engines that run rounds: the groups under a mesh, else
        this one."""
        return self._groups or [self]

    def _pool_shape(self) -> list:
        return [self.S, self.N, self.d]

    def _weights(self) -> torch.Tensor:
        return (torch.ones((self.S, self.m), device=self.device)
                if self.weights is None else self.weights)

    def _sub(self, sub_rows) -> torch.Tensor:
        """[S, q] frontier rows on the device (the whole pool when None)."""
        if sub_rows is None:
            return torch.arange(self.N, device=self.device).expand(
                self.S, self.N)
        return torch.as_tensor(np.asarray(sub_rows, np.int64),
                               device=self.device)

    # ------------------------------------------------------------- observe
    def observe(self, rows_per_scenario: Sequence,
                ys_per_scenario: Sequence) -> None:
        """Append per-scenario evaluations (lists of rows, [k, m] raw
        metrics); a scenario's entry may be empty."""
        self._check_live()
        if len(rows_per_scenario) != self.S or len(ys_per_scenario) != self.S:
            raise ValueError(f"expected {self.S} per-scenario entries")
        scat_s, scat_r = [], []
        for si, (rows, y) in enumerate(zip(rows_per_scenario,
                                           ys_per_scenario)):
            rows = [int(r) for r in np.asarray(rows).reshape(-1)]
            if not rows:
                continue
            y = np.atleast_2d(np.asarray(y, np.float32))
            if len(rows) != y.shape[0]:
                raise ValueError(f"observe: scenario {si} has {len(rows)} "
                                 f"rows but {y.shape[0]} metric rows")
            self._rows[si].extend(rows)
            self._ys[si] = (y if self._ys[si] is None
                            else np.concatenate([self._ys[si], y], 0))
            scat_s += [si] * len(rows)
            scat_r += rows
        if self._groups is not None:
            for grp, sl in zip(self._groups, self._slices):
                grp.observe(list(rows_per_scenario)[sl],
                            list(ys_per_scenario)[sl])
        elif scat_r:
            self._eval_mask[torch.as_tensor(scat_s, device=self.device),
                            torch.as_tensor(scat_r, device=self.device)] = True

    # -------------------------------------------------------------- select
    def select(self, eps, sub_rows=None) -> np.ndarray:
        """One fleet round; returns the next pool row of each scenario [S]."""
        self._check_live()
        if any(y is None for y in self._ys):
            raise RuntimeError("select() before observe(): nothing to fit")
        if self.incremental:
            return self._select_incremental(eps, sub_rows)
        return self._select_exact(eps, sub_rows)

    def select_q(self, eps, q: int = 1, sub_rows=None, *,
                 pending: Sequence[Sequence[int]] | None = None,
                 fantasy: str = "mean") -> np.ndarray:
        """Select ``q`` candidates a scenario in one round via fantasy
        updates (:meth:`BOEngine.select_q` for each scenario); returns an
        [S, q] int array.

        ``pending`` holds each scenario's rows still in flight (ragged):
        shorter chains are front-padded with steps that leave the scenario
        as it is, so every scenario's first pick lands on the same step.
        Each scenario's y* from the round is frozen across the chain. ``q=1``
        with nothing pending is :meth:`select`. As in the reference, a
        scenario that runs out of unevaluated rows mid-chain may repeat
        picks; the caller consumes at most ``N − #evaluated − #pending``
        fresh picks a scenario. Under a mesh each group runs its scenarios'
        chains on its device, step by step with the others."""
        self._check_live()
        pending = ([[] for _ in range(self.S)] if pending is None
                   else [[int(r) for r in p] for p in pending])
        if len(pending) != self.S:
            raise ValueError(f"select_q: pending must have {self.S} "
                             f"per-scenario entries, got {len(pending)}")
        if q < 1:
            raise ValueError(f"select_q: q must be >= 1, got {q}")
        if fantasy not in FANTASY_MODES:
            raise ValueError(f"select_q: fantasy must be one of "
                             f"{FANTASY_MODES}, got {fantasy!r}")
        if q == 1 and not any(pending):
            return np.asarray(self.select(eps, sub_rows)).reshape(self.S, 1)
        if not self.incremental:
            raise ValueError(
                "q-batch / pending fantasy selection requires "
                "incremental=True: fantasy appends reuse the incremental "
                "engine's trailing Cholesky + V-cache updates")
        if any(y is None for y in self._ys):
            raise RuntimeError("select_q() before observe(): nothing to fit")
        for si in range(self.S):
            if len(set(self._rows[si])) + len(pending[si]) > self.N:
                raise ValueError(
                    f"select_q: scenario {si}'s evaluated + pending rows "
                    f"exceed the pool ({len(pending[si])} pending, pool "
                    f"{self.N}): pending must be unevaluated pool rows")
        k_max = max(len(p) for p in pending)

        picks0 = self._select_incremental(eps, sub_rows,
                                          reserve=k_max + q - 1,
                                          do_select=(k_max == 0))
        s0 = (self._n_at_last_select // self.bucket) * self.bucket
        engines = self._engines()
        chains = [[None] * (k_max - len(p)) + list(p) for p in pending]
        picks: list[list[int]] = ([[] for _ in range(self.S)] if k_max
                                  else [[int(x)] for x in picks0])
        ns = [len(r) for r in self._rows]
        appended = [0] * self.S
        try:
            chain = []
            for e in engines:
                with _on(e.device):
                    chain.append(e._chain_start())
            for step in range(k_max + q - 1):
                need_pick = step >= k_max - 1
                nxt = []
                for e, ctx, sl in zip(engines, chain, self._slices):
                    idx = range(self.S)[sl]
                    rows = [chains[si][step] if step < k_max
                            else picks[si][-1] for si in idx]
                    with _on(e.device):
                        nxt.append(e._chain_step(
                            ctx, rows, [ns[si] + appended[si] for si in idx],
                            s0=s0, fantasy=fantasy, need_pick=need_pick))
                    for si, row in zip(idx, rows):
                        if row is not None:
                            appended[si] += 1
                            self.stats.fantasy_steps += 1
                self.stats.dispatches += 1
                if need_pick:  # every group's launches issued: gather
                    flat = [p for part in nxt
                            for p in torch.stack(part).tolist()]
                    for si, p in enumerate(flat):
                        picks[si].append(int(p))
        except BaseException:
            # K4 updates V in place; a broken chain leaves it half written.
            # Drop to a cold rebuild (observations are on the host).
            for e in engines + [self]:
                e._state = None
                e._P = 0
            raise
        # fantasy rows live in [s0, P), which the next round recomputes
        for e, ctx in zip(engines, chain):
            e._state = e._state._replace(L=torch.stack(ctx["L"]), V=ctx["V"])
        return np.asarray(picks, np.int64)

    def _chain_start(self) -> dict:
        """This engine's per-scenario fantasy state after a round phase."""
        rows_np, y_pad, mask_np = self._last_batch
        dev = self.device
        mask = list(torch.as_tensor(mask_np, device=dev))
        yt = torch.as_tensor(y_pad, device=dev)
        yn, y_mean, y_std = map(list, zip(*(_standardize(yt[si], mask[si])
                                            for si in range(self.S))))
        return dict(rows_pad=list(torch.as_tensor(rows_np, dtype=torch.int64,
                                                  device=dev)),
                    mask=mask, yn=yn, y_mean=y_mean, y_std=y_std,
                    L=list(self._state.L), V=self._state.V,
                    evalm=list(self._evalm_chunks()), weights=self._weights())

    def _chain_step(self, ctx: dict, rows: list, pos: list, *, s0: int,
                    fantasy: str, need_pick: bool) -> list:
        """One fantasy step of each of this engine's scenarios: ``rows[i]``
        is appended at pad position ``pos[i]`` (None: the scenario idles).
        Returns the picks (0-dim tensors) when ``need_pick``; an idle
        scenario's is the round's own pick under its frozen state."""
        out = []
        state, ystar, pool_c = self._state, self._last_ystar, self._pool_c
        for si, row in enumerate(rows):
            pr = take(state.params_ref, si)
            if row is not None:
                (ctx["L"][si], _, ctx["rows_pad"][si], ctx["mask"][si],
                 ctx["yn"][si], ctx["evalm"][si], nxt) = _fantasy_step(
                    pr, ctx["L"][si], ctx["V"][si], ctx["rows_pad"][si],
                    ctx["yn"][si], ctx["mask"][si], pool_c[si],
                    ctx["evalm"][si], ctx["weights"][si], ctx["y_mean"][si],
                    ctx["y_std"][si], ystar[si], row, pos[si], s0=s0,
                    liar=fantasy)
            elif need_pick:  # an idle step: the round's own pick
                x = (pool_c[si].reshape(-1, self.d)[ctx["rows_pad"][si]]
                     + 10.0 * ctx["mask"][si][:, None])
                _, nxt = _round_fused(
                    pr, ctx["L"][si], ctx["V"][si], x,
                    _train_beta(ctx["L"][si], ctx["yn"][si]), ystar[si],
                    pool_c[si], ctx["evalm"][si], ctx["y_mean"][si],
                    ctx["y_std"][si], ctx["weights"][si], self._P)
            if need_pick:
                out.append(nxt)
        return out

    def _select_exact(self, eps, sub_rows) -> np.ndarray:
        """The reference's exact fleet round: every scenario padded to the
        fleet-wide size, ``fit_gp_batch``, ``imoo_scores_batch``, host
        masking and argmax."""
        n_max = max(len(r) for r in self._rows)
        P = n_max + (-n_max) % self.bucket
        dev = self.device
        xs, ys, masks = [], [], []
        for si in range(self.S):
            rows = torch.as_tensor(np.asarray(self._rows[si]), device=dev)
            xp, yp, mk = pad_training(
                self.pool[si][rows],
                torch.as_tensor(-self._ys[si], device=dev), P)
            xs.append(xp), ys.append(yp), masks.append(mk)
        gp_states = fit_gp_batch(
            torch.stack(xs), torch.stack(ys), torch.stack(masks),
            steps=self.gp_steps,
            params=self._last_params if self.warm_start else None)
        self._last_params = gp_states.params
        sub = None if sub_rows is None else self._sub(sub_rows)
        fc = (None if sub is None else self.pool[
            torch.arange(self.S, device=dev)[:, None], sub])
        scores = imoo_scores_batch(gp_states, self.pool, self._eps(eps),
                                   frontier_cand=fc,
                                   weights=self.weights).cpu().numpy()
        picks = np.empty((self.S,), np.int64)
        for si in range(self.S):
            s_row = scores[si]
            s_row[np.asarray(self._rows[si])] = -np.inf  # never re-evaluate
            picks[si] = int(np.argmax(s_row))
        self.stats.rounds += 1
        self.stats.dispatches += self.EXACT_DISPATCHES_PER_ROUND
        self._n_at_last_select = min(len(r) for r in self._rows)
        self._P = P
        return picks

    def _select_incremental(self, eps, sub_rows, *, reserve: int = 0,
                            do_select: bool = True) -> np.ndarray:
        """One incremental fleet round. ``reserve`` extra pad rows are
        provisioned beyond the fleet-wide largest training set for a
        following fantasy chain; ``do_select=False`` discards the picks
        (returns -1s). Under a mesh every group runs phase 1, then the
        host decides fleet-wide, then every group runs phase 2."""
        n_max = max(len(r) for r in self._rows)
        P = n_max + reserve
        P = P + (-P) % self.bucket
        grew = P != self._P
        engines = self._engines()
        first = engines[0]._state is None
        S = self.S
        s0 = 0 if (first or grew) else \
            (self._n_at_last_select // self.bucket) * self.bucket
        ph1 = []
        for e in engines:  # phase 1 everywhere before any host read
            with _on(e.device):
                ph1.append(e._phase1(P, first, grew))
        drift = np.concatenate([r["drift"].cpu().numpy() for r in ph1])
        if first or grew or s0 <= 0:
            ref_idx = np.arange(S)
        else:
            ref_idx = np.flatnonzero(drift > np.float32(self.drift_tol))
            if self._groups is not None and ref_idx.size:
                ref_idx = np.arange(S)  # a mesh decides fleet-wide
        upd_idx = np.setdiff1d(np.arange(S), ref_idx)
        picks = []
        for e, r, sl in zip(engines, ph1, self._slices):
            mine = ref_idx[(ref_idx >= sl.start) & (ref_idx < sl.stop)]
            with _on(e.device):
                picks.append(e._phase2(r, mine - sl.start, s0,
                                       _part(eps, sl), _part(sub_rows, sl)))
        if ref_idx.size == S:
            self.stats.refactors += 1
        elif upd_idx.size == S:
            self.stats.block_updates += 1
        else:
            self.stats.mixed_rounds += 1
            self.stats.dispatches += 1  # the group split costs one extra
        self.stats.scenario_refactors += int(ref_idx.size)
        self.stats.scenario_block_updates += int(upd_idx.size)
        self._P = P
        self._n_at_last_select = min(len(r) for r in self._rows)
        self.stats.rounds += 1
        self.stats.dispatches += 2
        self.stats.frontier_resamples += 1
        self.stats.last_drift = float(drift.max())
        if not do_select:
            return np.full((S,), -1, np.int64)
        return np.concatenate([p.cpu().numpy() for p in picks]).astype(
            np.int64)

    def _fleet_index(self, idx: torch.Tensor) -> torch.Tensor:
        """``idx`` (scenarios of this engine), on a mesh group followed by
        copies of its first entry up to the whole fleet's S: a group runs
        its batched GP work (the fit, the factors, the solves and the
        frontier samples) at the unsharded fleet's batch, since on the card
        torch's batched solves and reductions pick their plan, and so a
        GP's bits, by the batch's size."""
        k = (self._batch_S or 0) - idx.numel()
        return idx if k <= 0 else torch.cat([idx, idx[:1].expand(k)])

    def _phase1(self, P: int, first: bool, grew: bool) -> dict:
        """Phase 1 of a round on this engine's scenarios: the padded batch,
        the warm fits in one Adam loop and each scenario's drift (left on
        the device)."""
        S, dev = self.S, self.device
        padded = [self._padded_batch(self._rows[si], self._ys[si], P)
                  for si in range(S)]
        rows_np, y_pad, mask_np = (np.stack([p[k] for p in padded])
                                   for k in range(3))
        cold, steps = self._fit_schedule(first)
        if cold:
            p0 = default_params(self.m, self.d, dev)
            params0 = GPParams(*(t.expand(S, *t.shape) for t in p0))
        else:
            params0 = self._state.params
        state = self._alloc_state(params0, P, first or grew)
        mask = torch.as_tensor(mask_np, device=dev)
        pool_flat = self._pool_c.reshape(S, self._N_pad, self.d)
        sidx = torch.arange(S, device=dev)
        x = (pool_flat[sidx[:, None],
                       torch.as_tensor(rows_np, dtype=torch.int64, device=dev)]
             + 10.0 * mask[:, :, None])
        yt = torch.as_tensor(y_pad, device=dev)
        yn, y_mean, y_std = (torch.stack(t) for t in zip(
            *(_standardize(yt[si], mask[si]) for si in range(S))))
        gi = self._fleet_index(torch.arange(S, device=dev))
        g = (lambda t: t) if gi.numel() == S else (lambda t: t[gi])
        params = take(_fit_batch(GPParams(*map(g, state.params)), g(x),
                                 g(yn), g(mask), steps), slice(0, S))
        return dict(P=P, batch=(rows_np, y_pad, mask_np), state=state,
                    params=params, x=x, yn=yn, y_mean=y_mean, y_std=y_std,
                    mask=mask, pool_flat=pool_flat,
                    drift=_drift_batch(params, state.params_ref))

    def _phase2(self, r: dict, ref_idx: np.ndarray, s0: int, eps,
                sub_rows) -> torch.Tensor:
        """Phase 2 of a round on this engine's scenarios: the scenarios
        ``ref_idx`` refactor, the rest block-update from ``s0``; each
        group's factors and frontier samples, then one K4 launch a scenario
        (V updated in place). Keeps the new state; returns the picks [S] on
        the device."""
        S, dev = self.S, self.device
        state, params, x, mask = r["state"], r["params"], r["x"], r["mask"]
        upd_idx = np.setdiff1d(np.arange(S), ref_idx)
        if upd_idx.size == 0:
            params_ref = params
        elif ref_idx.size == 0:
            params_ref = state.params_ref
        else:
            ri = torch.as_tensor(ref_idx, device=dev)
            params_ref = GPParams(*(_scatter(o, n, ri) for n, o in
                                    zip(params, state.params_ref)))
        sub, eps_t = self._sub(sub_rows), self._eps(eps)
        evalm, weights = self._evalm_chunks(), self._weights()
        L = torch.empty_like(state.L)
        ystar = torch.empty((S, self.s_frontiers, self.m), device=dev)
        picks_t = [None] * S
        for idx, refactor in ((ref_idx, True), (upd_idx, False)):
            if not idx.size:
                continue
            n = idx.size
            ii = torch.as_tensor(idx, device=dev)
            gi = self._fleet_index(ii)
            whole = gi.numel() == n == S
            g = (lambda t: t) if whole else (lambda t: t[gi])
            pr = params_ref if whole else take(params_ref, gi)
            L_g = (_chol_refactor_batch(pr, g(x), g(mask)) if refactor else
                   _chol_block_batch(pr, g(state.L), g(x), g(mask), s0))
            beta, ystar_g = _beta_ystar_batch(pr, L_g, g(x), g(r["yn"]),
                                              g(r["y_mean"]), g(r["y_std"]),
                                              g(r["pool_flat"]), g(sub),
                                              g(eps_t))
            L_g, beta, ystar_g = L_g[:n], beta[:n], ystar_g[:n]
            L[ii], ystar[ii] = L_g, ystar_g
            for j, si in enumerate(idx):
                _, picks_t[si] = _round_fused(
                    take(pr, j), L_g[j], state.V[si], x[si], beta[j],
                    ystar_g[j], self._pool_c[si], evalm[si], r["y_mean"][si],
                    r["y_std"][si], weights[si], 0 if refactor else s0)
        self._state = EngineState(params, params_ref, L, state.V)
        self._P = r["P"]
        self._n_at_last_select = min(len(rows) for rows in self._rows)
        self._last_batch = r["batch"]
        self._last_ystar = ystar
        return torch.stack(picks_t)

    # ------------------------------------------ pool edits under a mesh
    # Under a mesh this engine keeps the host bookkeeping (rows, targets,
    # stats); the groups hold the pool, the evaluated masks and the state.
    def pool_append(self, cols) -> np.ndarray:
        if self._groups is None:
            return super().pool_append(cols)
        self._check_live()
        cols = self._check_cols(cols, "pool_append")
        n_old = self.N
        if cols.shape[-2]:
            self._edit_groups("pool_append", cols)
            self.N = self._groups[0].N
            self.stats.pool_appends += self.N - n_old
        return np.arange(n_old, self.N, dtype=np.int64)

    def pool_replace(self, rows, cols) -> None:
        if self._groups is None:
            return super().pool_replace(rows, cols)
        self._check_live()
        rows, cols = self._check_replace(rows, cols)  # the whole fleet's
        if len(rows):
            self._edit_groups("pool_replace", rows, cols)
            self.stats.pool_replacements += len(rows)

    def _edit_groups(self, name: str, *args) -> None:
        """Make a pool edit (the [S, k, d] columns last) in every group,
        each on its scenarios' columns; the V chunks the groups refresh,
        the same in each, count once."""
        *head, cols = args
        before = self._groups[0].stats.v_chunk_refreshes
        for grp, sl in zip(self._groups, self._slices):
            with _on(grp.device):
                getattr(grp, name)(*head, cols[sl])
        self.stats.v_chunk_refreshes += (
            self._groups[0].stats.v_chunk_refreshes - before)

    def _evaluated_any(self) -> np.ndarray:
        if self._groups is None:
            return super()._evaluated_any()
        return np.logical_or.reduce([g._evaluated_any()
                                     for g in self._groups])

    @property
    def candidate_ids(self) -> np.ndarray:
        # the groups edit the same columns, so they hold the same ids
        return (super() if self._groups is None
                else self._groups[0]).candidate_ids

    pool_append.__doc__ = _EngineBase.pool_append.__doc__
    pool_replace.__doc__ = _EngineBase.pool_replace.__doc__
    candidate_ids.__doc__ = _EngineBase.candidate_ids.__doc__

    def pool_scores(self) -> np.ndarray:
        if self._groups is None:
            return super().pool_scores()
        self._check_live()
        out = []
        for grp in self._groups:
            with _on(grp.device):
                out.append(grp.pool_scores())
        return np.concatenate(out)

    pool_scores.__doc__ = _EngineBase.pool_scores.__doc__

    def device_bytes(self) -> int:
        if self._groups is None:
            return super().device_bytes()
        return sum(g.device_bytes() for g in self._groups)

    device_bytes.__doc__ = _EngineBase.device_bytes.__doc__

    def release(self) -> None:
        super().release()
        for g in self._groups or ():
            g.release()

    release.__doc__ = _EngineBase.release.__doc__

    # -------------------------------------------- state (de)serialization
    #: the snapshot's per-scenario blocks a mesh gathers and scatters
    _GROUP_KEYS = ("state", "last_batch", "last_ystar")

    def state_dict(self) -> dict:
        """:meth:`BOEngine.state_dict` of the fleet: the training sets are
        ragged, so rows and targets are stored per scenario index. Under a
        mesh the groups' blocks are gathered along the scenario axis: the
        layout is the unsharded engine's."""
        d = (self._base_state_dict() if self._groups is None
             else self._gather_state_dict())
        d["rows"] = {str(si): np.asarray(r, np.int64)
                     for si, r in enumerate(self._rows)}
        d["ys"] = {str(si): None if y is None else y.copy()
                   for si, y in enumerate(self._ys)}
        return d

    def _gather_state_dict(self) -> dict:
        """The groups' snapshots joined along the scenario axis, with this
        engine's fleet-wide scalars and stats."""
        self._check_live()
        parts = [g.state_dict() for g in self._groups]
        d = dict(parts[0], pool_shape=self._pool_shape(), P=self._P,
                 n_at_last_select=self._n_at_last_select,
                 stats=self.stats.as_dict())
        for key in self._GROUP_KEYS:
            if key in d:
                d[key] = _cat_tree([p[key] for p in parts])
        if "pool_edit" in d:
            d["pool_edit"] = dict(d["pool_edit"], pool=np.concatenate(
                [p["pool_edit"]["pool"] for p in parts]))
        return d

    def load_state_dict(self, d: dict) -> None:
        """Restore a :meth:`state_dict` snapshot; under a mesh each group
        takes its scenarios' slice of it."""
        if self._groups is None:
            self._load_base_state_dict(d)
        else:
            self._scatter_state_dict(d)
        self._rows = [[int(r) for r in
                       np.asarray(d["rows"][str(si)]).reshape(-1)]
                      for si in range(self.S)]
        self._ys = [None if d["ys"].get(str(si)) is None
                    else np.array(d["ys"][str(si)], np.float32)
                    for si in range(self.S)]
        if self._groups is not None:
            return
        self._eval_mask = torch.zeros((self.S, self.N), dtype=torch.bool,
                                      device=self.device)
        scat_s = [si for si, rows in enumerate(self._rows) for _ in rows]
        scat_r = [r for rows in self._rows for r in rows]
        if scat_r:
            self._eval_mask[torch.as_tensor(scat_s, device=self.device),
                            torch.as_tensor(scat_r, device=self.device)] = True

    def _scatter_state_dict(self, d: dict) -> None:
        """Each group loads its scenarios' slice of the fleet's snapshot;
        this engine keeps the fleet-wide scalars and stats."""
        self._check_snapshot(d)
        for grp, sl in zip(self._groups, self._slices):
            idx = range(self.S)[sl]
            part = dict(d, pool_shape=grp._pool_shape(),
                        rows={str(i): d["rows"][str(si)]
                              for i, si in enumerate(idx)},
                        ys={str(i): d["ys"].get(str(si))
                            for i, si in enumerate(idx)})
            if "pool_edit" in d:
                part["pool_edit"] = dict(
                    d["pool_edit"],
                    pool=np.asarray(d["pool_edit"]["pool"])[sl])
            for key in self._GROUP_KEYS:
                if key in d:
                    part[key] = _slice_tree(d[key], sl)
            with _on(grp.device):
                grp.load_state_dict(part)
        self._P = int(d["P"])
        self._n_at_last_select = int(d["n_at_last_select"])
        self.stats = EngineStats.from_dict(d["stats"])


def _cat_tree(trees: list):
    """The groups' snapshot blocks (nested dicts of arrays) joined along
    the scenario axis."""
    if isinstance(trees[0], dict):
        return {k: _cat_tree([t[k] for t in trees]) for k in trees[0]}
    return np.concatenate(trees)


def _slice_tree(tree, sl: slice):
    """One group's scenarios of a snapshot block."""
    if isinstance(tree, dict):
        return {k: _slice_tree(v, sl) for k, v in tree.items()}
    return np.asarray(tree)[sl]

"""Between-round candidate proposal: escaping the fixed pool.

A port of ``repro.core.propose``. The paper scores a static candidate pool;
this perturbation proposer runs on top of the engines' mutable pools:

1. **Parents** are the evaluated designs on the current Pareto front (the
   union over scenarios for a fleet); the fronts are ``pareto_count``
   launches on the engine's device.
2. **Children** are sampled near the parents in the normalized encoded
   space (Gaussian perturbation, ``ProposerConfig.scale``), snapped back
   onto the design lattice with :meth:`DesignSpace.snap`, and deduplicated
   by content against the live pool (which holds every evaluated design)
   and against each other. Retries widen the perturbation by 25 % each.
3. **Victims** are the lowest-scoring unevaluated, non-pending pool columns
   under the engine's frozen round state (``pool_scores``: one score-only
   ``round_fused`` launch a scenario; a fleet takes the max over scenarios,
   so a column any scenario still values is kept), fed to ``pool_replace``.

The draws come from the run's :class:`repro_torch.random.TunerDraws`
``propose`` method, which never advances the round stream: a proposer-off
run is byte-identical to one without the knob. ``ProposerStats`` mirrors
``EngineStats``: host counters, folded into a metrics registry once per run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.random import PROPOSER_FOLD

from .pareto import pareto_mask

__all__ = ["PROPOSER_FOLD", "ProposerConfig", "ProposerStats",
           "ProposalOutcome", "pareto_parents", "propose_candidates",
           "propose_and_replace"]

#: ``draw(t, n, p, d) -> (picks [n] int64, eps [n, d] float32)``: one
#: proposal step's draws for try ``t`` (a ``TunerDraws.propose`` with the
#: round bound)
DrawFn = Callable[[int, int, int, int], tuple]


@dataclasses.dataclass(frozen=True)
class ProposerConfig:
    """Knobs of the between-round perturbation proposer (default off:
    ``enabled=False`` leaves every trajectory byte-identical).

    - ``every``: propose after every ``every``-th completed round.
    - ``n_propose``: replacement candidates a proposal step.
    - ``scale``: Gaussian perturbation stddev in the normalized encoded
      space (features lie in [0, 1]; retries widen it by 25 % each).
    - ``max_tries``: resampling rounds before giving up on a crowded
      neighborhood (fewer than ``n_propose`` unique candidates is fine).
    """

    enabled: bool = False
    every: int = 1
    n_propose: int = 4
    scale: float = 0.15
    max_tries: int = 8

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"proposer every must be >= 1, got {self.every}")
        if self.n_propose < 1:
            raise ValueError(
                f"proposer n_propose must be >= 1, got {self.n_propose}")
        if not (self.scale > 0.0):
            raise ValueError(f"proposer scale must be > 0, got {self.scale}")
        if self.max_tries < 1:
            raise ValueError(
                f"proposer max_tries must be >= 1, got {self.max_tries}")

    @classmethod
    def from_arg(cls, arg) -> "ProposerConfig":
        """Normalize a driver knob: None | bool | dict | ProposerConfig.
        Unknown dict keys raise."""
        if arg is None:
            return cls()
        if isinstance(arg, cls):
            return arg
        if isinstance(arg, bool):
            return cls(enabled=arg)
        if isinstance(arg, dict):
            fields = {f.name for f in dataclasses.fields(cls)}
            unknown = set(arg) - fields
            if unknown:
                raise ValueError(
                    f"unknown proposer knob(s): {sorted(unknown)} "
                    f"(known: {sorted(fields)})")
            return cls(**arg)
        raise TypeError(f"proposer must be None, bool, dict or "
                        f"ProposerConfig, got {type(arg).__name__}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ProposerStats:
    """Host-side proposer counters."""

    rounds: int = 0       # proposal steps that ran (empty ones included)
    proposed: int = 0     # unique novel candidates generated
    replaced: int = 0     # pool columns actually replaced
    wall_s: float = 0.0   # cumulative proposal wall seconds

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ProposerStats":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def fold_into(self, registry) -> None:
        """Add to a metrics registry (duck-typed: ``counter(name, help)
        .inc(v)``); call once per finished run, as ``EngineStats``."""
        if self.proposed:
            registry.counter("pool_proposed_total",
                             "novel candidates proposed").inc(self.proposed)
        if self.replaced:
            registry.counter("pool_replaced_total",
                             "pool columns replaced").inc(self.replaced)
        if self.rounds:
            registry.counter("proposer_rounds_total",
                             "proposal steps run").inc(self.rounds)
            registry.counter("proposer_seconds_total",
                             "proposal wall seconds").inc(self.wall_s)


@dataclasses.dataclass(frozen=True)
class ProposalOutcome:
    """One proposal step's result: ``pool_idx[victims] = new_idx`` is the
    driver's mirror of the engine's ``pool_replace``."""

    victims: np.ndarray   # [k] replaced pool rows
    new_idx: np.ndarray   # [k, d] their new index vectors
    n_proposed: int       # unique candidates generated (>= k)
    wall_s: float


def pareto_parents(pool_idx: np.ndarray, evaluated: Sequence[Sequence[int]],
                   ys: Sequence, device=None) -> np.ndarray:
    """Union of the per-scenario Pareto-front designs -> parent index
    vectors [p, d] (deduplicated by content, in order of first appearance).
    Each front is decided in float32 on ``device`` (one ``pareto_count``
    launch on a CUDA device). Evaluated rows are immutable, so
    ``pool_idx[row]`` is always the design that was scored."""
    pool_idx = np.asarray(pool_idx)
    seen: set[bytes] = set()
    parents: list[np.ndarray] = []
    for rows, y in zip(evaluated, ys):
        rows = np.asarray(list(rows), np.int64)
        if rows.size == 0 or y is None:
            continue
        yt = torch.as_tensor(np.asarray(y, np.float64), dtype=torch.float32,
                             device=device).contiguous()
        front = pareto_mask(yt).cpu().numpy()
        for r in rows[front[: len(rows)]]:
            vec = np.asarray(pool_idx[int(r)], np.int64)
            key = vec.tobytes()
            if key not in seen:
                seen.add(key)
                parents.append(vec)
    return (np.stack(parents) if parents
            else np.empty((0, pool_idx.shape[-1]), np.int64))


def propose_candidates(space, draw: DrawFn, parents_idx: np.ndarray, *,
                       n_propose: int, scale: float, exclude: set,
                       max_tries: int = 8) -> np.ndarray:
    """Sample up to ``n_propose`` novel design points near ``parents_idx``.

    Children are ``space.snap(space.encode(parent) + width·ε)`` in numpy
    float32 (the reference's arithmetic), with try ``t``'s draws from
    ``draw(t, n, p, d)`` and ``width = scale·(1 + 0.25·t)``; ``exclude``
    holds int64 index-vector ``tobytes()`` keys (the live pool). Returns
    [k, d] int64, k <= ``n_propose`` (0 when the neighborhood is full)."""
    parents_idx = np.asarray(parents_idx, np.int64)
    if parents_idx.size == 0 or n_propose < 1:
        return np.empty((0, parents_idx.shape[-1] if parents_idx.ndim == 2
                         else space.d), np.int64)
    parents_norm = space.encode(torch.as_tensor(parents_idx)).numpy()
    p, d = parents_norm.shape
    found: list[np.ndarray] = []
    seen = set(exclude)
    for t in range(max_tries):
        n_draw = max(2 * (n_propose - len(found)), 4)
        picks, eps = draw(t, n_draw, p, d)
        width = scale * (1.0 + 0.25 * t)  # widen on crowded retries
        xn = parents_norm[np.asarray(picks)] + width * np.asarray(eps,
                                                                  np.float32)
        children = space.snap(torch.from_numpy(xn)).numpy().astype(np.int64)
        for vec in children:
            b = vec.tobytes()
            if b in seen:
                continue
            seen.add(b)
            found.append(vec)
            if len(found) >= n_propose:
                return np.stack(found)
    return np.stack(found) if found else np.empty((0, d), np.int64)


def propose_and_replace(engine, space, draw: DrawFn, pool_idx: np.ndarray, *,
                        cfg: ProposerConfig,
                        encode_cols: Callable[[np.ndarray], torch.Tensor],
                        evaluated: Sequence[Sequence[int]], ys: Sequence,
                        pending: Sequence[int] = (),
                        stats: ProposerStats | None = None,
                        ) -> ProposalOutcome | None:
    """One proposal step against a live engine. Returns ``None`` when
    nothing was replaced; otherwise the caller must mirror the edit
    (``pool_idx[out.victims] = out.new_idx``) and drop any row-keyed
    evaluation memo of ``out.victims``.

    - ``encode_cols(new_idx [k, d])`` maps index vectors to the engine's
      features ([k, d] sequential, [S, k, d] batched): each scenario's
      ``transform_to_icd`` under its pruned space and importance vector.
    - ``evaluated``/``ys``: each scenario's evaluated rows and raw metrics
      (one-element lists for a sequential engine).
    - ``pending``: pool rows with evaluations in flight, never victims.
    """
    t0 = time.perf_counter()
    pool_idx = np.asarray(pool_idx)
    parents = pareto_parents(pool_idx, evaluated, ys, device=engine.device)
    exclude = {np.asarray(r, np.int64).tobytes() for r in pool_idx}
    cand = propose_candidates(space, draw, parents, n_propose=cfg.n_propose,
                              scale=cfg.scale, exclude=exclude,
                              max_tries=cfg.max_tries)
    wall = time.perf_counter() - t0
    if stats is not None:
        stats.rounds += 1
        stats.proposed += len(cand)
    if len(cand) == 0:
        if stats is not None:
            stats.wall_s += wall
        return None

    scores = engine.pool_scores()                       # [N] or [S, N]
    agg = scores if scores.ndim == 1 else scores.max(axis=0)
    blocked = np.zeros(agg.shape[0], bool)
    for rows in evaluated:
        rows = np.asarray(list(rows), np.int64)
        if rows.size:
            blocked[rows] = True
    pend = np.asarray(list(pending), np.int64)
    if pend.size:
        blocked[pend] = True
    agg = np.where(blocked, np.inf, agg)
    order = np.argsort(agg, kind="stable")
    order = order[np.isfinite(agg[order])]
    victims = np.asarray(order[: len(cand)], np.int64)
    if victims.size == 0:
        if stats is not None:
            stats.wall_s += time.perf_counter() - t0
        return None
    cand = cand[: victims.size]

    engine.pool_replace(victims, encode_cols(cand))
    wall = time.perf_counter() - t0
    if stats is not None:
        stats.replaced += int(victims.size)
        stats.wall_s += wall
    return ProposalOutcome(victims=victims, new_idx=cand,
                           n_proposed=len(cand), wall_s=wall)

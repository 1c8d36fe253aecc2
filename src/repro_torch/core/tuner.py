"""Algorithm 3 — SoC-Tuner(X, T, n, u, b, v_th): the full exploration loop.

Operates over a finite candidate *pool*; the flow is any callable
``idx [k,d] -> y [k,m]``. A port of ``repro.core.tuner.soc_tuner`` (the
exact and the incremental engine, q-batches): randomness comes from a
:class:`repro_torch.random.TunerDraws` object instead of a JAX key.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.progress import log_progress
from repro_torch.random import GeneratorDraws, TunerDraws

from .engine import BOEngine
from .icd import icd_from_data
from .pareto import adrs, pareto_mask
from .sampling import soc_init
from .space import DesignSpace

__all__ = ["TunerResult", "soc_tuner", "explore_prologue",
           "merge_trial_evals", "round_record"]

FlowFn = Callable[[np.ndarray], np.ndarray]


def merge_trial_evals(evaluated: "list[int]", y_init: np.ndarray,
                      trial_rows: np.ndarray, trial_y: np.ndarray,
                      reuse_icd_trials: bool) -> tuple["list[int]", np.ndarray]:
    """Alg. 3 line 4 bookkeeping: seed the GP with the TED-init evaluations
    plus (optionally) the ICD trial evaluations not already covered. The
    evaluation order defines the trajectory."""
    y_list = [np.asarray(y_init)]
    if reuse_icd_trials:
        seen = set(evaluated)
        fresh, keep = [], []
        for i, r in enumerate(trial_rows):
            r = int(r)
            if r not in seen:
                seen.add(r)
                fresh.append(r)
                keep.append(i)
        evaluated = evaluated + fresh
        y_list.append(np.asarray(trial_y)[keep])
    return evaluated, np.concatenate(y_list, axis=0)


def _front(y: np.ndarray, device) -> np.ndarray:
    """Pareto mask of ``y`` decided in float32 on ``device``."""
    yt = torch.as_tensor(np.asarray(y), dtype=torch.float32,
                         device=device).contiguous()
    return pareto_mask(yt).cpu().numpy()


def round_record(y: np.ndarray, n_evaluated: int, round_i: int,
                 reference_front: np.ndarray | None,
                 wall_s: float | None = None, device=None) -> dict:
    """One history entry for round ``round_i`` (the reference's keys)."""
    front = _front(y, resolve_device(device))
    rec = {"round": round_i, "evaluations": n_evaluated,
           "pareto_size": int(front.sum())}
    if reference_front is not None:
        rec["adrs"] = adrs(reference_front, y[front])
    if wall_s is not None:
        rec["wall_s"] = wall_s
    return rec


def explore_prologue(space: DesignSpace, pool_idx: np.ndarray, flow: FlowFn,
                     draws: TunerDraws, *, n: int, mu: float, b: int,
                     v_th: float, reuse_icd_trials: bool = True, device=None):
    """Algorithm 3 lines 1-4: ICD trials → importance → prune/TED-init →
    seed evaluations. Returns ``(v, pruned, pool_icd, evaluated, y)``."""
    N = pool_idx.shape[0]
    # Line 1: v = ICD(X, n), over trials drawn from the pool so their
    # metrics can seed the GP.
    trial_rows = np.asarray(draws.prologue(N, n))
    trial_y = np.asarray(flow(pool_idx[trial_rows]))
    v = icd_from_data(space, pool_idx[trial_rows], trial_y)

    # Line 2: Z = SoC-Init(X, µ, b, v, v_th)  (prune + ICD transform + TED)
    init_rows, pruned, pool_icd = soc_init(space, pool_idx, v, v_th=v_th,
                                           b=b, mu=mu, device=device)

    # Line 4: y <- VLSIFlow(Z)
    evaluated: list[int] = list(dict.fromkeys(int(r) for r in init_rows))
    y_init = np.asarray(flow(pool_idx[np.asarray(evaluated)]))
    evaluated, y = merge_trial_evals(evaluated, y_init, trial_rows, trial_y,
                                     reuse_icd_trials)
    return v, pruned, pool_icd, evaluated, y


@dataclasses.dataclass
class TunerResult:
    space: DesignSpace                # pruned space actually explored
    v: np.ndarray                     # ICD importance vector (Alg. 1)
    evaluated_rows: np.ndarray        # pool-row indices, in evaluation order
    y: np.ndarray                     # metrics for evaluated rows [k, m]
    pareto_rows: np.ndarray           # subset of evaluated_rows on the front
    pareto_y: np.ndarray              # their metrics (the learned Y*)
    history: list[dict]               # per-round log (for ADRS curves)
    wall_s: float
    engine_stats: dict | None = None

    def pareto_idx(self, pool_idx: np.ndarray) -> np.ndarray:
        """Design-point index vectors X* (Alg. 3 line 11)."""
        return np.asarray(pool_idx)[self.pareto_rows]


def soc_tuner(
    space: DesignSpace,
    pool_idx: np.ndarray,
    flow: FlowFn,
    *,
    T: int = 40,
    n: int = 30,
    mu: float = 0.1,
    b: int = 20,
    v_th: float = 0.07,
    s_frontiers: int = 10,
    frontier_subset: int = 512,
    gp_steps: int = 150,
    reference_front: np.ndarray | None = None,
    reuse_icd_trials: bool = True,
    weights: np.ndarray | None = None,
    incremental: bool = False,
    warm_start: bool | None = None,
    warm_steps: int | None = None,
    drift_tol: float = 1.0,
    pool_chunk: int | str | None = None,
    profile_stages: bool = False,
    q: int = 1,
    fantasy: str = "mean",
    checkpoint_dir: str | None = None,
    proposer=None,
    draws: TunerDraws | None = None,
    seed: int = 0,
    device=None,
    verbose: bool = False,
) -> TunerResult:
    """Run SoC-Tuner over ``pool_idx`` [N, d] candidate designs.

    Follows Algorithm 3 line by line; ``reference_front`` (the real Pareto
    front of the pool, if known) enables per-round ADRS logging. The GP and
    acquisition run on ``device`` (default ``cuda``; the CPU only when asked
    for). ``draws`` supplies the trial rows, frontier subsets and normals
    (default: :class:`GeneratorDraws` seeded with ``seed`` on ``device``).

    The rounds run on a :class:`BOEngine`: ``incremental=False`` is the
    from-scratch round; ``incremental=True`` warm-starts the fits, updates
    the Cholesky factor by blocks and scores the pool with the
    ``round_fused`` kernel. ``warm_start`` (default: follow ``incremental``),
    ``warm_steps``, ``drift_tol``, ``pool_chunk`` and ``profile_stages`` are
    the engine's knobs. ``q > 1`` (incremental only) picks q candidates per
    round by fantasy updates (``fantasy`` is the imputation rule) and
    evaluates them in one flow call. ``checkpoint_dir`` and ``proposer``
    belong to parts of the reference not ported yet and raise.
    """
    for name, unported in (("checkpoint_dir", checkpoint_dir is not None),
                           ("proposer", bool(proposer))):
        if unported:
            raise NotImplementedError(
                f"repro_torch.soc_tuner: {name} is not ported yet (ROADMAP "
                "queue 1)")
    if q < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    if q > 1 and not incremental:
        raise ValueError(
            "q > 1 requires incremental=True: fantasy q-batch selection "
            "runs on the incremental engine")
    t0 = time.monotonic()
    dev = resolve_device(device)
    # IEEE float32 products everywhere, never TF32: the GP and the TED
    # kernel need full float32 to pick what the reference picks.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    draws = GeneratorDraws(seed, dev) if draws is None else draws
    pool_idx = np.asarray(pool_idx)
    N = pool_idx.shape[0]

    v, pruned, pool_icd, evaluated, y = explore_prologue(
        space, pool_idx, flow, draws, n=n, mu=mu, b=b, v_th=v_th,
        reuse_icd_trials=reuse_icd_trials, device=dev)

    history: list[dict] = []
    t_round = time.monotonic()

    def log_round(i: int):
        nonlocal t_round
        now = time.monotonic()
        log_progress(history, y, len(evaluated), i, reference_front,
                     verbose=verbose, wall_s=now - t_round, device=dev)
        t_round = now

    log_round(0)

    # Lines 5-10: the BO loop. The engine negates targets (metrics are
    # minimized, MES maximizes) and owns the never-re-evaluate mask + argmax.
    engine = BOEngine(pool_icd, incremental=incremental,
                      warm_start=warm_start, gp_steps=gp_steps,
                      warm_steps=warm_steps, drift_tol=drift_tol,
                      s_frontiers=s_frontiers, weights=weights,
                      pool_chunk=pool_chunk, profile_stages=profile_stages,
                      device=dev)
    engine.observe(evaluated, y)
    for it in range(T):
        sub, eps = draws.round(N, frontier_subset, engine.m, s_frontiers)
        picks = engine.select_q(eps, q, sub_rows=sub, fantasy=fantasy)
        # Line 8: evaluate and append (one flow call for the whole batch)
        y_new = np.asarray(flow(pool_idx[np.asarray(picks)]))
        evaluated.extend(picks)
        y = np.concatenate([y, y_new], axis=0)
        engine.observe(picks, y_new)
        log_round(it + 1)

    front = _front(y, dev)
    rows = np.asarray(evaluated)
    return TunerResult(
        space=pruned, v=np.asarray(v), evaluated_rows=rows, y=y,
        pareto_rows=rows[front], pareto_y=y[front], history=history,
        wall_s=time.monotonic() - t0, engine_stats=engine.stats.as_dict())

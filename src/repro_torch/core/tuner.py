"""Algorithm 3 — SoC-Tuner(X, T, n, u, b, v_th): the full exploration loop.

Operates over a finite candidate *pool*; the flow is any callable
``idx [k,d] -> y [k,m]``. A port of ``repro.core.tuner.soc_tuner`` (the
exact and the incremental engine, q-batches, the between-round proposer,
checkpoints and resume): randomness comes from a
:class:`repro_torch.random.TunerDraws` object instead of a JAX key.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.progress import log_progress
from repro_torch.random import GeneratorDraws, TunerDraws
from repro_torch.service import checkpoint as ckpt

from .engine import BOEngine
from .icd import icd_from_data
from .pareto import adrs
from .pareto import front_mask as _front
from .propose import ProposerConfig, ProposerStats, propose_and_replace
from .sampling import soc_init, transform_to_icd
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


def _prologue_from_v(space: DesignSpace, pool_idx: np.ndarray, v, *,
                     mu: float, b: int, v_th: float, device):
    """The flow-free prologue outputs ``(pruned, pool_icd)`` rebuilt from a
    checkpointed importance vector: ``soc_init`` is deterministic in
    ``(space, pool, v)``, so a resume pays no flow evaluation again."""
    _, pruned, pool_icd = soc_init(space, pool_idx, v, v_th=v_th, b=b, mu=mu,
                                   device=device)
    return pruned, pool_icd


def _pool_fingerprint(pool_idx: np.ndarray) -> str:
    """Content hash of the candidate pool (the reference's): a resumed run
    must explore the identical pool."""
    return hashlib.sha1(np.ascontiguousarray(
        np.asarray(pool_idx, np.int64)).tobytes()).hexdigest()


def _encode_cols(space: DesignSpace, pruned: DesignSpace, v, device):
    """Index vectors [k, d] -> the engine's features [k, d] on ``device``:
    the ``transform_to_icd`` the pool was built with."""
    def encode(cols: np.ndarray) -> torch.Tensor:
        idx = torch.as_tensor(np.asarray(cols, np.int64), device=device)
        return transform_to_icd(space, pruned.apply_pins(idx), v)
    return encode


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
    #: the live pool at the end of a run with the proposer on (rows the
    #: proposer replaced hold their new designs); None otherwise
    pool_live: np.ndarray | None = None

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
    checkpoint_every: int = 1,
    resume: bool = False,
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
    for). ``draws`` supplies the trial rows, frontier subsets, normals and
    the proposer's draws (default: :class:`GeneratorDraws` seeded with
    ``seed`` on ``device``).

    The rounds run on a :class:`BOEngine`: ``incremental=False`` is the
    from-scratch round; ``incremental=True`` warm-starts the fits, updates
    the Cholesky factor by blocks and scores the pool with the
    ``round_fused`` kernel. ``warm_start`` (default: follow ``incremental``),
    ``warm_steps``, ``drift_tol``, ``pool_chunk`` and ``profile_stages`` are
    the engine's knobs. ``q > 1`` (incremental only) picks q candidates per
    round by fantasy updates (``fantasy`` is the imputation rule) and
    evaluates them in one flow call.

    ``checkpoint_dir`` writes a versioned snapshot of the whole run (engine,
    the draws' state, history; :mod:`repro_torch.service.checkpoint`, the
    reference's format) every ``checkpoint_every`` rounds; ``resume=True``
    continues from the latest one bit-exactly, paying no flow evaluation
    again (T may grow; every other trajectory knob must be unchanged).

    ``proposer`` (None | bool | dict | :class:`ProposerConfig`; default off;
    incremental only) replaces, after each round, the lowest-scoring
    unevaluated pool columns by novel designs sampled near the Pareto front
    (:mod:`repro_torch.core.propose`), on a private copy of the pool. Its
    draws come from ``draws.propose`` and never advance the round stream,
    so a proposer-off run is byte-identical to one without the knob;
    checkpoints then also carry the live pool.
    """
    pool_idx = np.asarray(pool_idx)
    pcfg = ProposerConfig.from_arg(proposer)
    pstats = ProposerStats()
    if pcfg.enabled:
        if not incremental:
            raise ValueError(
                "proposer requires incremental=True: victim scoring runs on "
                "the incremental engine's cached round state (pool_scores)")
        pool_idx = np.array(pool_idx)  # private copy: the proposer edits it
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
    N = pool_idx.shape[0]
    # everything that defines the trajectory must survive a resume intact
    # (T may grow: it only decides when the loop stops)
    config = {"q": int(q), "n": int(n), "b": int(b), "mu": float(mu),
              "v_th": float(v_th), "gp_steps": int(gp_steps),
              "s_frontiers": int(s_frontiers),
              "frontier_subset": int(frontier_subset), "fantasy": fantasy,
              "incremental": bool(incremental), "pool_chunk": pool_chunk,
              "warm_start": warm_start, "warm_steps": warm_steps,
              "drift_tol": float(drift_tol),
              "reuse_icd_trials": bool(reuse_icd_trials),
              "weights": (None if weights is None else
                          [float(x) for x in np.asarray(weights).reshape(-1)])}
    if pcfg.enabled:
        config["proposer"] = pcfg.as_dict()
    # the pool as passed: the proposer edits its copy, and a resuming
    # caller passes the original
    pool_fp = _pool_fingerprint(pool_idx)

    snap = None
    if resume and checkpoint_dir:
        snap = ckpt.load_latest_validated(
            checkpoint_dir, driver="soc_tuner", pool=pool_fp, config=config)
    if snap is None:
        v, pruned, pool_icd, evaluated, y = explore_prologue(
            space, pool_idx, flow, draws, n=n, mu=mu, b=b, v_th=v_th,
            reuse_icd_trials=reuse_icd_trials, device=dev)
    else:
        v = np.asarray(snap["v"])
        if pcfg.enabled and "pool_live" in snap:
            # continue on the edited pool; evaluated rows are immutable, so
            # every recorded pick still names the design it scored
            pool_idx = np.array(snap["pool_live"])
            pstats = ProposerStats.from_dict(snap["proposer_stats"])
        pruned, pool_icd = _prologue_from_v(space, pool_idx, v, mu=mu, b=b,
                                            v_th=v_th, device=dev)
        evaluated = [int(r) for r in snap["evaluated"]]
        y = np.asarray(snap["y"], np.float32)
        draws.load_state_dict(snap["draws"])

    history: list[dict] = [] if snap is None else list(snap["history"])
    t_round = time.monotonic()

    def log_round(i: int):
        nonlocal t_round
        now = time.monotonic()
        log_progress(history, y, len(evaluated), i, reference_front,
                     verbose=verbose, wall_s=now - t_round, device=dev)
        t_round = now

    start_round = 0 if snap is None else int(snap["round"])
    if snap is None:
        log_round(0)

    # Lines 5-10: the BO loop. The engine negates targets (metrics are
    # minimized, MES maximizes) and owns the never-re-evaluate mask + argmax.
    engine = BOEngine(pool_icd, incremental=incremental,
                      warm_start=warm_start, gp_steps=gp_steps,
                      warm_steps=warm_steps, drift_tol=drift_tol,
                      s_frontiers=s_frontiers, weights=weights,
                      pool_chunk=pool_chunk, profile_stages=profile_stages,
                      device=dev)
    if snap is None:
        engine.observe(evaluated, y)
    else:
        engine.load_state_dict(snap["engine"])

    def save_checkpoint(round_i: int) -> None:
        d = {"driver": "soc_tuner", "round": round_i, "pool": pool_fp,
             "config": config, "draws": draws.state_dict(),
             "v": np.asarray(v), "evaluated": np.asarray(evaluated, np.int64),
             "y": y, "history": history, "engine": engine.state_dict()}
        if pcfg.enabled:
            d["pool_live"] = np.array(pool_idx)
            d["proposer_stats"] = pstats.as_dict()
        ckpt.save_snapshot(ckpt.snapshot_path(checkpoint_dir, round_i), d)
        ckpt.prune_snapshots(checkpoint_dir)

    for it in range(start_round, T):
        sub, eps = draws.round(N, frontier_subset, engine.m, s_frontiers)
        picks = engine.select_q(eps, q, sub_rows=sub, fantasy=fantasy)
        # Line 8: evaluate and append (one flow call for the whole batch)
        y_new = np.asarray(flow(pool_idx[np.asarray(picks)]))
        evaluated.extend(picks)
        y = np.concatenate([y, y_new], axis=0)
        engine.observe(picks, y_new)
        log_round(it + 1)
        # Between-round proposal: refresh the weakest pool columns before
        # the next round. It runs before the checkpoint, so a resumed run
        # sees the pool the next round would have seen, and after the last
        # round too (T may grow across resumes).
        if pcfg.enabled and (it + 1) % pcfg.every == 0:
            out = propose_and_replace(
                engine, space, functools.partial(draws.propose, it),
                pool_idx, cfg=pcfg,
                encode_cols=_encode_cols(space, pruned, v, dev),
                evaluated=[evaluated], ys=[y], stats=pstats)
            if out is not None:
                pool_idx[out.victims] = out.new_idx
        if checkpoint_dir and (it + 1) % checkpoint_every == 0:
            save_checkpoint(it + 1)

    front = _front(y, dev)
    rows = np.asarray(evaluated)
    stats_d = engine.stats.as_dict()
    if pcfg.enabled:
        stats_d["proposer"] = pstats.as_dict()
    return TunerResult(
        space=pruned, v=np.asarray(v), evaluated_rows=rows, y=y,
        pareto_rows=rows[front], pareto_y=y[front], history=history,
        wall_s=time.monotonic() - t0, engine_stats=stats_d,
        pool_live=np.array(pool_idx) if pcfg.enabled else None)

"""The exploration service loop: async q-batch BO over a worker pool.

A port of ``repro.service.runner``. :func:`service_tuner` is Algorithm 3
rebuilt for a production flow budget:

- each refill asks the incremental engine for up to ``q`` candidates by
  **fantasy updates** (:meth:`repro_torch.core.engine.BOEngine.select_q`:
  in-flight picks are fantasized, new picks are chosen one rank-1 update
  apart, and the frontier y* is drawn once a refill and frozen across the
  chain, so every fantasy step is one ``round_fused`` launch);
- picks go to a :class:`~repro_torch.service.pool.FlowPool` of concurrent
  workers (one design a dispatch, so one ``systolic_eval`` launch each) and
  **completions are fed back as they land**: with ``min_done=1`` a new
  selection starts as soon as ONE evaluation returns;
- every completion batch writes a **versioned atomic checkpoint** (engine
  state, the draws' state, trajectory); a SIGKILLed run resumed with
  ``resume=True`` continues the uninterrupted trajectory bit for bit;
- every evaluation dedups against the content-addressed on-disk flow cache.

Randomness comes from a :class:`repro_torch.random.TunerDraws` object: one
``prologue`` call, one ``round`` call a refill (the reference's
``split(key, 4)``; a q > 1 refill still draws one frozen y*), and
``propose(done, ...)`` for the proposer (the reference's
``fold_in(key, PROPOSER_FOLD + done)``). With ``q=1`` and the inline
executor the loop is ``soc_tuner(incremental=True)`` bit for bit: the same
draws, picks and flow calls. ``T`` counts the BO phase's flow evaluations
(for q = 1, its rounds).

With ``ordered=True`` (the default) completions are *observed* in
submission order whatever worker finishes first, so the trajectory, and
every checkpoint, is independent of worker timing; ``ordered=False``
observes them as they land.
"""
from __future__ import annotations

import functools
import os
import signal
import time

import numpy as np
import torch

from repro_torch.core.engine import FANTASY_MODES, BOEngine
from repro_torch.core.propose import (ProposerConfig, ProposerStats,
                                      propose_and_replace)
from repro_torch.core.tuner import (TunerResult, _encode_cols, _front,
                                    _pool_fingerprint, _prologue_from_v,
                                    explore_prologue)
from repro_torch.device import resolve_device
from repro_torch.obs import EventLog, MetricsRegistry, log_progress
from repro_torch.random import GeneratorDraws, TunerDraws

from .checkpoint import (load_latest_validated, prune_snapshots,
                         save_snapshot, snapshot_path)
from .flowcache import CachedFlow, FlowDiskCache
from .pool import FlowPool

__all__ = ["service_tuner"]


def service_tuner(
    space,
    pool_idx: np.ndarray,
    flow,
    *,
    workload: str = "resnet50",
    T: int = 40,
    q: int = 1,
    fantasy: str = "mean",
    min_done: int = 1,
    ordered: bool = True,
    max_workers: int | None = None,
    executor="process",
    n: int = 30,
    mu: float = 0.1,
    b: int = 20,
    v_th: float = 0.07,
    s_frontiers: int = 10,
    frontier_subset: int = 512,
    gp_steps: int = 150,
    draws: TunerDraws | None = None,
    seed: int = 0,
    reference_front: np.ndarray | None = None,
    reuse_icd_trials: bool = True,
    weights: np.ndarray | None = None,
    incremental: bool = True,
    warm_start: bool | None = None,
    warm_steps: int | None = None,
    drift_tol: float = 1.0,
    pool_chunk: int | str | None = None,
    bucket: int | None = None,
    cache_dir: str | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    proposer=None,
    device=None,
    verbose: bool = False,
    metrics: MetricsRegistry | None = None,
    events: EventLog | str | None = None,
    profile_stages: bool = False,
    _kill_after: int | None = None,
) -> TunerResult:
    """Run the exploration service; returns ``soc_tuner``'s result layout.

    ``T`` = the BO phase's flow-evaluation budget; ``q`` = the most
    evaluations in flight; ``min_done`` = completions to wait for before the
    next refill (1 = fully async, ``q`` = a round barrier). ``executor`` is
    ``"process"``, ``"thread"``, ``"inline"`` or an Executor;
    ``max_workers`` defaults to ``q``. ``draws`` (default
    ``GeneratorDraws(seed, device)``) supplies every random draw; the
    engine runs on ``device`` (default ``cuda``; the CPU only when asked
    for). ``cache_dir`` attaches the on-disk flow cache (the prologue's
    flow calls go through it too); ``checkpoint_dir``/``resume`` make the
    run restartable (T may grow; every other trajectory knob must be
    unchanged). ``incremental`` defaults to True; q > 1 requires it.
    ``bucket`` overrides the engine's pad bucket. ``_kill_after`` is a test
    hook: SIGKILL this process right after the checkpoint that covers that
    many BO evaluations.

    ``proposer`` (None | bool | dict | ``ProposerConfig``; default off)
    replaces, after every ``every``-th completed evaluation, the weakest
    unevaluated pool columns that are not in flight by designs sampled
    near the current front; checkpoints then carry the live pool.

    Telemetry (host-side; trajectories do not move): ``metrics`` joins a
    registry (one is made otherwise), ``events`` is an
    :class:`repro_torch.obs.EventLog` or a path to open one (closed on
    exit; a resumed run appends a new generation), ``profile_stages``
    turns on the engine's per-stage profiler and folds it into
    ``metrics``.
    """
    t0 = time.monotonic()
    metrics = MetricsRegistry() if metrics is None else metrics
    if q < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    if q > 1 and not incremental:
        raise ValueError(
            "q > 1 requires incremental=True: fantasy q-batch selection "
            "runs on the incremental engine (checked up front so no flow "
            "budget is spent on a run that cannot start)")
    if min_done < 1 or min_done > q:
        raise ValueError(f"min_done must be in [1, q={q}], got {min_done}")
    if fantasy not in FANTASY_MODES:
        raise ValueError(f"fantasy must be one of {FANTASY_MODES}")
    pool_idx = np.asarray(pool_idx)
    pcfg = ProposerConfig.from_arg(proposer)
    pstats = ProposerStats()
    if pcfg.enabled:
        if not incremental:
            raise ValueError(
                "proposer requires incremental=True: victim scoring runs on "
                "the incremental engine's cached round state (pool_scores)")
        pool_idx = np.array(pool_idx)  # private copy: the proposer edits it
    dev = resolve_device(device)
    # IEEE float32 products everywhere, never TF32 (as soc_tuner)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    draws = GeneratorDraws(seed, dev) if draws is None else draws
    _ev_owned = isinstance(events, str)
    ev = EventLog(events, run="service_tuner") if _ev_owned else events
    N = pool_idx.shape[0]
    # Everything that defines the trajectory must survive a resume intact;
    # ``T`` is stored but exempt from the guard (extending the budget only
    # clamps refills near the end).
    config = {"T": int(T), "q": int(q), "n": int(n), "b": int(b),
              "mu": float(mu), "v_th": float(v_th), "gp_steps": int(gp_steps),
              "s_frontiers": int(s_frontiers),
              "frontier_subset": int(frontier_subset), "fantasy": fantasy,
              "min_done": int(min_done), "ordered": bool(ordered),
              "incremental": bool(incremental), "workload": str(workload),
              "warm_start": warm_start, "warm_steps": warm_steps,
              "drift_tol": float(drift_tol), "pool_chunk": pool_chunk,
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
        snap = load_latest_validated(
            checkpoint_dir, driver="service_tuner", pool=pool_fp,
            config={k: v for k, v in config.items() if k != "T"})
        if snap is not None and verbose:
            print(f"[service] resuming at {int(snap['done'])}/{T} "
                  "evaluations")
        if snap is not None and pcfg.enabled and "pool_live" in snap:
            # continue on the edited pool; evaluated rows are immutable
            pool_idx = np.array(snap["pool_live"])
            pstats = ProposerStats.from_dict(snap["proposer_stats"])

    disk = FlowDiskCache(cache_dir) if cache_dir else None
    # the prologue's flow calls go through the disk cache too (a restart
    # pays nothing again even without a checkpoint)
    pro_flow = flow if disk is None else CachedFlow(flow, disk, workload)
    if snap is None:
        v, pruned, pool_icd, evaluated, y = explore_prologue(
            space, pool_idx, pro_flow, draws, n=n, mu=mu, b=b, v_th=v_th,
            reuse_icd_trials=reuse_icd_trials, device=dev)
    else:
        v = np.asarray(snap["v"])
        pruned, pool_icd = _prologue_from_v(space, pool_idx, v, mu=mu, b=b,
                                            v_th=v_th, device=dev)
        evaluated = [int(r) for r in snap["evaluated"]]
        y = np.asarray(snap["y"], np.float32)
        draws.load_state_dict(snap["draws"])

    engine_kw = dict(incremental=incremental, warm_start=warm_start,
                     gp_steps=gp_steps, warm_steps=warm_steps,
                     drift_tol=drift_tol, s_frontiers=s_frontiers,
                     weights=weights, pool_chunk=pool_chunk,
                     profile_stages=profile_stages, device=dev)
    if bucket is not None:
        engine_kw["bucket"] = int(bucket)
    engine = BOEngine(pool_icd, **engine_kw)
    if snap is None:
        engine.observe(evaluated, y)
    else:
        engine.load_state_dict(snap["engine"])

    history: list[dict] = [] if snap is None else list(snap["history"])
    done = 0 if snap is None else int(snap["done"])
    t_round = time.monotonic()

    def log_round(i: int) -> None:
        nonlocal t_round
        now = time.monotonic()
        log_progress(history, y, len(evaluated), i, reference_front,
                     verbose=verbose, tag="service", word="eval",
                     wall_s=now - t_round, events=ev, track=workload,
                     device=dev)
        t_round = now

    if snap is None:
        log_round(0)

    fpool = FlowPool(flow, workload=workload,
                     max_workers=q if max_workers is None else max_workers,
                     executor=executor, cache=disk,
                     metrics=metrics, events=ev)
    if disk is not None:
        disk.bind_metrics(metrics)
    pending: list[tuple[int, int]] = []  # (ticket, pool row), ticket order
    # the highest ``done // every`` already proposed for; checkpointed, so a
    # resumed run neither proposes a slot again nor skips one
    prop_mark = (0 if snap is None
                 else int(snap.get("prop_mark", done // pcfg.every)))
    try:
        if snap is not None:  # re-dispatch what was in flight at the kill
            for r in (int(r) for r in snap["pending"]):
                pending.append((fpool.submit(r, pool_idx[r]), r))

        while done < T or pending:
            want = min(q - len(pending), T - done - len(pending))
            if want > 0:
                sub, eps = draws.round(N, frontier_subset, engine.m,
                                       s_frontiers)
                picks = engine.select_q(
                    eps, want, sub_rows=sub,
                    pending=[r for _, r in pending], fantasy=fantasy)
                for p in picks:
                    pending.append((fpool.submit(p, pool_idx[p]), p))
            results = fpool.drain(min_done=min(min_done, len(pending)),
                                  ordered=ordered)
            for t, row, y_row in results:
                engine.observe([row], y_row[None])
                evaluated.append(int(row))
                y = np.concatenate([y, np.asarray(y_row, y.dtype)[None]], 0)
                pending.remove((t, row))
                done += 1
                log_round(done)
            # Between-evaluation proposal (default off), from the draws'
            # proposer stream at the completion count, so an ordered run's
            # proposals do not depend on worker timing. In-flight rows are
            # never victims; it runs before the checkpoint so a SIGKILL
            # resumes on the edited pool.
            if pcfg.enabled and results and done // pcfg.every > prop_mark:
                out = propose_and_replace(
                    engine, space, functools.partial(draws.propose, done),
                    pool_idx, cfg=pcfg,
                    encode_cols=_encode_cols(space, pruned, v, dev),
                    evaluated=[evaluated], ys=[y],
                    pending=[r for _, r in pending], stats=pstats)
                prop_mark = done // pcfg.every
                if out is not None:
                    pool_idx[out.victims] = out.new_idx
            if checkpoint_dir and results and \
                    (done % checkpoint_every == 0 or done >= T):
                ckpt = {
                    "driver": "service_tuner", "done": done,
                    "pool": pool_fp, "config": config,
                    "draws": draws.state_dict(), "v": np.asarray(v),
                    "evaluated": np.asarray(evaluated, np.int64), "y": y,
                    "history": history,
                    "pending": np.asarray([r for _, r in pending], np.int64),
                    "engine": engine.state_dict()}
                if pcfg.enabled:
                    ckpt["pool_live"] = np.array(pool_idx)
                    ckpt["proposer_stats"] = pstats.as_dict()
                    ckpt["prop_mark"] = int(prop_mark)
                save_snapshot(snapshot_path(checkpoint_dir, done), ckpt)
                prune_snapshots(checkpoint_dir)
                if ev is not None:
                    ev.instant("checkpoint", cat="service", track=workload,
                               done=done)
                if _kill_after is not None and done >= _kill_after:
                    os.kill(os.getpid(), signal.SIGKILL)
    finally:
        fpool.close()
        if ev is not None and _ev_owned:
            ev.close()

    front = _front(y, dev)
    rows = np.asarray(evaluated)
    engine.stats.fold_into(metrics)
    stats = engine.stats.as_dict()
    if pcfg.enabled:
        pstats.fold_into(metrics)
        stats["proposer"] = pstats.as_dict()
    stats["service"] = {
        "pool_dispatched": fpool.dispatched,
        "pool_cache_hits": fpool.cache_hits,
        **({"disk": {"hits": disk.hits, "misses": disk.misses,
                     "puts": disk.puts}} if disk is not None else {}),
    }
    return TunerResult(
        space=pruned, v=np.asarray(v), evaluated_rows=rows, y=y,
        pareto_rows=rows[front], pareto_y=y[front], history=history,
        wall_s=time.monotonic() - t0, engine_stats=stats,
        pool_live=np.array(pool_idx) if pcfg.enabled else None)

"""The fleet exploration service: async q-batch BO across many scenarios.

A port of ``repro.service.fleet_runner``. :func:`fleet_service` is
``fleet_tuner`` rebuilt for a production flow budget, the multi-scenario
twin of :func:`repro_torch.service.runner.service_tuner`:

- each refill cycle asks the **batched** incremental engine for up to ``q``
  candidates a scenario by fantasy updates
  (:meth:`repro_torch.core.engine.BatchedBOEngine.select_q`: in-flight
  picks fantasized under per-scenario pending rows, each scenario's y*
  drawn once a refill and frozen across the chain);
- every scenario's picks go to ONE shared
  :class:`~repro_torch.service.pool.FlowPool`: concurrent workers serve the
  whole fleet, identical in-flight design points are deduplicated across
  scenarios, and the disk cache (``cache_dir``) dedups across runs;
- completions are drained **per scenario, exactly ``min_done`` at a time, in
  ticket order** (:meth:`FlowPool.collect`), so every scenario's trajectory
  is independent of worker timing;
- every cycle writes a versioned atomic checkpoint; a SIGKILLed run resumed
  with ``resume=True`` continues the uninterrupted fleet bit for bit.

Scenario i draws from its own :class:`repro_torch.random.TunerDraws`: one
``round`` call a refill (the reference's ``split(key, 4)``), and the
fleet-wide proposer draws from scenario 0's ``propose`` at the fleet's
completion count. With ``q=1``, ``min_done=1`` and the inline executor the
loop picks what ``fleet_tuner(incremental=True)`` picks. ``T`` counts BO
evaluations **a scenario**.
"""
from __future__ import annotations

import functools
import os
import signal
import time

import numpy as np
import torch

from repro_torch.core.engine import FANTASY_MODES, BatchedBOEngine
from repro_torch.core.fleet import (FleetResult, FlowEvalCache, _log_round,
                                    fleet_prologue)
from repro_torch.core.propose import (ProposerConfig, ProposerStats,
                                      propose_and_replace)
from repro_torch.core.tuner import (TunerResult, _encode_cols, _front,
                                    _pool_fingerprint)
from repro_torch.device import resolve_device
from repro_torch.obs import EventLog, MetricsRegistry
from repro_torch.random import GeneratorDraws, TunerDraws

from .checkpoint import (load_latest_validated, prune_snapshots,
                         save_snapshot, snapshot_path)
from .flowcache import FlowDiskCache
from .pool import FlowPool

__all__ = ["fleet_service"]


def fleet_service(
    space,
    pool_idx: np.ndarray,
    scenarios,
    *,
    T: int = 40,
    q: int = 1,
    fantasy: str = "mean",
    min_done: int = 1,
    max_workers: int | None = None,
    executor="process",
    n: int = 30,
    mu: float = 0.1,
    b: int = 20,
    v_th: float = 0.07,
    s_frontiers: int = 10,
    frontier_subset: int = 512,
    gp_steps: int = 150,
    reference_fronts: dict | None = None,
    reuse_icd_trials: bool = True,
    incremental: bool = True,
    warm_start: bool | None = None,
    warm_steps: int | None = None,
    drift_tol: float = 1.0,
    pool_chunk: int | str | None = None,
    bucket: int | None = None,
    mesh=None,
    mesh_axis: str | None = None,
    flow_factory=None,
    cache_dir: str | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    proposer=None,
    draws: list[TunerDraws] | None = None,
    device=None,
    verbose: bool = False,
    metrics: MetricsRegistry | None = None,
    events: EventLog | str | None = None,
    _kill_after: int | None = None,
) -> FleetResult:
    """Explore every scenario of a fleet asynchronously over one worker pool.

    ``T`` = the BO phase's flow-evaluation budget *a scenario*; ``q`` = the
    most evaluations in flight a scenario; ``min_done`` = completions each
    scenario waits for a cycle (1 = fully async, ``q`` = a barrier).
    ``max_workers`` defaults to ``q * S`` capped at ``os.cpu_count()``.
    ``flow_factory`` (``workload -> flow``) supplies the evaluation backend
    (default: :class:`repro_torch.soc.VLSIFlow` on ``device``); flows must
    pickle for the process executor. ``draws`` holds one
    :class:`TunerDraws` a scenario (default ``GeneratorDraws(sc.seed,
    device)``). ``cache_dir`` attaches the disk cache; ``checkpoint_dir``/
    ``resume`` make the run restartable. The other knobs are
    :func:`repro_torch.core.fleet.fleet_tuner`'s. ``_kill_after`` is a
    test hook: SIGKILL this process right after the checkpoint covering
    that many BO evaluations of the whole fleet.

    ``proposer`` (default off; incremental only) runs the fleet-wide
    between-round proposer after every ``every``-th completion of the
    fleet: columns no scenario values and none has in flight are replaced;
    their memo entries are dropped and checkpoints carry the live pool.

    ``mesh``/``mesh_axis`` split the fleet into scenario groups, one a
    device (:func:`repro_torch.core.fleet.fleet_tuner`'s; not with
    ``proposer``): each refill's fantasy chains run group by group, step by
    step.

    Telemetry (host-side; trajectories do not move): ``metrics`` joins a
    registry (one is made otherwise); ``events`` is an
    :class:`repro_torch.obs.EventLog` or a path to open one.
    """
    t0 = time.monotonic()
    metrics = MetricsRegistry() if metrics is None else metrics
    scenarios = list(scenarios)
    S = len(scenarios)
    if S < 1:
        raise ValueError("fleet_service: need at least one scenario")
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
        if mesh is not None:
            raise ValueError(
                "proposer is incompatible with mesh sharding: pool edits "
                "rewrite host-gathered V chunks (run unsharded, or propose "
                "offline between sharded runs)")
        # a private copy: the proposer edits it, and the evaluation cache
        # and submit_pick alias the same array
        pool_idx = np.array(pool_idx)
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    draws = ([GeneratorDraws(sc.seed, dev) for sc in scenarios]
             if draws is None else list(draws))
    if len(draws) != S:
        raise ValueError(f"fleet_service: {S} scenarios but {len(draws)} "
                         "draws")
    _ev_owned = isinstance(events, str)
    ev = EventLog(events, run="fleet_service") if _ev_owned else events
    N = pool_idx.shape[0]
    reference_fronts = reference_fronts or {}
    if flow_factory is None:
        from repro_torch.soc import VLSIFlow

        flow_factory = lambda wl: VLSIFlow(space, wl, device=dev)

    # everything that defines the trajectory must survive a resume intact;
    # ``T`` is exempt (extending the budget is a legitimate ops action)
    config = {"T": int(T), "q": int(q), "min_done": int(min_done),
              "fantasy": fantasy, "n": int(n), "b": int(b), "mu": float(mu),
              "v_th": float(v_th), "gp_steps": int(gp_steps),
              "s_frontiers": int(s_frontiers),
              "frontier_subset": int(frontier_subset),
              "incremental": bool(incremental), "pool_chunk": pool_chunk,
              "warm_start": warm_start, "warm_steps": warm_steps,
              "drift_tol": float(drift_tol), "bucket": bucket,
              "reuse_icd_trials": bool(reuse_icd_trials),
              "scenario_params": [
                  [sc.workload, int(sc.seed), [float(w) for w in sc.weights]]
                  for sc in scenarios]}
    if pcfg.enabled:
        config["proposer"] = pcfg.as_dict()
    pool_fp = _pool_fingerprint(pool_idx)

    snap = None
    if resume and checkpoint_dir:
        snap = load_latest_validated(
            checkpoint_dir, driver="fleet_service", pool=pool_fp,
            config={k: v for k, v in config.items() if k != "T"})
        if snap is not None and \
                snap["scenarios"] != [sc.label for sc in scenarios]:
            raise ValueError(f"checkpoint in {checkpoint_dir} was taken for "
                             f"scenarios {snap['scenarios']} — resume "
                             "requires the identical fleet")
        if snap is not None and verbose:
            print(f"[fleet-svc] resuming at "
                  f"{[int(x) for x in snap['done']]}/{T} evaluations")
        if snap is not None and pcfg.enabled and "pool_live" in snap:
            np.copyto(pool_idx, np.asarray(snap["pool_live"]))  # aliased
            pstats = ProposerStats.from_dict(snap["proposer_stats"])

    disk = FlowDiskCache(cache_dir) if cache_dir else None
    # ONE flow a workload, shared by the prologue (through the evaluation
    # cache) and the worker pool
    flows = {wl: flow_factory(wl)
             for wl in dict.fromkeys(sc.workload for sc in scenarios)}
    cache = FlowEvalCache(space, pool_idx, [sc.workload for sc in scenarios],
                          disk=disk, flow_factory=flows.__getitem__,
                          device=dev)
    states = fleet_prologue(space, pool_idx, scenarios, cache, draws, n=n,
                            mu=mu, b=b, v_th=v_th,
                            reuse_icd_trials=reuse_icd_trials, device=dev,
                            snap=snap)
    if snap is None:
        for sc, st in zip(scenarios, states):
            _log_round(st, 0, sc.label, reference_fronts.get(sc.workload),
                       verbose, "fleet-svc", device=dev)

    any_weights = any(st.weights is not None for st in states)
    weights = (np.asarray([st.weights or (1.0, 1.0, 1.0) for st in states],
                          np.float32) if any_weights else None)
    engine_kw = dict(incremental=incremental, warm_start=warm_start,
                     gp_steps=gp_steps, warm_steps=warm_steps,
                     drift_tol=drift_tol, s_frontiers=s_frontiers,
                     weights=weights, pool_chunk=pool_chunk, mesh=mesh,
                     mesh_axis=mesh_axis, device=dev)
    if bucket is not None:
        engine_kw["bucket"] = int(bucket)
    engine = BatchedBOEngine(torch.stack([st.pool_icd for st in states]),
                             **engine_kw)
    if snap is None:
        engine.observe([st.evaluated for st in states],
                       [st.y for st in states])
    else:
        engine.load_state_dict(snap["engine"])

    done = ([0] * S if snap is None else [int(x) for x in snap["done"]])
    cycle = 0 if snap is None else int(snap["cycle"])
    t_cycle = time.monotonic()

    if max_workers is None:
        max_workers = max(1, min(q * S, os.cpu_count() or 1))
    fpool = FlowPool(next(iter(flows.values())),
                     workload=scenarios[0].workload,
                     max_workers=max_workers, executor=executor, cache=disk,
                     metrics=metrics, events=ev)
    if disk is not None:
        disk.bind_metrics(metrics)
    g_memo = metrics.gauge("fleet_cache_memo_hits",
                           "fleet memo (FlowEvalCache) peek hits")
    metrics.add_collector(lambda: g_memo.set(cache.peek_hits))

    def submit_pick(si: int, row: int) -> int:
        wl = scenarios[si].workload
        y = cache.peek(wl, row)
        if y is not None:  # the fleet memo (prologue, other scenarios)
            return fpool.submit_resolved(row, y)
        return fpool.submit(row, pool_idx[row], workload=wl, flow=flows[wl])

    def encode_cols(cols: np.ndarray) -> torch.Tensor:
        return torch.stack([_encode_cols(space, st.pruned, st.v, dev)(cols)
                            for st in states])

    pending: list[list[tuple[int, int]]] = [[] for _ in range(S)]
    # the highest ``sum(done) // every`` already proposed for; checkpointed
    prop_mark = (0 if snap is None
                 else int(snap.get("prop_mark", sum(done) // pcfg.every)))
    try:
        if snap is not None:  # re-dispatch what was in flight at the kill
            for si in range(S):
                for r in (int(r) for r in snap["pending"][str(si)]):
                    pending[si].append((submit_pick(si, r), r))

        def caps():
            # a scenario refills only with rows it has neither evaluated nor
            # in flight; once the pool is exhausted it retires
            return [N - len(set(states[si].evaluated)) - len(pending[si])
                    for si in range(S)]

        def active():
            return [bool(pending[si]) or (done[si] < T and cap > 0)
                    for si, cap in enumerate(caps())]

        while any(active()):
            # refill every scenario up to q (clamped to its budget and its
            # fresh rows); ONE batched select_q serves the fleet
            wants = [max(0, min(q - len(pending[si]),
                                T - done[si] - len(pending[si]), cap))
                     for si, cap in enumerate(caps())]
            n_new = max(wants)
            if n_new > 0:
                subs, eps = zip(*(st.draws.round(N, frontier_subset,
                                                 engine.m, s_frontiers)
                                  for st in states))
                picks = engine.select_q(
                    list(eps), n_new,
                    sub_rows=None if subs[0] is None else np.stack(subs),
                    pending=[[r for _, r in p] for p in pending],
                    fantasy=fantasy)
                for si in range(S):
                    # a scenario wanting fewer drops the surplus picks: they
                    # were fantasized, never dispatched
                    for p in picks[si][:wants[si]]:
                        pending[si].append((submit_pick(si, int(p)), int(p)))

            # drain exactly min_done a scenario, in ticket order
            obs_rows: list[list[int]] = [[] for _ in range(S)]
            obs_ys: list[list[np.ndarray]] = [[] for _ in range(S)]
            for si, sc in enumerate(scenarios):
                take = min(min_done, len(pending[si]))
                if not take:
                    continue
                tickets = [t for t, _ in pending[si][:take]]
                for t, row, y_row in fpool.collect(tickets):
                    cache.store(sc.workload, row, y_row)
                    obs_rows[si].append(int(row))
                    obs_ys[si].append(np.asarray(y_row))
                del pending[si][:take]
            engine.observe(
                obs_rows,
                [np.stack(ys) if ys else np.zeros((0, 3), np.float32)
                 for ys in obs_ys])
            now = time.monotonic()
            for si, sc in enumerate(scenarios):
                st = states[si]
                for row, y_row in zip(obs_rows[si], obs_ys[si]):
                    st.evaluated.append(row)
                    st.y = np.concatenate([st.y, y_row[None]], axis=0)
                    done[si] += 1
                    _log_round(st, done[si], sc.label,
                               reference_fronts.get(sc.workload), verbose,
                               "fleet-svc", wall_s=now - t_cycle, events=ev,
                               device=dev)
            t_cycle = now
            cycle += 1
            if ev is not None:
                ev.instant("cycle", cat="fleet", track="fleet",
                           cycle=cycle, done=sum(done))
            # fleet-wide proposal (default off) from scenario 0's proposer
            # stream at the fleet's completion count; columns in flight are
            # never victims; before the checkpoint
            if pcfg.enabled and any(obs_rows) and \
                    sum(done) // pcfg.every > prop_mark:
                out = propose_and_replace(
                    engine, space,
                    functools.partial(states[0].draws.propose, sum(done)),
                    pool_idx, cfg=pcfg, encode_cols=encode_cols,
                    evaluated=[st.evaluated for st in states],
                    ys=[st.y for st in states],
                    pending=[r for p in pending for _, r in p],
                    stats=pstats)
                prop_mark = sum(done) // pcfg.every
                if out is not None:
                    pool_idx[out.victims] = out.new_idx  # the cache aliases it
                    cache.invalidate_rows(out.victims)
            if checkpoint_dir and any(obs_rows) and \
                    (cycle % checkpoint_every == 0
                     or all(d >= T for d in done)):
                save_snapshot(snapshot_path(checkpoint_dir, cycle), {
                    "driver": "fleet_service", "cycle": cycle,
                    "pool": pool_fp, "config": config,
                    "scenarios": [sc.label for sc in scenarios],
                    "done": np.asarray(done, np.int64),
                    "draws": [st.draws.state_dict() for st in states],
                    "vs": {str(si): np.asarray(st.v)
                           for si, st in enumerate(states)},
                    "evaluated": {str(si): np.asarray(st.evaluated, np.int64)
                                  for si, st in enumerate(states)},
                    "ys": {str(si): st.y for si, st in enumerate(states)},
                    "histories": {str(si): st.history
                                  for si, st in enumerate(states)},
                    "pending": {
                        str(si): np.asarray([r for _, r in pending[si]],
                                            np.int64)
                        for si in range(S)},
                    "engine": engine.state_dict(),
                    **({"pool_live": np.array(pool_idx),
                        "proposer_stats": pstats.as_dict(),
                        "prop_mark": int(prop_mark)}
                       if pcfg.enabled else {})})
                prune_snapshots(checkpoint_dir)
                if _kill_after is not None and sum(done) >= _kill_after:
                    os.kill(os.getpid(), signal.SIGKILL)
    finally:
        fpool.close()
        if ev is not None and _ev_owned:
            ev.close()

    if verbose:
        for si, sc in enumerate(scenarios):
            if done[si] < T:
                print(f"[fleet-svc] {sc.label}: retired after {done[si]}/"
                      f"{T} evaluations — candidate pool exhausted")

    wall = time.monotonic() - t0
    engine.stats.fold_into(metrics)
    stats = engine.stats.as_dict()
    if pcfg.enabled:
        pstats.fold_into(metrics)
        stats["proposer"] = pstats.as_dict()
    stats["service"] = {
        "pool_dispatched": fpool.dispatched,
        "pool_cache_hits": fpool.cache_hits,
        "pool_inflight_hits": fpool.inflight_hits,
        "fleet_cache": {"hits": cache.hits, "misses": cache.misses,
                        "memo_hits": cache.peek_hits,
                        "evaluated": cache.evaluated},
        **({"disk": {"hits": disk.hits, "misses": disk.misses,
                     "puts": disk.puts}} if disk is not None else {}),
    }
    results = []
    for st in states:
        rows = np.asarray(st.evaluated)
        front = _front(st.y, dev)
        results.append(TunerResult(
            space=st.pruned, v=np.asarray(st.v), evaluated_rows=rows,
            y=st.y, pareto_rows=rows[front], pareto_y=st.y[front],
            history=st.history, wall_s=wall, engine_stats=stats,
            pool_live=np.array(pool_idx) if pcfg.enabled else None))
    return FleetResult(scenarios=scenarios, results=results, cache=cache,
                       wall_s=wall)

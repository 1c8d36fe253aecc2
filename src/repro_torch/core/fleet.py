"""Fleet runner: several SoC exploration scenarios in one batched run.

A port of ``repro.core.fleet``. ``soc_tuner`` explores one (workload, seed);
the fleet turns the outer loop over scenarios inside out:

* every round fits and scores ALL scenarios on one
  :class:`~repro_torch.core.engine.BatchedBOEngine` (one Adam loop for the
  whole fleet's GPs);
* flow evaluations go through a memoized cache keyed by (workload, pool
  row), shared by the scenarios: two seeds exploring resnet50 never pay
  twice for the same design;
* cache misses pending for different workloads are evaluated by one launch
  of the ``systolic_eval`` kernel's multi-workload entry
  (``soc_metrics_multi``).

Each scenario draws from its own :class:`repro_torch.random.TunerDraws`,
consumed exactly as ``soc_tuner`` consumes it (``prologue`` once, then
``round`` once a round), so a fleet of one picks what ``soc_tuner`` picks on
the same draws, and its flushes are the flow calls ``soc_tuner`` makes.

Usage::

    from repro_torch.core import FleetScenario, fleet_tuner, make_space
    space = make_space()
    pool = space.sample(torch.Generator("cuda").manual_seed(0), 1000)
    fr = fleet_tuner(space, pool.cpu().numpy(),
                     [FleetScenario("resnet50", seed=0),
                      FleetScenario("transformer", seed=0,
                                    weights=(2.0, 1.0, 1.0))],
                     T=15, n=20, b=12)
    print(fr.cache.summary())
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import systolic_eval as _systolic_eval
from repro_torch.obs.progress import log_progress
from repro_torch.random import GeneratorDraws, TunerDraws
from repro_torch.service import checkpoint as ckpt
from repro_torch.soc.workloads import get_workload, pad_workloads

from .engine import BatchedBOEngine
from .icd import icd_from_data
from .propose import ProposerConfig, ProposerStats, propose_and_replace
from .sampling import soc_init
from .space import DesignSpace
from .tuner import (TunerResult, _encode_cols, _front, _pool_fingerprint,
                    merge_trial_evals)

__all__ = ["FleetScenario", "FleetResult", "FlowEvalCache", "fleet_tuner",
           "fleet_prologue"]


@dataclasses.dataclass(frozen=True)
class FleetScenario:
    """One exploration scenario: a workload, a seed (of its default draws)
    and an optional per-objective acquisition weighting (latency, power,
    area)."""

    workload: str
    seed: int = 0
    weights: tuple[float, float, float] = (1.0, 1.0, 1.0)

    @property
    def label(self) -> str:
        w = ""
        if tuple(self.weights) != (1.0, 1.0, 1.0):
            w = ":w" + "x".join(f"{x:g}" for x in self.weights)
        return f"{self.workload}:s{self.seed}{w}"


class FlowEvalCache:
    """Memoized flow evaluations shared across a fleet, keyed by
    ``(workload, pool row)``.

    A flush evaluates every miss of a request: one ``systolic_eval`` launch
    when one workload is pending (the call ``VLSIFlow`` makes, so a fleet of
    one evaluates bit for bit what ``soc_tuner`` does), one launch of its
    multi-workload entry when several are (rows padded to a common count by
    repeating each workload's first row), or, with ``flow_factory``
    (``workload -> flow callable``), one call of each pending workload's
    flow on the design-index rows. ``hits``/``misses`` count requested
    rows, ``evaluated`` the designs evaluated (the stored entries),
    ``flow_calls`` the flushes' calls; ``peek_hits``/``peek_misses`` the
    lookups of :meth:`peek`, ``invalidated`` the entries
    :meth:`invalidate_rows` dropped.

    ``disk`` (a :class:`repro_torch.service.flowcache.FlowDiskCache` or its
    root path) backs the memo with the content-addressed on-disk cache: a
    flush first resolves its misses from the disk (``disk_hits`` counts
    them) and writes every result it computes back, so fleets, service runs
    and restarts of either package share one corpus of evaluations."""

    def __init__(self, space: DesignSpace, pool_idx: np.ndarray,
                 workloads: Sequence[str], disk=None, flow_factory=None,
                 device=None):
        if disk is not None and not hasattr(disk, "get"):
            from repro_torch.service.flowcache import FlowDiskCache

            disk = FlowDiskCache(disk)
        self.disk = disk
        self.space = space
        self.pool_idx = np.asarray(pool_idx)
        self.device = resolve_device(device)
        self.layers = {w: np.asarray(get_workload(w), np.float64)
                       for w in dict.fromkeys(workloads)}
        self._layers_t = {w: torch.as_tensor(l, dtype=torch.float32,
                                             device=self.device).contiguous()
                          for w, l in self.layers.items()}
        self._store: dict[str, dict[int, np.ndarray]] = {
            w: {} for w in self.layers}
        self._flows = (None if flow_factory is None
                       else {w: flow_factory(w) for w in self.layers})
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.flow_calls = 0
        self.evaluated = 0
        self.peek_hits = 0
        self.peek_misses = 0
        self.invalidated = 0

    def invalidate_rows(self, rows) -> None:
        """Drop the entries of pool rows whose design changed (the memo is
        keyed by row index; the disk cache is keyed by the design itself and
        needs nothing)."""
        for r in np.asarray(rows).reshape(-1):
            for store in self._store.values():
                if store.pop(int(r), None) is not None:
                    self.invalidated += 1

    def peek(self, workload: str, row) -> np.ndarray | None:
        """Lookup of one pool row without evaluating it (counted apart from
        the flushes' hits and misses)."""
        y = self._store[workload].get(int(row))
        if y is None:
            self.peek_misses += 1
        else:
            self.peek_hits += 1
        return y

    def store(self, workload: str, row, y) -> None:
        """Record a result evaluated elsewhere."""
        if int(row) not in self._store[workload]:
            self.evaluated += 1
        self._store[workload][int(row)] = np.asarray(y)

    @property
    def requests(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.requests, 1)

    def summary(self) -> str:
        disk = (f", {self.disk_hits} disk hits" if self.disk is not None
                else "")
        return (f"cache: {self.requests} requests, {self.hits} hits "
                f"({100.0 * self.hit_rate:.1f}%){disk}, {self.evaluated} "
                f"designs evaluated in {self.flow_calls} flow dispatches")

    def evaluate_many(self, reqs: list[tuple[str, np.ndarray]]
                      ) -> list[np.ndarray]:
        """Resolve ``[(workload, rows), ...]`` -> ``[y [len(rows), 3], ...]``;
        every miss of every request is evaluated in one flush first."""
        pending: dict[str, list[int]] = {}
        for wl, rows in reqs:
            store = self._store[wl]
            seen = pending.setdefault(wl, [])
            for r in np.asarray(rows).reshape(-1):
                r = int(r)
                if r in store or r in seen:
                    self.hits += 1
                else:
                    seen.append(r)
                    self.misses += 1
        self._flush({w: rows for w, rows in pending.items() if rows})
        return [np.stack([self._store[wl][int(r)]
                          for r in np.asarray(rows).reshape(-1)])
                for wl, rows in reqs]

    def evaluate(self, workload: str, rows: np.ndarray) -> np.ndarray:
        return self.evaluate_many([(workload, rows)])[0]

    def _values(self, rows: list[int]) -> torch.Tensor:
        """Raw design values [k, 26] of pool rows, on the device."""
        return torch.as_tensor(self.space.values(self.pool_idx[np.asarray(rows)]),
                               dtype=torch.float32, device=self.device)

    def _keep(self, wl: str, r: int, y) -> None:
        """Store one computed result, and write it back to the disk."""
        self._store[wl][r] = y
        if self.disk is not None:
            self.disk.put(wl, self.pool_idx[r], y)

    def _flush(self, pending: dict[str, list[int]]) -> None:
        if self.disk is not None:
            # what the shared corpus already holds costs no dispatch
            for wl in list(pending):
                left = []
                for r in pending[wl]:
                    y = self.disk.get(wl, self.pool_idx[r])
                    if y is None:
                        left.append(r)
                    else:
                        self._store[wl][r] = np.asarray(y)
                        self.disk_hits += 1
                if left:
                    pending[wl] = left
                else:
                    del pending[wl]
        if not pending:
            return
        if self._flows is not None:
            for wl, rows in pending.items():
                self.flow_calls += 1
                self.evaluated += len(rows)
                y = np.atleast_2d(np.asarray(
                    self._flows[wl](self.pool_idx[np.asarray(rows)])))
                for r, yr in zip(rows, y):
                    self._keep(wl, r, yr)
            return
        self.flow_calls += 1
        self.evaluated += sum(len(r) for r in pending.values())
        if len(pending) == 1:
            (wl, rows), = pending.items()
            y = _systolic_eval.soc_metrics(
                self._values(rows).contiguous(),
                self._layers_t[wl]).cpu().numpy()
            for r, yr in zip(rows, y):
                self._keep(wl, r, yr)
            return
        names = list(pending)
        rmax = max(len(pending[w]) for w in names)
        vals = torch.stack([
            self._values(pending[w] + pending[w][:1] * (rmax - len(pending[w])))
            for w in names]).contiguous()
        layers, mask = pad_workloads([self.layers[w] for w in names])
        y = _systolic_eval.soc_metrics_multi(
            vals, torch.as_tensor(layers, dtype=torch.float32,
                                  device=self.device).contiguous(),
            torch.as_tensor(mask, dtype=torch.float32,
                            device=self.device).contiguous()).cpu().numpy()
        for wi, w in enumerate(names):
            for ri, r in enumerate(pending[w]):
                self._keep(w, r, y[wi, ri])


@dataclasses.dataclass
class FleetResult:
    scenarios: list[FleetScenario]
    results: list[TunerResult]      # per scenario, soc_tuner's layout
    cache: FlowEvalCache
    wall_s: float

    def final_adrs(self) -> dict[str, float]:
        """label -> last-round ADRS (scenarios with a reference front)."""
        return {sc.label: res.history[-1]["adrs"]
                for sc, res in zip(self.scenarios, self.results)
                if "adrs" in res.history[-1]}


@dataclasses.dataclass
class _ScenarioState:
    """Host-side bookkeeping of one scenario between fleet rounds."""

    draws: TunerDraws
    v: np.ndarray
    pruned: DesignSpace
    pool_icd: torch.Tensor           # [N, d]
    evaluated: list[int]
    y: np.ndarray                    # [k, 3]
    weights: tuple[float, ...] | None
    history: list[dict]


def _log_round(st: _ScenarioState, i: int, label: str,
               reference_front: np.ndarray | None, verbose: bool,
               tag: str = "fleet", wall_s: float | None = None,
               events=None, device=None) -> None:
    """One scenario's progress record for round (or evaluation) ``i``: the
    helper ``fleet_tuner``, ``fleet_service`` and the server's jobs share."""
    log_progress(st.history, st.y, len(st.evaluated), i, reference_front,
                 verbose=verbose, tag=tag, label=label, wall_s=wall_s,
                 events=events, device=device)


def fleet_prologue(space: DesignSpace, pool_idx: np.ndarray,
                   scenarios: Sequence[FleetScenario], cache: FlowEvalCache,
                   draws: Sequence[TunerDraws], *, n: int, mu: float, b: int,
                   v_th: float, reuse_icd_trials: bool, device=None,
                   snap: dict | None = None) -> list[_ScenarioState]:
    """Algorithm 3 lines 1-4 for every scenario: the ICD trials of all
    scenarios in one flush, then each scenario's importance, pruning and
    TED init, then the init evaluations in one flush. Scenario i's
    ``draws[i].prologue`` is called once, as ``soc_tuner`` calls it.

    With ``snap`` (a ``fleet_tuner`` checkpoint) nothing is evaluated: each
    scenario's pruning and pool features are rebuilt from its stored
    importance vector, its rows, metrics and history are the stored ones,
    and its draws continue from their stored state."""
    dev = resolve_device(device)
    if snap is not None:
        states = []
        for si, (sc, dr) in enumerate(zip(scenarios, draws)):
            v = np.asarray(snap["vs"][str(si)])
            _, pruned, pool_icd = soc_init(space, pool_idx, v, v_th=v_th,
                                           b=b, mu=mu, device=dev)
            dr.load_state_dict(snap["draws"][si])
            states.append(_ScenarioState(
                draws=dr, v=v, pruned=pruned, pool_icd=pool_icd,
                evaluated=[int(r) for r in snap["evaluated"][str(si)]],
                y=np.asarray(snap["ys"][str(si)]),
                weights=(None if tuple(sc.weights) == (1.0, 1.0, 1.0)
                         else tuple(float(w) for w in sc.weights)),
                history=list(snap["histories"][str(si)])))
        return states
    N = pool_idx.shape[0]
    trial_sets = [np.asarray(dr.prologue(N, n)) for dr in draws]
    states = [_ScenarioState(
        draws=dr, v=np.zeros(space.d), pruned=space, pool_icd=None,
        evaluated=[], y=np.zeros((0, 3)),
        weights=(None if tuple(sc.weights) == (1.0, 1.0, 1.0)
                 else tuple(float(w) for w in sc.weights)),
        history=[]) for sc, dr in zip(scenarios, draws)]
    trial_ys = cache.evaluate_many(
        [(sc.workload, rows) for sc, rows in zip(scenarios, trial_sets)])

    init_reqs = []
    for sc, st, trial_rows, trial_y in zip(scenarios, states, trial_sets,
                                           trial_ys):
        st.v = icd_from_data(space, pool_idx[trial_rows], trial_y)
        init_rows, st.pruned, st.pool_icd = soc_init(
            space, pool_idx, st.v, v_th=v_th, b=b, mu=mu, device=dev)
        st.evaluated = list(dict.fromkeys(int(r) for r in init_rows))
        init_reqs.append((sc.workload, np.asarray(st.evaluated)))
    init_ys = cache.evaluate_many(init_reqs)

    for sc, st, trial_rows, trial_y, init_y in zip(
            scenarios, states, trial_sets, trial_ys, init_ys):
        st.evaluated, st.y = merge_trial_evals(
            st.evaluated, init_y, trial_rows, trial_y, reuse_icd_trials)
    return states


def fleet_tuner(
    space: DesignSpace,
    pool_idx: np.ndarray,
    scenarios: Sequence[FleetScenario],
    *,
    T: int = 40,
    n: int = 30,
    mu: float = 0.1,
    b: int = 20,
    v_th: float = 0.07,
    s_frontiers: int = 10,
    frontier_subset: int = 512,
    gp_steps: int = 150,
    reference_fronts: dict[str, np.ndarray] | None = None,
    reuse_icd_trials: bool = True,
    incremental: bool = False,
    warm_start: bool | None = None,
    warm_steps: int | None = None,
    drift_tol: float = 1.0,
    pool_chunk: int | str | None = None,
    mesh=None,
    mesh_axis: str | None = None,
    disk_cache=None,
    flow_factory=None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    proposer=None,
    draws: Sequence[TunerDraws] | None = None,
    device=None,
    verbose: bool = False,
) -> FleetResult:
    """Explore every scenario of a fleet over the SAME candidate pool.

    The knobs are :func:`repro_torch.core.soc_tuner`'s and apply to every
    scenario; ``reference_fronts`` maps a workload to its true Pareto front
    for the per-round ADRS. ``draws`` holds one :class:`TunerDraws` a
    scenario (default: ``GeneratorDraws(sc.seed, device)``). The rounds run
    on one :class:`BatchedBOEngine` on ``device`` (default ``cuda``; the CPU
    only when asked for): ``incremental=False`` is the exact fleet round,
    ``incremental=True`` warm fits, block Cholesky updates and one
    ``round_fused`` launch a scenario, the refactor decided per scenario.
    ``flow_factory`` (``workload -> flow``) replaces the built-in cost model
    (see :class:`FlowEvalCache`). Returns one ``TunerResult`` a scenario,
    in ``soc_tuner``'s layout (each round's ``wall_s`` is the fleet round's),
    and the cache.

    ``checkpoint_dir`` / ``checkpoint_every`` / ``resume`` snapshot the
    whole fleet (batched engine, each scenario's draws state, rows and
    history) and continue a cut run bit-exactly, as ``soc_tuner``'s do.
    ``proposer`` (incremental only) runs the between-round proposer
    fleet-wide: parents are the union of every scenario's front, victims the
    columns no scenario still values (the max over scenarios of
    ``pool_scores``), its draws scenario 0's; the live pool (a private copy
    that the cache aliases) is edited in place and the replaced rows' cache
    entries are dropped.

    ``disk_cache`` (a path or a
    :class:`repro_torch.service.flowcache.FlowDiskCache`) backs the memo
    with the on-disk cache that service runs, other fleets and the
    reference share (see :class:`FlowEvalCache`).

    ``mesh`` (a :class:`repro_torch.parallel.sharding.Mesh`; incremental
    only, not with ``proposer``) splits the fleet into scenario groups, one
    a device of the mesh axis ``mesh_axis`` (default: its first axis); ``S``
    must divide evenly over it. Each round runs every group's fits, then
    decides the refactor fleet-wide, then every group's factors and K4
    launches, and gathers the picks (``BatchedBOEngine``). The prologue,
    the flow cache and the fronts stay on ``device``.
    """
    t0 = time.monotonic()
    scenarios = list(scenarios)
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
        # a private copy: the proposer edits it, and the cache below
        # aliases the same array, so its flushes see the live designs
        pool_idx = np.array(pool_idx)
    dev = resolve_device(device)
    # IEEE float32 products everywhere, never TF32 (as soc_tuner)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    draws = ([GeneratorDraws(sc.seed, dev) for sc in scenarios]
             if draws is None else list(draws))
    if len(draws) != len(scenarios):
        raise ValueError(f"fleet_tuner: {len(scenarios)} scenarios but "
                         f"{len(draws)} draws")
    N = pool_idx.shape[0]
    reference_fronts = reference_fronts or {}
    cache = FlowEvalCache(space, pool_idx, [sc.workload for sc in scenarios],
                          disk=disk_cache, flow_factory=flow_factory,
                          device=dev)

    config = {"n": int(n), "b": int(b), "mu": float(mu),
              "v_th": float(v_th), "gp_steps": int(gp_steps),
              "s_frontiers": int(s_frontiers),
              "frontier_subset": int(frontier_subset),
              "incremental": bool(incremental), "pool_chunk": pool_chunk,
              "warm_start": warm_start, "warm_steps": warm_steps,
              "drift_tol": float(drift_tol),
              "reuse_icd_trials": bool(reuse_icd_trials),
              # the exact per-scenario parameters (a label rounds weights)
              "scenario_params": [
                  [sc.workload, int(sc.seed), [float(w) for w in sc.weights]]
                  for sc in scenarios]}
    if pcfg.enabled:
        config["proposer"] = pcfg.as_dict()
    # the pool as passed: the proposer edits its copy, and a resuming
    # caller passes the original
    pool_fp = _pool_fingerprint(pool_idx)
    snap = None
    if resume and checkpoint_dir:
        snap = ckpt.load_latest_validated(
            checkpoint_dir, driver="fleet_tuner", pool=pool_fp, config=config)
        if snap is not None and \
                snap["scenarios"] != [sc.label for sc in scenarios]:
            raise ValueError(f"checkpoint in {checkpoint_dir} was taken for "
                             f"scenarios {snap['scenarios']} — resume "
                             "requires the identical fleet")
        if snap is not None and pcfg.enabled and "pool_live" in snap:
            # in place: the cache aliases this array
            np.copyto(pool_idx, np.asarray(snap["pool_live"]))
            pstats = ProposerStats.from_dict(snap["proposer_stats"])

    states = fleet_prologue(space, pool_idx, scenarios, cache, draws, n=n,
                            mu=mu, b=b, v_th=v_th,
                            reuse_icd_trials=reuse_icd_trials, device=dev,
                            snap=snap)
    t_round = time.monotonic()

    def log_round(i: int) -> None:
        nonlocal t_round
        now = time.monotonic()
        for sc, st in zip(scenarios, states):
            _log_round(st, i, sc.label, reference_fronts.get(sc.workload),
                       verbose, wall_s=now - t_round, device=dev)
        t_round = now

    start_round = 0 if snap is None else int(snap["round"])
    if snap is None:
        log_round(0)
    any_weights = any(st.weights is not None for st in states)
    weights = (np.asarray([st.weights or (1.0, 1.0, 1.0) for st in states],
                          np.float32) if any_weights else None)

    # Lines 5-10: the BO loop, batched across scenarios on one engine (it
    # negates the targets and owns the masks and the argmax)
    engine = BatchedBOEngine(torch.stack([st.pool_icd for st in states]),
                             incremental=incremental, warm_start=warm_start,
                             gp_steps=gp_steps, warm_steps=warm_steps,
                             drift_tol=drift_tol, s_frontiers=s_frontiers,
                             weights=weights, pool_chunk=pool_chunk,
                             mesh=mesh, mesh_axis=mesh_axis, device=dev)
    if snap is None:
        engine.observe([st.evaluated for st in states],
                       [st.y for st in states])
    else:
        engine.load_state_dict(snap["engine"])

    def encode_cols(cols: np.ndarray) -> torch.Tensor:
        return torch.stack([_encode_cols(space, st.pruned, st.v, dev)(cols)
                            for st in states])

    def save_checkpoint(round_i: int) -> None:
        d = {"driver": "fleet_tuner", "round": round_i, "pool": pool_fp,
             "config": config, "scenarios": [sc.label for sc in scenarios],
             "draws": [st.draws.state_dict() for st in states],
             "vs": {str(si): np.asarray(st.v)
                    for si, st in enumerate(states)},
             "evaluated": {str(si): np.asarray(st.evaluated, np.int64)
                           for si, st in enumerate(states)},
             "ys": {str(si): st.y for si, st in enumerate(states)},
             "histories": {str(si): st.history
                           for si, st in enumerate(states)},
             "engine": engine.state_dict()}
        if pcfg.enabled:
            d["pool_live"] = np.array(pool_idx)
            d["proposer_stats"] = pstats.as_dict()
        ckpt.save_snapshot(ckpt.snapshot_path(checkpoint_dir, round_i), d)
        ckpt.prune_snapshots(checkpoint_dir)

    for it in range(start_round, T):
        subs, eps = zip(*(st.draws.round(N, frontier_subset, engine.m,
                                         s_frontiers) for st in states))
        picks = [int(p) for p in engine.select(
            list(eps), sub_rows=None if subs[0] is None else np.stack(subs))]
        # Line 8: every scenario's pick in one flush
        pick_ys = cache.evaluate_many(
            [(sc.workload, np.asarray([p]))
             for sc, p in zip(scenarios, picks)])
        engine.observe([[p] for p in picks], pick_ys)
        for st, p, y_new in zip(states, picks, pick_ys):
            st.evaluated.append(p)
            st.y = np.concatenate([st.y, y_new], axis=0)
        log_round(it + 1)
        # Between-round proposal, fleet-wide, from scenario 0's draws
        # (no scenario's round stream advances); before the checkpoint, so
        # a resumed run sees the pool the next round would have seen.
        if pcfg.enabled and (it + 1) % pcfg.every == 0:
            out = propose_and_replace(
                engine, space, functools.partial(states[0].draws.propose, it),
                pool_idx, cfg=pcfg, encode_cols=encode_cols,
                evaluated=[st.evaluated for st in states],
                ys=[st.y for st in states], stats=pstats)
            if out is not None:
                pool_idx[out.victims] = out.new_idx   # the cache aliases it
                cache.invalidate_rows(out.victims)
        if checkpoint_dir and (it + 1) % checkpoint_every == 0:
            save_checkpoint(it + 1)

    wall = time.monotonic() - t0
    results = []
    for st in states:
        rows = np.asarray(st.evaluated)
        front = _front(st.y, dev)
        stats_d = engine.stats.as_dict()
        if pcfg.enabled:
            stats_d["proposer"] = pstats.as_dict()
        results.append(TunerResult(
            space=st.pruned, v=np.asarray(st.v), evaluated_rows=rows, y=st.y,
            pareto_rows=rows[front], pareto_y=st.y[front],
            history=st.history, wall_s=wall, engine_stats=stats_d,
            pool_live=np.array(pool_idx) if pcfg.enabled else None))
    return FleetResult(scenarios=scenarios, results=results, cache=cache,
                       wall_s=wall)

"""Preemptible tuning jobs — the unit of work of the :class:`TunerServer`.

A port of ``repro.service.jobs``. A :class:`Job` is one scenario's
asynchronous exploration loop
(:func:`repro_torch.service.fleet_runner.fleet_service` at fleet size one),
cut into a state machine the server steps one cycle at a time::

    PENDING ──start──> RUNNING ──budget/pool exhausted──> DONE
                        │  ▲ │
                  pause │  │ └──flow failure (retries spent)──> FAILED
                        ▼  │ resume                               │ resume
                      PAUSED ─────────────────────────────────────┘
                        (cancel reaches CANCELLED from any live state)

Each :meth:`Job.step` is one ``fleet_service`` cycle for this job: refill
the in-flight set up to ``q`` by fantasy ``select_q``, drain exactly
``min_done`` completions in ticket order from the SHARED
:class:`~repro_torch.service.pool.FlowPool`, observe, checkpoint. Feed-back
order and batch size are functions of the job's own state, so a job's
trajectory does not depend on the other jobs on the server.

Preemption (:meth:`pause`, budget exhaustion, a server kill) evicts the
job's engine through the ``state_dict`` codecs: the snapshot is the format
``fleet_service`` writes (driver ``"tuner_server"``, fleet size one, the
draws' state under ``"draws"``), the engine's device arrays are freed by
:meth:`repro_torch.core.engine.BatchedBOEngine.release`, and in-flight
tickets are abandoned without losing worker results (they land in the disk
cache for the resume to hit). ``start(resume=True)`` restores the job bit
for bit from the in-memory eviction record or the latest snapshot on disk.
All engine work runs on the scheduler's thread.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.core.engine import FANTASY_MODES, BatchedBOEngine
from repro_torch.core.fleet import (FleetScenario, FlowEvalCache, _log_round,
                                    fleet_prologue)
from repro_torch.core.propose import (ProposerConfig, ProposerStats,
                                      propose_and_replace)
from repro_torch.core.tuner import (TunerResult, _encode_cols, _front,
                                    _pool_fingerprint)
from repro_torch.device import resolve_device
from repro_torch.obs import MetricsRegistry
from repro_torch.random import GeneratorDraws

from .checkpoint import (latest_snapshot, load_latest_validated,
                         load_snapshot, prune_snapshots, save_snapshot,
                         snapshot_path)

__all__ = ["JobSpec", "Job", "JOB_STATES", "PENDING", "RUNNING", "PAUSED",
           "DONE", "FAILED", "CANCELLED"]

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
DONE = "DONE"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
JOB_STATES = (PENDING, RUNNING, PAUSED, DONE, FAILED, CANCELLED)

#: states a job can never leave (FAILED can: resume retries from the last
#: checkpoint; CANCELLED and DONE are final).
SETTLED = (DONE, FAILED, CANCELLED)

JOB_DRIVER = "tuner_server"


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """Everything that defines a job's trajectory, wire-serializable; its
    wire dict is the reference's.

    The exploration knobs mirror :func:`fleet_service`'s (same defaults);
    ``priority`` is scheduling metadata — higher admits and steps first —
    and not part of the checkpoint's config guard.
    """

    workload: str = "resnet50"
    seed: int = 0
    weights: tuple = (1.0, 1.0, 1.0)
    T: int = 40
    q: int = 1
    min_done: int = 1
    fantasy: str = "mean"
    priority: int = 0
    n: int = 30
    mu: float = 0.1
    b: int = 20
    v_th: float = 0.07
    s_frontiers: int = 10
    frontier_subset: int = 512
    gp_steps: int = 150
    reuse_icd_trials: bool = True
    incremental: bool = True
    warm_start: bool | None = None
    warm_steps: int | None = None
    drift_tol: float = 1.0
    pool_chunk: int | str | None = None
    bucket: int | None = None
    #: between-round proposer knobs (a ``ProposerConfig`` wire dict, or
    #: None = off)
    proposer: dict | None = None

    def __post_init__(self):
        object.__setattr__(self, "weights",
                           tuple(float(w) for w in self.weights))
        pcfg = ProposerConfig.from_arg(self.proposer)  # validates knobs
        if pcfg.enabled and not self.incremental:
            raise ValueError("proposer requires incremental=True (victim "
                             "scoring runs on the incremental engine's "
                             "cached round state)")
        if self.T < 1:
            raise ValueError(f"T must be >= 1, got {self.T}")
        if self.q < 1:
            raise ValueError(f"q must be >= 1, got {self.q}")
        if self.q > 1 and not self.incremental:
            raise ValueError("q > 1 requires incremental=True (fantasy "
                             "q-batch selection runs on the incremental "
                             "engine)")
        if not 1 <= self.min_done <= self.q:
            raise ValueError(f"min_done must be in [1, q={self.q}], got "
                             f"{self.min_done}")
        if self.fantasy not in FANTASY_MODES:
            raise ValueError(f"fantasy must be one of {FANTASY_MODES}, got "
                             f"{self.fantasy!r}")
        if len(self.weights) != 3:
            raise ValueError(f"weights must have 3 entries, got "
                             f"{self.weights!r}")

    @property
    def scenario(self) -> FleetScenario:
        return FleetScenario(self.workload, seed=self.seed,
                             weights=self.weights)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["weights"] = list(d["weights"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown JobSpec field(s) {sorted(extra)}; "
                             f"expected a subset of {sorted(known)}")
        return cls(**d)

    def config(self) -> dict:
        """The trajectory-defining config the checkpoint guards —
        ``fleet_service``'s keys at fleet size one. ``T`` is included but
        exempt from the resume guard."""
        pcfg = ProposerConfig.from_arg(self.proposer)
        return {"T": int(self.T), "q": int(self.q),
                "min_done": int(self.min_done), "fantasy": self.fantasy,
                "n": int(self.n), "b": int(self.b), "mu": float(self.mu),
                "v_th": float(self.v_th), "gp_steps": int(self.gp_steps),
                "s_frontiers": int(self.s_frontiers),
                "frontier_subset": int(self.frontier_subset),
                "incremental": bool(self.incremental),
                "pool_chunk": self.pool_chunk,
                "warm_start": self.warm_start, "warm_steps": self.warm_steps,
                "drift_tol": float(self.drift_tol), "bucket": self.bucket,
                "reuse_icd_trials": bool(self.reuse_icd_trials),
                "scenario_params": [[self.workload, int(self.seed),
                                     [float(w) for w in self.weights]]],
                # joins the guard only when on
                **({"proposer": pcfg.as_dict()} if pcfg.enabled else {})}


class Job:
    """One preemptible exploration, stepped by the server one cycle at a
    time. All methods must be called from the scheduler thread.

    ``draws_factory`` (``spec -> TunerDraws``; default
    ``GeneratorDraws(spec.seed, device)``) gives a fresh start its draws; a
    resume loads their state from the snapshot."""

    def __init__(self, job_id: str, spec: JobSpec, *, space, pool_idx,
                 disk=None, checkpoint_dir: str | None = None,
                 checkpoint_every: int = 1, reference_front=None,
                 verbose: bool = False, metrics=None, events=None,
                 draws_factory=None, device=None):
        self.id = str(job_id)
        self.spec = spec
        self.space = space
        self.pool_idx = np.asarray(pool_idx)
        self.device = resolve_device(device)
        self._draws_factory = draws_factory or (
            lambda sp: GeneratorDraws(sp.seed, self.device))
        self._pcfg = ProposerConfig.from_arg(spec.proposer)
        self._pstats = ProposerStats()
        self._prop_mark = 0
        if self._pcfg.enabled:
            # a private copy: this job's proposer edits it and its
            # evaluation cache aliases it
            self.pool_idx = np.array(self.pool_idx)
        # the pool as given: checkpoints of an edited pool must still
        # validate against the server's pool
        self._pool_fp = _pool_fingerprint(self.pool_idx)
        self.N = self.pool_idx.shape[0]
        self.disk = disk
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.reference_front = reference_front
        self.verbose = verbose

        self.status = PENDING
        self.error: str | None = None
        self.submit_seq: int | None = None   # submission order (server)
        self.admit_seq: int | None = None    # first-admission order (server)
        self.done = 0                        # BO-phase evaluations fed back
        self.cycle = 0
        self.wall_s = 0.0
        self._st = None                      # the scenario's state
        self._engine: BatchedBOEngine | None = None
        self._cache: FlowEvalCache | None = None
        self._flow = None
        self._pending: list[tuple[int, int]] = []   # (ticket, row)
        self._result: TunerResult | None = None
        self._snap_mem: dict | None = None   # eviction record (pause)
        self._t_start = None                 # monotonic; None unless RUNNING
        self._t_cycle = None
        # telemetry, shared with the owning server
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.events = events
        self._memo_hits = 0                  # survives engine teardown
        self._m_transitions = self.metrics.counter(
            "job_transitions_total", "job state-machine transitions")

    def _set_status(self, new: str) -> None:
        """The one place a job changes state: counts the transition and
        emits its event."""
        old = self.status
        self.status = new
        if old != new:
            self._m_transitions.inc(**{"from": old, "to": new})
        if self.events is not None:
            self.events.instant("job.state", cat="job", track=self.id,
                                **{"from": old, "to": new})

    @property
    def label(self) -> str:
        return f"{self.id}:{self.spec.scenario.label}"

    @property
    def pending_rows(self) -> list[int]:
        return [r for _, r in self._pending]

    def _active(self) -> bool:
        cap = self.N - len(set(self._st.evaluated)) - len(self._pending)
        return bool(self._pending) or (self.done < self.spec.T and cap > 0)

    # ------------------------------------------------------------ lifecycle
    def start(self, fpool, flow, *, resume: bool = False) -> None:
        """Admit the job: run (or restore) the Algorithm 3 prologue, build
        its engine, and on resume re-dispatch what was in flight at
        eviction. The prologue's flow evaluations run synchronously through
        the job's evaluation cache (disk-backed when attached)."""
        sp = self.spec
        snap = None
        if resume:
            snap = self._snap_mem
            if snap is None and self.checkpoint_dir:
                snap = load_latest_validated(
                    self.checkpoint_dir, driver=JOB_DRIVER,
                    pool=self._pool_fp,
                    config={k: v for k, v in sp.config().items()
                            if k != "T"})
        if snap is not None and self._pcfg.enabled and "pool_live" in snap:
            np.copyto(self.pool_idx, np.asarray(snap["pool_live"]))
            self._pstats = ProposerStats.from_dict(snap["proposer_stats"])
            self._prop_mark = int(snap["prop_mark"])
        self._flow = flow
        self._cache = FlowEvalCache(
            self.space, self.pool_idx, [sp.workload], disk=self.disk,
            flow_factory=lambda wl, _f=flow: _f, device=self.device)
        sc = sp.scenario
        st = self._st = fleet_prologue(
            self.space, self.pool_idx, [sc], self._cache,
            [self._draws_factory(sp)], n=sp.n, mu=sp.mu, b=sp.b,
            v_th=sp.v_th, reuse_icd_trials=sp.reuse_icd_trials,
            device=self.device, snap=snap)[0]
        if snap is None:
            _log_round(st, 0, sc.label, self.reference_front, self.verbose,
                       f"server:{self.id}", device=self.device)

        engine_kw = dict(incremental=sp.incremental,
                         warm_start=sp.warm_start, gp_steps=sp.gp_steps,
                         warm_steps=sp.warm_steps, drift_tol=sp.drift_tol,
                         s_frontiers=sp.s_frontiers,
                         weights=(None if st.weights is None
                                  else np.asarray([st.weights], np.float32)),
                         pool_chunk=sp.pool_chunk, device=self.device)
        if sp.bucket is not None:
            engine_kw["bucket"] = int(sp.bucket)
        self._engine = BatchedBOEngine(torch.stack([st.pool_icd]),
                                       **engine_kw)
        self._pending = []
        if snap is None:
            self.done, self.cycle = 0, 0
            self._engine.observe([st.evaluated], [st.y])
        else:
            self._engine.load_state_dict(snap["engine"])
            self.done = int(np.asarray(snap["done"]).reshape(-1)[0])
            self.cycle = int(snap["cycle"])
            for r in (int(r) for r in snap["pending"]["0"]):
                self._pending.append((self._submit(fpool, r), r))
        self._snap_mem = None
        self._set_status(RUNNING)
        self.error = None
        self._t_start = self._t_cycle = time.monotonic()

    def _submit(self, fpool, row: int) -> int:
        y = self._cache.peek(self.spec.workload, row)
        if y is not None:
            return fpool.submit_resolved(row, y)
        return fpool.submit(row, self.pool_idx[row],
                            workload=self.spec.workload, flow=self._flow)

    def step(self, fpool) -> int:
        """One scheduler cycle: refill the in-flight set up to ``q``, drain
        exactly ``min_done`` completions in ticket order, observe,
        checkpoint. Returns the completions fed back; moves to DONE when
        the budget or pool is spent, to FAILED when an evaluation fails
        past the pool's retry budget."""
        if self.status != RUNNING:
            raise RuntimeError(f"step() on {self.status} job {self.id}")
        if self.events is not None:
            self.events.begin("job.step", cat="job", track=self.id,
                              cycle=self.cycle)
        try:
            return self._step(fpool)
        finally:
            if self.events is not None:
                self.events.end("job.step", cat="job", track=self.id,
                                done=self.done, status=self.status)

    def _step(self, fpool) -> int:
        sp, st, pending = self.spec, self._st, self._pending
        if not self._active():
            self._finish()
            return 0

        cap = self.N - len(set(st.evaluated)) - len(pending)
        want = max(0, min(sp.q - len(pending),
                          sp.T - self.done - len(pending), cap))
        if want > 0:
            sub, eps = st.draws.round(self.N, sp.frontier_subset,
                                      self._engine.m, sp.s_frontiers)
            picks = self._engine.select_q(
                [eps], want,
                sub_rows=None if sub is None else np.stack([sub]),
                pending=[[r for _, r in pending]], fantasy=sp.fantasy)
            for p in picks[0][:want]:
                pending.append((self._submit(fpool, int(p)), int(p)))

        take = min(sp.min_done, len(pending))
        obs_rows: list[int] = []
        obs_ys: list[np.ndarray] = []
        if take:
            tickets = [t for t, _ in pending[:take]]
            try:
                results = fpool.collect(tickets)
            except Exception as exc:
                self._fail(fpool, exc)
                return 0
            for t, row, y_row in results:
                self._cache.store(sp.workload, row, y_row)
                obs_rows.append(int(row))
                obs_ys.append(np.asarray(y_row))
            del pending[:take]
        self._engine.observe(
            [obs_rows],
            [np.stack(obs_ys) if obs_ys else np.zeros((0, 3), np.float32)])
        now = time.monotonic()
        for row, y_row in zip(obs_rows, obs_ys):
            st.evaluated.append(row)
            st.y = np.concatenate([st.y, y_row[None]], axis=0)
            self.done += 1
            _log_round(st, self.done, self.label, self.reference_front,
                       self.verbose, "server", wall_s=now - self._t_cycle,
                       events=self.events, device=self.device)
        self._t_cycle = now
        self.cycle += 1
        # per-job proposal (default off) from the job's proposer stream at
        # its completion count; in-flight rows are never victims
        if self._pcfg.enabled and obs_rows and \
                self.done // self._pcfg.every > self._prop_mark:
            out = propose_and_replace(
                self._engine, self.space,
                functools.partial(st.draws.propose, self.done),
                self.pool_idx, cfg=self._pcfg,
                encode_cols=lambda c: torch.stack([_encode_cols(
                    self.space, st.pruned, st.v, self.device)(c)]),
                evaluated=[st.evaluated], ys=[st.y],
                pending=[r for _, r in pending], stats=self._pstats)
            self._prop_mark = self.done // self._pcfg.every
            if out is not None:
                self.pool_idx[out.victims] = out.new_idx  # the cache aliases
                self._cache.invalidate_rows(out.victims)
        finished = not self._active()
        if self.checkpoint_dir and obs_rows and \
                (self.cycle % self.checkpoint_every == 0 or finished):
            self.checkpoint()
        if finished:
            self._finish()
        return len(obs_rows)

    def pause(self, fpool) -> None:
        """Preempt: snapshot the whole job (in memory, and on disk when a
        checkpoint dir is attached), abandon in-flight tickets without
        losing worker results, and free the engine's device arrays."""
        if self.status != RUNNING:
            raise ValueError(f"pause: job {self.id} is {self.status}, "
                             "not RUNNING")
        self._snap_mem = self._snapshot_record()
        if self.checkpoint_dir:
            self._write_snapshot(self._snap_mem)
        self._evict(fpool)
        self._set_status(PAUSED)

    def cancel(self, fpool) -> None:
        if self.status in (DONE, CANCELLED):
            raise ValueError(f"cancel: job {self.id} is already "
                             f"{self.status}")
        if self.status == RUNNING:
            self._evict(fpool)
        self._set_status(CANCELLED)

    def _evict(self, fpool) -> None:
        fpool.abandon([t for t, _ in self._pending])
        self._pending = []
        if self._t_start is not None:
            self.wall_s += time.monotonic() - self._t_start
            self._t_start = None
        self._teardown_engine()

    def _fail(self, fpool, exc: BaseException) -> None:
        self.error = f"{type(exc).__name__}: {exc}"
        self._evict(fpool)
        self._set_status(FAILED)

    def _finish(self) -> None:
        st = self._st
        if self._t_start is not None:
            self.wall_s += time.monotonic() - self._t_start
            self._t_start = None
        rows = np.asarray(st.evaluated)
        front = _front(st.y, self.device)
        stats_d = self._engine.stats.as_dict()
        if self._pcfg.enabled:
            stats_d["proposer"] = self._pstats.as_dict()
        self._result = TunerResult(
            space=st.pruned, v=np.asarray(st.v), evaluated_rows=rows,
            y=st.y, pareto_rows=rows[front], pareto_y=st.y[front],
            history=st.history, wall_s=self.wall_s,
            engine_stats=stats_d,
            pool_live=np.array(self.pool_idx) if self._pcfg.enabled
            else None)
        # fold the finished engine's counters into the registry once, at
        # the terminal transition (a resume restores cumulative stats)
        self._engine.stats.fold_into(self.metrics)
        if self._pcfg.enabled:
            self._pstats.fold_into(self.metrics)
        self._teardown_engine()
        self._set_status(DONE)

    def _teardown_engine(self) -> None:
        if self._engine is not None:
            self._engine.release()
        if self._cache is not None:
            self._memo_hits = self._cache.peek_hits
        self._engine = None
        self._cache = None
        self._flow = None

    @property
    def memo_hits(self) -> int:
        """Fleet-memo (``FlowEvalCache.peek``) hits: the live cache's while
        the job runs, the value frozen at teardown otherwise."""
        return (self._cache.peek_hits if self._cache is not None
                else self._memo_hits)

    # ----------------------------------------------------------- checkpoint
    def _snapshot_record(self) -> dict:
        st = self._st
        rec = {
            "driver": JOB_DRIVER, "cycle": self.cycle,
            "pool": self._pool_fp,
            "config": self.spec.config(),
            "scenarios": [self.spec.scenario.label],
            "done": np.asarray([self.done], np.int64),
            "draws": [st.draws.state_dict()],
            "vs": {"0": np.asarray(st.v)},
            "evaluated": {"0": np.asarray(st.evaluated, np.int64)},
            "ys": {"0": st.y},
            "histories": {"0": st.history},
            "pending": {"0": np.asarray([r for _, r in self._pending],
                                        np.int64)},
            "engine": self._engine.state_dict()}
        if self._pcfg.enabled:
            rec["pool_live"] = np.array(self.pool_idx)
            rec["proposer_stats"] = self._pstats.as_dict()
            rec["prop_mark"] = int(self._prop_mark)
        return rec

    def _write_snapshot(self, rec: dict) -> None:
        save_snapshot(snapshot_path(self.checkpoint_dir, self.cycle), rec)
        prune_snapshots(self.checkpoint_dir)

    def checkpoint(self) -> None:
        """Write the current state to the job's checkpoint dir (a no-op
        once the engine is torn down: the cycle that finished the job wrote
        the last snapshot)."""
        if self._st is None or self._engine is None or \
                not self.checkpoint_dir:
            return
        self._write_snapshot(self._snapshot_record())

    # -------------------------------------------------------------- results
    def result(self) -> TunerResult | None:
        """The in-memory result (DONE jobs finished in this process)."""
        return self._result

    def result_dict(self) -> dict | None:
        """JSON-able trajectory: from the in-memory result when present,
        else rebuilt from the latest snapshot on disk."""
        if self._result is not None:
            res = self._result
            return {"evaluated_rows": [int(r) for r in res.evaluated_rows],
                    "y": np.asarray(res.y, np.float64).tolist(),
                    "pareto_rows": [int(r) for r in res.pareto_rows],
                    "history": res.history}
        snap = self._snap_mem
        if snap is None and self.checkpoint_dir:
            path = latest_snapshot(self.checkpoint_dir)
            if path is not None:
                snap = load_snapshot(path)
        if snap is None:
            return None
        rows = [int(r) for r in snap["evaluated"]["0"]]
        y = np.asarray(snap["ys"]["0"])
        front = _front(y, self.device)
        return {"evaluated_rows": rows,
                "y": np.asarray(y, np.float64).tolist(),
                "pareto_rows": [int(r) for r in np.asarray(rows)[front]],
                "history": list(snap["histories"]["0"])}

    def info(self) -> dict:
        """One status row (the wire ``status`` payload). ``engine_bytes``
        reads tensor metadata only: no sync, no launch."""
        engine = self._engine
        return {"id": self.id, "label": self.label, "status": self.status,
                "workload": self.spec.workload, "seed": self.spec.seed,
                "priority": self.spec.priority, "T": self.spec.T,
                "done": self.done, "cycle": self.cycle,
                "in_flight": len(self._pending),
                "memo_hits": self.memo_hits,
                "engine_bytes": 0 if engine is None else engine.device_bytes(),
                "error": self.error}

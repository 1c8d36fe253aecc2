"""Multi-tenant tuning server: a job queue/scheduler over ONE shared pool.

A port of ``repro.service.server``. :class:`TunerServer` multiplexes many
tuning jobs (:mod:`.jobs`) onto one shared
:class:`~repro_torch.service.pool.FlowPool` and
:class:`~repro_torch.service.flowcache.FlowDiskCache` — the production shape of
the exploration service, where the hours-long VLSI flow is the resource
and tuning jobs come and go:

- **Admission** is deterministic: PENDING jobs are admitted in
  ``(-priority, submission order)`` whenever fewer than ``max_active``
  jobs are RUNNING. Admission pays the job's prologue (synchronous flow
  evaluations through the disk-backed evaluation cache).
- **Scheduling** is one :meth:`Job.step` per RUNNING job per cycle, in
  ``(-priority, admission order)``. Priorities order *service* (who admits
  and steps first), never exclusion — every RUNNING job steps every cycle,
  so nothing starves. Because each job drains its own tickets exactly
  ``min_done`` at a time in ticket order, a job's trajectory is a pure
  function of its own spec: bitwise-identical to an isolated
  ``fleet_service`` run of the same scenario, whatever else the server is
  doing.
- **Preemption**: ``pause`` evicts a job to its checkpoint (engine state
  dict, the draws' state, pending rows) and frees its device arrays; ``resume``
  re-admits it bit-exactly. Budget exhaustion does the same eviction with
  status DONE. Worker faults surface as FAILED after the pool's retry
  budget; FAILED jobs resume from their last checkpoint.
- **Crash safety**: the server manifest (``server.json``) plus per-job
  snapshot dirs under ``checkpoint_dir`` make the whole job table
  restartable — a SIGKILL'd server restarted with ``resume=True`` resumes
  every job bit-exactly.

:func:`serve` adds the wire layer: a JSON-lines-over-TCP control plane
(``submit``/``status``/``metrics``/``pause``/``resume``/``cancel``/
``shutdown``) whose mutating verbs are applied by the scheduler thread
*between* cycles — the
wire can re-order operator requests, but never a job's trajectory.
:func:`request` is the matching one-shot client.

Every engine runs on the scheduler thread, on ``device`` (default
``cuda``); the handler threads answer ``status`` and ``metrics`` from host
counters and tensor metadata only (``engine_device_bytes`` makes no sync
and no launch).
"""
from __future__ import annotations

import json
import os
import queue
import signal
import socket
import threading
import time

import numpy as np

from repro_torch.core.tuner import _pool_fingerprint
from repro_torch.device import resolve_device
from repro_torch.obs import EventLog, MetricsRegistry

from .flowcache import FlowDiskCache
from .jobs import (DONE, FAILED, PAUSED, PENDING, RUNNING, SETTLED, Job,
                   JobSpec)
from .pool import FlowPool

__all__ = ["TunerServer", "serve", "request"]

MANIFEST_VERSION = 1


class TunerServer:
    """A deterministic scheduler multiplexing tuning jobs over one pool.

    All methods must be called from one thread (the scheduler's); the wire
    layer in :func:`serve` funnels remote mutations through a queue that
    is drained between cycles. ``max_active`` caps concurrently RUNNING
    (engine-resident) jobs; ``retries`` is the shared pool's per-design
    re-dispatch budget for failed evaluations. ``_kill_after`` is a test
    hook: SIGKILL the process right after the checkpoint covering that
    many total BO evaluations. Engines run on ``device`` (default
    ``cuda``); ``draws_factory`` (``JobSpec -> TunerDraws``) gives each
    job's fresh start its draws (default ``GeneratorDraws(spec.seed,
    device)``).
    """

    def __init__(self, space, pool_idx, *, max_workers: int = 4,
                 executor="process", flow_factory=None,
                 cache_dir: str | None = None,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 1, max_active: int | None = None,
                 retries: int = 0, resume: bool = False,
                 verbose: bool = False,
                 metrics: MetricsRegistry | None = None,
                 events: EventLog | str | None = None,
                 draws_factory=None, device=None,
                 _kill_after: int | None = None):
        if max_active is not None and max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {max_active}")
        self.space = space
        self.pool_idx = np.asarray(pool_idx)
        self.disk = FlowDiskCache(cache_dir) if cache_dir else None
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.max_active = max_active
        self.verbose = verbose
        self._kill_after = _kill_after
        self.device = resolve_device(device)
        self._draws_factory = draws_factory
        if flow_factory is None:
            from repro_torch.soc import VLSIFlow

            flow_factory = lambda wl: VLSIFlow(space, wl, device=self.device)
        self._flow_factory = flow_factory
        self._flows: dict = {}
        # Telemetry (host-side only — see repro_torch.obs). The registry is
        # shared by the pool, the disk cache, every job and the scheduler;
        # the wire `metrics` verb ships its snapshot. `events` may be an
        # EventLog or a path (a path is opened here, closed in close();
        # reopening an existing log — e.g. after SIGKILL — appends a new
        # generation).
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self._ev_owned = isinstance(events, str)
        self.events = (EventLog(events, run="tuner_server")
                       if self._ev_owned else events)
        # flow=None: every submit carries its job's flow explicitly.
        self._fpool = FlowPool(None, max_workers=max_workers,
                               executor=executor, cache=self.disk,
                               retries=retries, metrics=self.metrics,
                               events=self.events)
        if self.disk is not None:
            self.disk.bind_metrics(self.metrics)
        self._jobs: dict[str, Job] = {}
        self._seq = 0
        self._admit_seq = 0
        self.total_done = 0
        self.cycles = 0
        self.admissions = 0
        m = self.metrics
        self._m_cycles = m.counter("scheduler_cycles_total",
                                   "scheduler cycles driven")
        self._m_admissions = m.counter("scheduler_admissions_total",
                                       "job admissions (prologue paid)")
        self._m_evals = m.counter("scheduler_evals_total",
                                  "completions fed back to jobs")
        self._m_cycle_wall = m.histogram("scheduler_cycle_seconds",
                                         "run_cycle wall seconds")
        g_state = m.gauge("server_jobs", "jobs by state")
        g_bytes = m.gauge("engine_device_bytes",
                          "device bytes held by live job engines")
        g_memo = m.gauge("fleet_cache_memo_hits",
                         "fleet memo (FlowEvalCache) hits across jobs")

        def _collect():
            by_state: dict[str, int] = {}
            bts = memo = 0
            for j in self._jobs.values():
                by_state[j.status] = by_state.get(j.status, 0) + 1
                if getattr(j, "_engine", None) is not None:
                    bts += j._engine.device_bytes()
                memo += getattr(j, "memo_hits", 0)
            for s, n in by_state.items():
                g_state.set(n, state=s)
            g_bytes.set(bts)
            g_memo.set(memo)

        m.add_collector(_collect)
        if resume:
            self._load_manifest()

    # ------------------------------------------------------------- plumbing
    def _flow(self, workload: str):
        fl = self._flows.get(workload)
        if fl is None:
            fl = self._flows[workload] = self._flow_factory(workload)
        return fl

    def _get(self, job_id: str) -> Job:
        job = self._jobs.get(str(job_id))
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        return job

    def job(self, job_id: str) -> Job:
        return self._get(job_id)

    @property
    def jobs(self) -> dict[str, Job]:
        return dict(self._jobs)

    def _job_ckpt_dir(self, job_id: str) -> str | None:
        if not self.checkpoint_dir:
            return None
        return os.path.join(self.checkpoint_dir, "jobs", job_id)

    # ------------------------------------------------------------- manifest
    def _manifest_path(self) -> str:
        return os.path.join(self.checkpoint_dir, "server.json")

    def _save_manifest(self) -> None:
        if not self.checkpoint_dir:
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        rec = {"version": MANIFEST_VERSION,
               "pool": _pool_fingerprint(self.pool_idx),
               "seq": self._seq, "admit_seq": self._admit_seq,
               "total_done": self.total_done,
               **({"events": {"path": self.events.path,
                              "generation": self.events.generation}}
                  if self.events is not None else {}),
               "jobs": [{"id": j.id, "spec": j.spec.as_dict(),
                         "status": j.status, "submit_seq": j.submit_seq,
                         "admit_seq": j.admit_seq, "done": j.done,
                         "error": j.error}
                        for j in self._ordered(self._jobs.values())]}
        path = self._manifest_path()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=2)
        os.replace(tmp, path)

    def _load_manifest(self) -> None:
        if not self.checkpoint_dir or \
                not os.path.exists(self._manifest_path()):
            return
        with open(self._manifest_path()) as f:
            rec = json.load(f)
        if rec.get("version") != MANIFEST_VERSION:
            raise ValueError(f"server manifest version "
                             f"{rec.get('version')!r} is not "
                             f"{MANIFEST_VERSION}")
        if rec["pool"] != _pool_fingerprint(self.pool_idx):
            raise ValueError("server manifest was written for a different "
                             "candidate pool — resume must use the "
                             "identical pool")
        self._seq = int(rec["seq"])
        self._admit_seq = int(rec["admit_seq"])
        self.total_done = int(rec.get("total_done", 0))
        for jm in rec["jobs"]:
            job = self._make_job(jm["id"], JobSpec.from_dict(jm["spec"]))
            job.submit_seq = jm["submit_seq"]
            job.admit_seq = jm["admit_seq"]
            job.done = int(jm.get("done", 0))
            job.error = jm.get("error")
            status = jm["status"]
            if status == RUNNING:
                # was live at the kill: re-admit from its latest snapshot
                job.status = PENDING
                job._needs_resume = True
            else:
                job.status = status
                job._needs_resume = status in (PAUSED, FAILED, DONE)
            self._jobs[job.id] = job
        if self.verbose and self._jobs:
            live = sum(j.status in (PENDING, RUNNING)
                       for j in self._jobs.values())
            print(f"[server] resumed manifest: {len(self._jobs)} jobs "
                  f"({live} live)")

    # ---------------------------------------------------------------- verbs
    def _make_job(self, job_id: str, spec: JobSpec, *,
                  reference_front=None) -> Job:
        job = Job(job_id, spec, space=self.space, pool_idx=self.pool_idx,
                  disk=self.disk, checkpoint_dir=self._job_ckpt_dir(job_id),
                  checkpoint_every=self.checkpoint_every,
                  reference_front=reference_front, verbose=self.verbose,
                  metrics=self.metrics, events=self.events,
                  draws_factory=self._draws_factory, device=self.device)
        job._needs_resume = False
        return job

    def submit(self, spec, *, reference_front=None,
               job_id: str | None = None) -> str:
        """Admit a job spec to the queue; returns its job id."""
        if isinstance(spec, dict):
            spec = JobSpec.from_dict(spec)
        jid = f"j{self._seq:04d}" if job_id is None else str(job_id)
        if jid in self._jobs:
            raise ValueError(f"job id {jid!r} already exists")
        job = self._make_job(jid, spec, reference_front=reference_front)
        job.submit_seq = self._seq
        self._seq += 1
        self._jobs[jid] = job
        self._save_manifest()
        if self.events is not None:
            self.events.instant("job.submit", cat="server", track=jid,
                                workload=spec.workload,
                                priority=spec.priority, T=spec.T)
        if self.verbose:
            print(f"[server] submit {job.label} (priority "
                  f"{spec.priority}, T={spec.T})")
        return jid

    def pause(self, job_id: str) -> None:
        job = self._get(job_id)
        if job.status == PENDING:
            job._set_status(PAUSED)  # not yet admitted: nothing to evict
        else:
            job.pause(self._fpool)
        self._save_manifest()

    def resume_job(self, job_id: str) -> None:
        """Queue a PAUSED (or FAILED — retry from its last checkpoint) job
        for re-admission."""
        job = self._get(job_id)
        if job.status not in (PAUSED, FAILED):
            raise ValueError(f"resume: job {job_id} is {job.status}, not "
                             "PAUSED/FAILED")
        job._set_status(PENDING)
        job._needs_resume = (job._snap_mem is not None
                             or job.checkpoint_dir is not None)
        self._save_manifest()

    def cancel(self, job_id: str) -> None:
        self._get(job_id).cancel(self._fpool)
        self._save_manifest()

    def status(self, job_id: str | None = None) -> dict:
        if job_id is not None:
            return self._get(job_id).info()
        return {
            "jobs": {j.id: j.info()
                     for j in self._ordered(self._jobs.values())},
            "total_done": self.total_done, "cycles": self.cycles,
            "scheduler": {"cycles": self.cycles,
                          "admissions": self.admissions},
            "pool": {"dispatched": self._fpool.dispatched,
                     "cache_hits": self._fpool.cache_hits,
                     "inflight_hits": self._fpool.inflight_hits,
                     "retried": self._fpool.retried,
                     "abandoned": self._fpool.abandoned,
                     "outstanding": self._fpool.outstanding},
            "cache": (None if self.disk is None else self.disk.counters())}

    def metrics_snapshot(self) -> dict:
        """The wire ``metrics`` verb's payload: one JSON-able registry
        snapshot (collectors run first — see
        :meth:`repro_torch.obs.MetricsRegistry.snapshot`)."""
        return self.metrics.snapshot()

    # ------------------------------------------------------------ scheduler
    @staticmethod
    def _ordered(jobs):
        return sorted(jobs, key=lambda j: (-j.spec.priority,
                                           j.submit_seq or 0))

    def _admit(self) -> None:
        running = sum(j.status == RUNNING for j in self._jobs.values())
        for job in self._ordered(j for j in self._jobs.values()
                                 if j.status == PENDING):
            if self.max_active is not None and running >= self.max_active:
                break
            if job.admit_seq is None:
                job.admit_seq = self._admit_seq
                self._admit_seq += 1
            try:
                job.start(self._fpool, self._flow(job.spec.workload),
                          resume=job._needs_resume)
                self.admissions += 1
                self._m_admissions.inc()
                if self.events is not None:
                    self.events.instant("job.admit", cat="server",
                                        track=job.id, resume=job._needs_resume)
            except Exception as exc:  # a prologue flow failure
                job.error = f"{type(exc).__name__}: {exc}"
                job.status = FAILED
            job._needs_resume = False
            running += 1

    def run_cycle(self) -> int:
        """Admit what fits, then step every RUNNING job once in priority
        order. Returns the number of completions fed back this cycle."""
        t_cycle = time.monotonic()
        if self.events is not None:
            self.events.begin("cycle", cat="scheduler", track="scheduler",
                              cycle=self.cycles)
        self._admit()
        total = 0
        for job in self._ordered(j for j in self._jobs.values()
                                 if j.status == RUNNING):
            n = job.step(self._fpool)
            total += n
            self.total_done += n
            if self._kill_after is not None and \
                    self.total_done >= self._kill_after:
                job.checkpoint()  # ensure the covering snapshot is on disk
                self._save_manifest()
                os.kill(os.getpid(), signal.SIGKILL)
        self.cycles += 1
        self._m_cycles.inc()
        if total:
            self._m_evals.inc(total)
        self._m_cycle_wall.observe(time.monotonic() - t_cycle)
        if self.events is not None:
            self.events.end("cycle", cat="scheduler", track="scheduler",
                            done=total)
            # One cumulative-counter record per cycle: the SIGKILL-resume
            # test reads these back and asserts counters never regress
            # within a generation (and that the generation increments).
            self.events.instant("counters", cat="scheduler",
                                track="scheduler", cycles=self.cycles,
                                total_done=self.total_done,
                                dispatched=self._fpool.dispatched)
        if total or any(j.status == PENDING for j in self._jobs.values()):
            self._save_manifest()
        return total

    def has_runnable(self) -> bool:
        return any(j.status in (PENDING, RUNNING)
                   for j in self._jobs.values())

    def all_settled(self) -> bool:
        return all(j.status in SETTLED for j in self._jobs.values())

    def run_until_idle(self, max_cycles: int | None = None) -> int:
        """Drive cycles until no job is PENDING/RUNNING; returns the number
        of cycles driven."""
        n = 0
        while self.has_runnable():
            if max_cycles is not None and n >= max_cycles:
                break
            self.run_cycle()
            n += 1
        return n

    def close(self) -> None:
        self._save_manifest()
        self._fpool.close()
        if self.events is not None and self._ev_owned:
            self.events.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ================================================================== wire API
class _Control:
    __slots__ = ("verb", "args", "event", "reply")

    def __init__(self, verb: str, args: dict):
        self.verb = verb
        self.args = args
        self.event = threading.Event()
        self.reply: dict = {}


def _apply_control(server: TunerServer, ctl: _Control) -> bool:
    """Run one mutating verb on the scheduler thread. Returns True when the
    serve loop should shut down."""
    stop = False
    try:
        if ctl.verb == "submit":
            jid = server.submit(JobSpec.from_dict(ctl.args.get("spec", {})))
            ctl.reply = {"ok": True, "job": jid}
        elif ctl.verb == "pause":
            server.pause(ctl.args["job"])
            ctl.reply = {"ok": True, "job": ctl.args["job"]}
        elif ctl.verb == "resume":
            server.resume_job(ctl.args["job"])
            ctl.reply = {"ok": True, "job": ctl.args["job"]}
        elif ctl.verb == "cancel":
            server.cancel(ctl.args["job"])
            ctl.reply = {"ok": True, "job": ctl.args["job"]}
        elif ctl.verb == "shutdown":
            stop = True
            ctl.reply = {"ok": True, "shutdown": True}
        else:
            ctl.reply = {"ok": False,
                         "error": f"unknown verb {ctl.verb!r}"}
    except Exception as exc:
        ctl.reply = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
    finally:
        ctl.event.set()
    return stop


def serve(server: TunerServer, host: str = "127.0.0.1", port: int = 0, *,
          drain_exit: bool = False, poll_s: float = 0.05,
          ready_cb=None) -> None:
    """Run the scheduler loop with a JSON-lines TCP control plane.

    One request per connection: a single JSON object line with a ``verb``
    field (``submit``/``status``/``metrics``/``pause``/``resume``/
    ``cancel``/``shutdown``), one JSON reply line back. ``status`` and
    ``metrics`` are answered directly by the handler thread (read-only —
    a scrape must not wait out a long flow evaluation); every mutating
    verb is queued and applied by
    the scheduler between cycles, so remote requests can never cut a job's
    cycle in half. ``port=0`` picks a free port; ``ready_cb(port)`` fires
    once the socket is listening. ``drain_exit`` returns once every
    submitted job has settled (DONE/FAILED/CANCELLED); ``shutdown``
    checkpoints RUNNING jobs (they stay RUNNING in the manifest, so a
    ``resume=True`` restart continues them) and returns.
    """
    import socketserver

    controls: "queue.Queue[_Control]" = queue.Queue()

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            line = self.rfile.readline()
            if not line.strip():
                return
            try:
                req = json.loads(line)
                verb = req.pop("verb")
            except Exception as exc:
                reply = {"ok": False,
                         "error": f"bad request: {exc}"}
            else:
                if verb in ("status", "metrics"):
                    # read-only: answered by the handler thread directly —
                    # a scrape must not wait out a long flow evaluation.
                    try:
                        if verb == "status":
                            reply = {"ok": True,
                                     "status": server.status(req.get("job"))}
                        else:
                            reply = {"ok": True,
                                     "metrics": server.metrics_snapshot()}
                    except Exception as exc:
                        reply = {"ok": False,
                                 "error": f"{type(exc).__name__}: {exc}"}
                else:
                    ctl = _Control(verb, req)
                    controls.put(ctl)
                    ctl.event.wait()
                    reply = ctl.reply
            self.wfile.write((json.dumps(reply) + "\n").encode())

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server((host, port), Handler) as sock_srv:
        lport = sock_srv.server_address[1]
        accept = threading.Thread(target=sock_srv.serve_forever,
                                  daemon=True)
        accept.start()
        if ready_cb is not None:
            ready_cb(lport)
        if server.verbose:
            print(f"[server] listening on {host}:{lport}")
        stop = False
        try:
            while not stop:
                while True:  # apply queued controls between cycles
                    try:
                        ctl = controls.get_nowait()
                    except queue.Empty:
                        break
                    stop = _apply_control(server, ctl) or stop
                if stop:
                    break
                if server.has_runnable():
                    server.run_cycle()
                elif drain_exit and server.all_settled():
                    break
                else:
                    try:
                        ctl = controls.get(timeout=poll_s)
                    except queue.Empty:
                        continue
                    stop = _apply_control(server, ctl) or stop
        finally:
            # graceful: persist live jobs so a resume continues them
            for job in server.jobs.values():
                if job.status == RUNNING:
                    job.checkpoint()
            server._save_manifest()
            while True:  # don't leave queued clients hanging
                try:
                    ctl = controls.get_nowait()
                except queue.Empty:
                    break
                ctl.reply = {"ok": False, "error": "server shutting down"}
                ctl.event.set()
            sock_srv.shutdown()


def request(port: int, obj: dict, host: str = "127.0.0.1",
            timeout: float = 120.0) -> dict:
    """One-shot wire client: send one JSON request line, return the parsed
    JSON reply."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        f = s.makefile("rwb")
        f.write((json.dumps(obj) + "\n").encode())
        f.flush()
        line = f.readline()
    if not line:
        raise ConnectionError("server closed the connection without a reply")
    return json.loads(line)

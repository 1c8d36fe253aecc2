"""Async flow-evaluation pool: concurrent workers + completion draining.

A port of ``repro.service.pool``. A :class:`FlowPool` owns a set of workers
(a ``spawn`` process pool by default — the VLSI flow is CPU-hours of work per
design point, and ``fork`` after CUDA is initialized is unsafe — or threads,
an inline synchronous executor for tests, or any user-supplied
``concurrent.futures.Executor``) and a ticket queue. ``submit(row, idx_row)`` dispatches ONE design point and
returns a monotonically increasing ticket; ``drain(min_done)`` blocks until
at least ``min_done`` completions are available and feeds them back.

Two drain disciplines:

- ``ordered=True`` (default): each drain releases exactly the requested
  number of completions, strictly in ticket order (a reorder buffer holds
  early finishers; nothing extra is taken even when more happen to be
  ready). Workers still run concurrently — ordering only defers
  *observation* — and both the feed-back order AND the batch size become
  independent of worker timing, which is what makes checkpoint/resume
  bit-exact and async runs reproducible.
- ``ordered=False``: completions are released as they land (opportunistic
  async BO); the trajectory then depends on arrival order and timing.

Every submit first consults the content-addressed
:class:`~repro_torch.service.flowcache.FlowDiskCache` (when attached): a hit
completes the ticket instantly without occupying a worker, and every real
completion is written back — so concurrent scenarios, restarts and later
runs never pay for the same design point twice.

**Workers and the card.** A ``cuda`` flow sent to a ``spawn`` worker opens
the worker's own CUDA context and loads the kernel library there, so the
parent builds the library before the first worker starts; a worker without
a card raises, and the error surfaces at :meth:`FlowPool.drain` or
:meth:`FlowPool.collect` (there is no CPU fallback in a worker). A
``fork`` pool is refused once CUDA is initialized. Kernel launch counts are
per process: a thread worker's launches land in the parent's counts, a
process worker's stay in the worker.
"""
from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry

from .flowcache import FlowDiskCache

__all__ = ["FlowPool", "InlineExecutor"]


def _prepare_processes(mp_context: str) -> None:
    """Before a process pool starts: refuse ``fork`` under a live CUDA
    context, and build the kernel library once in the parent so spawn
    workers only load it."""
    if mp_context == "fork" and torch.cuda.is_initialized():
        raise ValueError("FlowPool: a 'fork' process pool after CUDA is "
                         "initialized is unsafe; use mp_context='spawn'")
    if torch.cuda.is_available():
        from repro_torch.kernels import build

        build.library()


def _flow_task(flow, idx_row: np.ndarray) -> np.ndarray:
    """Worker entry: evaluate ONE design point -> y [m]."""
    return np.asarray(flow(np.atleast_2d(idx_row)))[0]


class InlineExecutor:
    """Synchronous ``Executor``: runs the task at submit time, in-process.

    The zero-concurrency baseline — ``FlowPool(executor="inline")`` makes the
    service loop execute exactly like the sequential tuner (used by the q=1
    parity tests and cheap CI smoke runs).
    """

    def submit(self, fn: Callable, *args, **kwargs) -> cf.Future:
        fut: cf.Future = cf.Future()
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as e:  # pragma: no cover - surfaced via result()
            fut.set_exception(e)
        return fut

    def shutdown(self, wait: bool = True, **_) -> None:
        pass


class FlowPool:
    """Dispatch flow evaluations to concurrent workers, ticket-ordered.

    ``flow`` must be picklable for the process executor (``VLSIFlow`` and
    ``DelayedFlow`` are — see ``repro_torch.soc.flow``). ``executor`` is ``"process"`` |
    ``"thread"`` | ``"inline"`` | an ``Executor`` instance (not shut down on
    :meth:`close` when caller-owned).

    One pool can serve MANY workloads/flows (the fleet service drives all
    its scenarios over a single pool): :meth:`submit` takes per-call
    ``workload``/``flow`` overrides, and identical in-flight design points
    are **deduplicated** — a second submit of a (workload, design point)
    whose evaluation is still running shares the first's future instead of
    occupying another worker (``inflight_hits`` counts these; the entry is
    retired when its first ticket drains, and a FAILED evaluation never
    blocks resubmission), which together with the disk cache means
    concurrent scenarios never pay for the same design point twice.

    ``retries`` re-dispatches a FAILED evaluation (worker death, flow
    exception) up to that many times at wait time, transparently to the
    ticket holder: every ticket riding the failed dispatch is repointed at
    the retry, the in-flight dedup entry is replaced (never poisoned), and
    only when the budget is exhausted does the failure surface from
    :meth:`collect`/:meth:`drain`. :meth:`abandon` forgets tickets without
    observing them (job preemption): running dispatches are left to finish
    and their results still land in the disk cache.
    """

    def __init__(self, flow, *, workload: str = "workload",
                 max_workers: int = 4, executor="process",
                 cache: FlowDiskCache | str | None = None,
                 mp_context: str = "spawn", retries: int = 0,
                 metrics: MetricsRegistry | None = None, events=None):
        self.flow = flow
        self.workload = str(workload)
        self.cache = (None if cache is None else
                      cache if isinstance(cache, FlowDiskCache)
                      else FlowDiskCache(cache))
        self._owned = isinstance(executor, str)
        if executor == "process":
            _prepare_processes(mp_context)
            self._ex = cf.ProcessPoolExecutor(
                max_workers=max_workers,
                mp_context=multiprocessing.get_context(mp_context))
        elif executor == "thread":
            self._ex = cf.ThreadPoolExecutor(max_workers=max_workers)
        elif executor == "inline":
            self._ex = InlineExecutor()
        elif isinstance(executor, str):
            raise ValueError(f"unknown executor {executor!r}; expected "
                             "'process', 'thread', 'inline' or an Executor")
        else:
            self._ex = executor
        self.retries = int(retries)
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self._next_ticket = 0
        self._rows: dict[int, int] = {}          # ticket -> pool row
        self._idx: dict[int, np.ndarray] = {}    # ticket -> design point
        self._wl: dict[int, str] = {}            # ticket -> workload
        self._flowref: dict[int, object] = {}    # ticket -> flow callable
        self._futs: dict[int, cf.Future] = {}    # tickets on workers
        self._ready: dict[int, np.ndarray] = {}  # completed, unconsumed
        self._inflight: dict[str, cf.Future] = {}  # content key -> future
        self._retry_counts: dict[str, int] = {}  # content key -> re-dispatches
        self.cache_hits = 0
        self.inflight_hits = 0
        self.dispatched = 0
        self.retried = 0
        self.abandoned = 0
        # --- telemetry (host-side only; see repro_torch.obs) ------------------
        # The plain int attributes above stay the source of truth for
        # status()/stats; the registry mirrors them as counters plus a
        # submit->drain latency histogram, and `events` (an
        # obs.EventLog or None) gets one instant per submit/complete so
        # every flow evaluation shows as its own bar in the Chrome trace.
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.events = events
        m = self.metrics
        self._m_dispatched = m.counter(
            "pool_dispatched_total", "flow evaluations sent to a worker")
        self._m_cache_hits = m.counter(
            "pool_cache_hits_total", "submits served by the disk cache")
        self._m_inflight_hits = m.counter(
            "pool_inflight_hits_total",
            "submits sharing an already-running identical dispatch")
        self._m_resolved = m.counter(
            "pool_resolved_total",
            "submits resolved by the caller's own memo")
        self._m_retried = m.counter(
            "pool_retried_total", "failed dispatches re-dispatched")
        self._m_abandoned = m.counter(
            "pool_abandoned_total", "tickets forgotten by preemption")
        self._m_completed = m.counter(
            "pool_completed_total", "tickets drained back to a caller")
        self._m_latency = m.histogram(
            "pool_latency_seconds", "ticket submit -> drain latency")
        g_out = m.gauge("pool_outstanding",
                        "tickets submitted and not yet drained")
        g_inf = m.gauge("pool_in_flight",
                        "distinct dispatches currently on workers")
        m.add_collector(lambda: (g_out.set(self.outstanding),
                                 g_inf.set(len(self._inflight))))
        self._t_sub: dict[int, float] = {}   # ticket -> submit monotonic
        self._src: dict[int, str] = {}       # ticket -> latency source label

    # ---------------------------------------------------------------- submit
    def _ev(self, name: str, **fields) -> None:
        if self.events is not None:
            self.events.instant(name, cat="pool", track="pool", **fields)

    def _new_ticket(self, row: int, src: str) -> int:
        t = self._next_ticket
        self._next_ticket += 1
        self._rows[t] = int(row)
        self._t_sub[t] = time.monotonic()
        self._src[t] = src
        return t

    def submit(self, row: int, idx_row: np.ndarray, *,
               workload: str | None = None, flow=None) -> int:
        """Dispatch one design point; returns its ticket.

        ``workload``/``flow`` default to the pool-wide ones; the fleet
        service passes them per call (one pool, many scenarios)."""
        wl = self.workload if workload is None else str(workload)
        fl = self.flow if flow is None else flow
        t = self._new_ticket(row, "worker")
        idx_row = np.asarray(idx_row)
        self._idx[t] = idx_row
        self._wl[t] = wl
        if self.cache is not None:
            y = self.cache.get(wl, idx_row)
            if y is not None:
                self.cache_hits += 1
                self._m_cache_hits.inc()
                self._src[t] = "cache"
                self._ready[t] = np.asarray(y)
                self._ev("pool.submit", ticket=t, row=int(row),
                         workload=wl, src="cache")
                return t
        key = FlowDiskCache.key(wl, idx_row)
        fut = self._inflight.get(key)
        if fut is not None and fut.done() and fut.exception() is not None:
            fut = None  # a FAILED evaluation must not poison the key:
            # the resubmission gets a fresh dispatch (the failed future
            # stays owned by the tickets that already hold it).
        if fut is None:
            self.dispatched += 1
            self._m_dispatched.inc()
            fut = self._ex.submit(_flow_task, fl, idx_row)
            self._inflight[key] = fut
        else:
            self.inflight_hits += 1
            self._m_inflight_hits.inc()
            self._src[t] = "shared"
        self._futs[t] = fut
        self._flowref[t] = fl
        self._ev("pool.submit", ticket=t, row=int(row), workload=wl,
                 src=self._src[t])
        return t

    def submit_resolved(self, row: int, y: np.ndarray) -> int:
        """Enqueue an already-known result under a fresh ticket — the
        caller's own memo (e.g. the fleet's in-memory evaluation cache)
        resolved this design point, but drains must still see it in ticket
        order."""
        t = self._new_ticket(row, "resolved")
        self._ready[t] = np.asarray(y)
        self._m_resolved.inc()
        self._ev("pool.submit", ticket=t, row=int(row), src="resolved")
        return t

    @property
    def outstanding(self) -> int:
        return len(self._rows)

    # ----------------------------------------------------------------- drain
    def _wait(self, t: int, timeout: float | None = None) -> None:
        """Block until ticket ``t``'s dispatch succeeds, re-dispatching a
        failed evaluation up to ``self.retries`` times. Each retry replaces
        the in-flight dedup entry and repoints EVERY ticket riding the
        failed future, so sharers retry once collectively and a later
        identical submit is never poisoned by the stale failure. Exhausted
        budget re-raises the last failure to the caller."""
        while True:
            fut = self._futs[t]
            try:
                fut.result(timeout)
                return
            except cf.TimeoutError:
                raise
            except Exception as exc:
                key = FlowDiskCache.key(self._wl[t], self._idx[t])
                cur = self._inflight.get(key)
                if cur is not None and cur is not fut:
                    new = cur  # another waiter already re-dispatched
                elif self._retry_counts.get(key, 0) >= self.retries:
                    raise exc
                else:
                    self._retry_counts[key] = \
                        self._retry_counts.get(key, 0) + 1
                    self.retried += 1
                    self.dispatched += 1
                    self._m_retried.inc()
                    self._m_dispatched.inc()
                    self._ev("pool.retry", ticket=t,
                             workload=self._wl.get(t),
                             attempt=self._retry_counts[key])
                    new = self._ex.submit(_flow_task, self._flowref[t],
                                          self._idx[t])
                    self._inflight[key] = new
                for t2, f2 in list(self._futs.items()):
                    if f2 is fut:
                        self._futs[t2] = new

    def _complete(self, t: int) -> None:
        fut = self._futs.pop(t)
        y = np.asarray(fut.result())
        wl = self._wl.get(t, self.workload)
        key = FlowDiskCache.key(wl, self._idx[t])
        if self._inflight.get(key) is fut:
            # First ticket to consume this dispatch retires the in-flight
            # entry (a later identical submit goes through the disk cache
            # or re-dispatches — the dict stays bounded by what is actually
            # running) and owns the single disk write-back; tickets sharing
            # the future skip both.
            del self._inflight[key]
            self._retry_counts.pop(key, None)
            if self.cache is not None:
                self.cache.put(wl, self._idx[t], y)
        self._ready[t] = y

    def _pop(self, t: int) -> tuple[int, int, np.ndarray]:
        self._idx.pop(t, None)
        self._wl.pop(t, None)
        self._flowref.pop(t, None)
        t_sub = self._t_sub.pop(t, None)
        src = self._src.pop(t, "worker")
        if t_sub is not None:
            self._m_latency.observe(time.monotonic() - t_sub, source=src)
        self._m_completed.inc()
        self._ev("pool.complete", ticket=t, src=src)
        return t, self._rows.pop(t), self._ready.pop(t)

    def abandon(self, tickets) -> int:
        """Forget the listed tickets without observing their results.

        Preempting a job must neither block on nor discard work already on
        a worker: an abandoned ticket's dispatch keeps running, and when it
        lands its result is still retired from the in-flight table and
        written back to the disk cache by a done-callback (failures are
        dropped — nobody is left to observe them), so a later resume turns
        the re-dispatch into a cache hit. Unknown or already-drained
        tickets are skipped (fail paths race with partially collected
        drains). Returns the number of tickets actually abandoned."""
        n = 0
        for t in tickets:
            t = int(t)
            if t not in self._rows:
                continue
            n += 1
            self._rows.pop(t)
            self._ready.pop(t, None)
            self._t_sub.pop(t, None)
            self._src.pop(t, None)
            self._ev("pool.abandon", ticket=t)
            idx = self._idx.pop(t, None)
            wl = self._wl.pop(t, None)
            self._flowref.pop(t, None)
            fut = self._futs.pop(t, None)
            if fut is None or idx is None:
                continue
            if any(f is fut for f in self._futs.values()):
                continue  # another live ticket still owns this dispatch
            key = FlowDiskCache.key(wl, idx)
            if self._inflight.get(key) is fut:
                def _retire(f, key=key, fut=fut, wl=wl, idx=idx):
                    if self._inflight.get(key) is fut:
                        del self._inflight[key]
                        if f.exception() is None and self.cache is not None:
                            self.cache.put(wl, idx, np.asarray(f.result()))
                fut.add_done_callback(_retire)
        self.abandoned += n
        if n:
            self._m_abandoned.inc(n)
        return n

    def collect(self, tickets) -> list[tuple[int, int, np.ndarray]]:
        """Block until every listed ticket has completed and release exactly
        those, in the given order, as ``(ticket, row, y)`` triples.

        The fleet service's per-scenario drains use this: each scenario
        collects its own ``min_done`` OLDEST tickets, so every scenario's
        feed-back order and batch size are pure functions of the driver's
        state — one shared worker pool, per-scenario deterministic
        trajectories."""
        out = []
        for t in tickets:
            t = int(t)
            if t not in self._rows:
                raise KeyError(f"collect: unknown or already-drained "
                               f"ticket {t}")
            if t not in self._ready:
                self._wait(t)
                self._complete(t)
            out.append(self._pop(t))
        return out

    def drain(self, min_done: int = 1, ordered: bool = True,
              timeout: float | None = None) -> list[tuple[int, int, np.ndarray]]:
        """Collect completions as ``(ticket, row, y)`` triples.

        ``ordered=True`` blocks until the ``min_done`` (clamped to the
        outstanding count) OLDEST tickets have completed and releases
        exactly those, in ticket order — never more: the batch size is a
        pure function of the caller's state, not of worker timing, which is
        what keeps the driver's PRNG consumption (and therefore the whole
        trajectory and its checkpoints) reproducible. ``ordered=False``
        blocks until ``min_done`` completions exist and additionally sweeps
        everything already finished (lowest latency, timing-dependent).
        """
        min_done = min(min_done, self.outstanding)
        out: list[tuple[int, int, np.ndarray]] = []
        if ordered:
            while self._rows and len(out) < min_done:
                t = min(self._rows)
                if t not in self._ready:
                    self._wait(t, timeout)  # block on the oldest
                    self._complete(t)
                out.append(self._pop(t))
            return out
        while self._rows:
            ready = sorted(self._ready)
            for t in ready:
                out.append(self._pop(t))
            if len(out) >= min_done or not self._futs:
                break
            done, _ = cf.wait(list(self._futs.values()), timeout=timeout,
                              return_when=cf.FIRST_COMPLETED)
            for t in [t for t, f in self._futs.items() if f in done]:
                if self._futs[t].exception() is not None:
                    self._wait(t)  # retry in place; raises when exhausted
                self._complete(t)
        return out

    def close(self) -> None:
        if self._owned:
            self._ex.shutdown(wait=True)

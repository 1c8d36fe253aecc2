"""Deterministic fault injection for the service test layer.

A copy of ``repro.service.faults``.

Real deployments lose workers mid-evaluation, hit flaky tool licenses and
see evaluations stall. The service's contract is that none of that may
change a job's *trajectory* — failures are retried (``FlowPool(retries=)``)
or surfaced as a FAILED job that resumes from its checkpoint, and a crashed
dispatch never poisons the in-flight dedup key. These wrappers make those
events reproducible on demand:

- :class:`FaultyFlow` wraps a flow callable and raises :class:`FlakyError`
  on the Nth call(s) (optionally sleeping per call): the flow-raised-an-
  error fault, injected *inside* the worker.
- :class:`FaultyExecutor` wraps an ``Executor`` and fails the Nth
  submission(s) outright — the task never runs, its future carries the
  injected exception: the worker-died-before-completing fault.

Both count deterministically from 0 in submission/call order, so a test
can target "the first BO-phase evaluation" exactly. ``FaultyFlow`` is
picklable (each process-pool worker gets its OWN counter — prefer thread
or inline executors when the global call index matters).
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Callable

__all__ = ["FlakyError", "FaultyFlow", "FaultyExecutor"]


class FlakyError(RuntimeError):
    """An injected, deterministic fault."""


class FaultyFlow:
    """Wrap ``flow``: raise :class:`FlakyError` on calls whose 0-based
    index is in ``fail_calls``; sleep ``delay_s`` before every call."""

    def __init__(self, flow: Callable, fail_calls=(), delay_s: float = 0.0):
        self.flow = flow
        self.fail_calls = frozenset(int(c) for c in fail_calls)
        self.delay_s = float(delay_s)
        self.calls = 0
        self._lock = threading.Lock()

    def __call__(self, idx):
        with self._lock:
            call = self.calls
            self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        if call in self.fail_calls:
            raise FlakyError(f"injected fault on flow call {call}")
        return self.flow(idx)

    def __getstate__(self):
        d = dict(self.__dict__)
        del d["_lock"]
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()


class FaultyExecutor:
    """Wrap ``inner``: submissions whose 0-based index is in
    ``fail_submissions`` never reach a worker — their future comes back
    already failed with :class:`FlakyError` (a worker killed before it
    could complete). Everything else passes through."""

    def __init__(self, inner, fail_submissions=()):
        self.inner = inner
        self.fail_submissions = frozenset(int(s) for s in fail_submissions)
        self.submissions = 0
        self._lock = threading.Lock()

    def submit(self, fn: Callable, *args, **kwargs) -> cf.Future:
        with self._lock:
            i = self.submissions
            self.submissions += 1
        if i in self.fail_submissions:
            fut: cf.Future = cf.Future()
            fut.set_exception(
                FlakyError(f"injected worker death on submission {i}"))
            return fut
        return self.inner.submit(fn, *args, **kwargs)

    def shutdown(self, wait: bool = True, **kwargs) -> None:
        self.inner.shutdown(wait=wait, **kwargs)

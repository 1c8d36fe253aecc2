"""Exploration service — restartable, concurrent SoC exploration; a port of
``repro.service``.

- ``runner``       :func:`service_tuner`: async q-batch BO over a worker
                   pool (fantasy ``select_q``, completions fed back as they
                   land, a checkpoint every completion batch).
- ``fleet_runner`` :func:`fleet_service`: the multi-scenario twin over ONE
                   shared pool, per-scenario ticket-ordered drains.
- ``pool``         :class:`FlowPool`: concurrent flow evaluation (spawn
                   processes, threads, inline or any Executor), in-flight
                   and on-disk dedup, retries, ordered draining.
- ``flowcache``    :class:`FlowDiskCache` / :class:`CachedFlow`: the
                   content-addressed on-disk flow cache, in the reference's
                   format (one directory serves both packages).
- ``server``       :class:`TunerServer`, :func:`serve`, :func:`request`:
                   the multi-tenant job scheduler and its JSON-lines TCP
                   wire API.
- ``jobs``         :class:`JobSpec` / :class:`Job`: the wire spec and the
                   preemptible per-job state machine.
- ``faults``       deterministic fault injection.
- ``checkpoint``   versioned atomic snapshots, the reference's npz format.
- ``cli``          the ``soc-service-torch`` console driver.

The drivers (``runner``, ``fleet_runner``, ``jobs``, ``server``) load on
first use: ``repro_torch.core`` imports ``checkpoint`` from this package,
and the drivers import ``repro_torch.core``.
"""
import importlib

from . import checkpoint
from .checkpoint import (SNAPSHOT_VERSION, latest_snapshot, load_snapshot,
                         save_snapshot, snapshot_path)
from .faults import FaultyExecutor, FaultyFlow, FlakyError
from .flowcache import CachedFlow, FlowDiskCache
from .pool import FlowPool, InlineExecutor

_LAZY = {"service_tuner": ".runner", "fleet_service": ".fleet_runner",
         "Job": ".jobs", "JobSpec": ".jobs", "TunerServer": ".server",
         "serve": ".server", "request": ".server"}

__all__ = [
    "checkpoint",
    "SNAPSHOT_VERSION", "save_snapshot", "load_snapshot", "latest_snapshot",
    "snapshot_path",
    "FlowDiskCache", "CachedFlow",
    "FlowPool", "InlineExecutor",
    "service_tuner", "fleet_service",
    "TunerServer", "serve", "request", "Job", "JobSpec",
    "FaultyFlow", "FaultyExecutor", "FlakyError",
]


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

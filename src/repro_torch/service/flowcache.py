"""Content-addressed on-disk flow-evaluation cache.

A copy of ``repro.service.flowcache`` with the same key and layout, so
one cache directory serves both packages.

The VLSI flow is deterministic in the design point, so its results are
cacheable forever. Entries are keyed by the sha1 of
``workload || canonical(int64 design-index vector)`` — the *content* of the
design point, not its row number in some pool — so the cache is shared
across fleet scenarios, across service workers, across runs and across
pools of different sizes/orderings.

Layout: ``<root>/<k[:2]>/<k>.npy`` (two-hex-char fan-out keeps directories
small at millions of entries). Writes go to a same-directory temp file and
``os.replace`` into place: concurrent writers on POSIX either both write the
identical immutable content or one wins — readers never observe a torn file.

:class:`CachedFlow` wraps any ``idx [k, d] -> y [k, m]`` flow callable with
a read-through/write-through view of the cache — drop-in for ``soc_tuner``'s
``flow`` argument; misses are evaluated in ONE inner flow call per batch.
"""
from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

__all__ = ["FlowDiskCache", "CachedFlow"]


class FlowDiskCache:
    """Process-safe on-disk memo of ``(workload, design point) -> y [m]``."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.gc_removed = 0        # cumulative across gc() calls
        self.gc_removed_bytes = 0

    @staticmethod
    def key(workload: str, idx_row) -> str:
        """Content hash of one design point under one workload."""
        h = hashlib.sha1()
        h.update(str(workload).encode())
        h.update(b"\0")
        h.update(np.ascontiguousarray(
            np.asarray(idx_row, np.int64).reshape(-1)).tobytes())
        return h.hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key + ".npy")

    # ------------------------------------------------------------------ io
    def get(self, workload: str, idx_row) -> np.ndarray | None:
        path = self._path(self.key(workload, idx_row))
        try:
            y = np.load(path, allow_pickle=False)
        except (FileNotFoundError, ValueError, OSError):
            self.misses += 1
            return None
        self.hits += 1
        try:
            # A hit refreshes the entry's mtime so :meth:`gc`'s
            # LRU-by-mtime order reflects *use*, not just write time.
            os.utime(path, None)
        except OSError:  # concurrent gc / read-only mount: recency is advisory
            pass
        return y

    def put(self, workload: str, idx_row, y) -> None:
        path = self._path(self.key(workload, idx_row))
        d = os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".npy.tmp", dir=d)
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, np.asarray(y))
            os.replace(tmp, path)  # atomic: concurrent writers can't tear
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self.puts += 1

    def get_many(self, workload: str, idx: np.ndarray) -> list:
        """Per-row lookup of ``idx [k, d]`` -> list of ``y [m]`` or None."""
        return [self.get(workload, row) for row in np.atleast_2d(idx)]

    # ------------------------------------------------------------------- gc
    def entries(self) -> list[tuple[str, int, float]]:
        """All cache entries as ``(path, size_bytes, mtime)``, oldest first
        (mtime ascending — reads refresh mtime, so this is LRU order)."""
        out = []
        for sub in os.listdir(self.root):
            d = os.path.join(self.root, sub)
            if len(sub) != 2 or not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                if not name.endswith(".npy"):
                    continue  # temp files are never eviction candidates
                path = os.path.join(d, name)
                try:
                    st = os.stat(path)
                except OSError:  # raced with a concurrent gc
                    continue
                out.append((path, int(st.st_size), st.st_mtime))
        out.sort(key=lambda e: (e[2], e[0]))
        return out

    def gc(self, *, max_bytes: int | None = None,
           max_age_days: float | None = None, now: float | None = None,
           dry_run: bool = False) -> dict:
        """Evict least-recently-used entries (LRU by mtime; :meth:`get`
        refreshes mtime on hit).

        ``max_age_days`` drops every entry unused for longer than that;
        ``max_bytes`` then drops the least recently used of the survivors
        until the cache fits the budget. Entries are immutable and
        recomputable, so eviction is always safe — a future miss just
        re-pays the flow. ``dry_run=True`` reports what WOULD be evicted
        (same policy, same return shape) without deleting anything.
        Returns ``{"scanned", "removed", "removed_bytes", "kept",
        "kept_bytes"}``.
        """
        if max_bytes is None and max_age_days is None:
            raise ValueError("gc: pass max_bytes and/or max_age_days")
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(f"gc: max_bytes must be >= 0, got {max_bytes}")
        if max_age_days is not None and max_age_days < 0:
            raise ValueError(
                f"gc: max_age_days must be >= 0, got {max_age_days}")
        import time as _time

        now = _time.time() if now is None else float(now)
        entries = self.entries()
        kept_bytes = sum(sz for _, sz, _ in entries)
        removed = removed_bytes = 0
        for path, sz, mtime in entries:  # oldest first
            expired = (max_age_days is not None
                       and now - mtime > max_age_days * 86400.0)
            over = max_bytes is not None and kept_bytes > max_bytes
            if not (expired or over):
                break  # LRU order: every later entry is younger and kept
            if not dry_run:
                try:
                    os.unlink(path)
                except OSError:  # concurrent gc / reader won the race
                    continue
            removed += 1
            removed_bytes += sz
            kept_bytes -= sz
        if not dry_run:
            self.gc_removed += removed
            self.gc_removed_bytes += removed_bytes
        return {"scanned": len(entries), "removed": removed,
                "removed_bytes": removed_bytes,
                "kept": len(entries) - removed, "kept_bytes": kept_bytes}

    # ---------------------------------------------------------- accounting
    @property
    def requests(self) -> int:
        return self.hits + self.misses

    def counters(self) -> dict:
        """Plain-int counter snapshot (the ``status()`` wire shape)."""
        return {"hits": self.hits, "misses": self.misses,
                "puts": self.puts, "gc_removed": self.gc_removed,
                "gc_removed_bytes": self.gc_removed_bytes}

    def bind_metrics(self, registry, prefix: str = "flow_disk") -> None:
        """Mirror this cache's plain counters into ``registry`` gauges via
        a snapshot-time collector. The cache itself never holds a registry
        reference — it must stay picklable (it travels to process-pool
        workers inside :class:`CachedFlow`)."""
        gauges = {
            "hits": registry.gauge(
                f"{prefix}_hits", "disk-cache lookups served"),
            "misses": registry.gauge(
                f"{prefix}_misses", "disk-cache lookups missed"),
            "puts": registry.gauge(
                f"{prefix}_puts", "disk-cache entries written"),
            "gc_removed": registry.gauge(
                f"{prefix}_gc_removed", "entries evicted by gc"),
            "gc_removed_bytes": registry.gauge(
                f"{prefix}_gc_removed_bytes", "bytes evicted by gc"),
        }

        def collect(cache=self, gauges=gauges):
            for k, v in cache.counters().items():
                gauges[k].set(v)

        registry.add_collector(collect)

    def summary(self) -> str:
        hr = self.hits / max(self.requests, 1)
        return (f"disk cache [{self.root}]: {self.requests} requests, "
                f"{self.hits} hits ({100.0 * hr:.1f}%), {self.puts} puts")


class CachedFlow:
    """Read-through/write-through disk-cache wrapper for a flow callable.

    ``CachedFlow(flow, cache, workload)`` is itself a valid
    ``idx [k, d] -> y [k, m]`` flow: cached rows are served from disk, the
    misses of a batch are evaluated in one inner ``flow`` call, and fresh
    results are written back. Picklable whenever the inner flow is (the
    cache handle re-opens its root on unpickle), so it is pool-safe.
    """

    def __init__(self, flow, cache: FlowDiskCache | str, workload: str):
        self.flow = flow
        self.cache = cache if isinstance(cache, FlowDiskCache) \
            else FlowDiskCache(cache)
        self.workload = str(workload)
        self.flow_calls = 0  # inner dispatches actually paid

    def __call__(self, idx: np.ndarray) -> np.ndarray:
        idx = np.atleast_2d(np.asarray(idx))
        found = self.cache.get_many(self.workload, idx)
        miss = [i for i, y in enumerate(found) if y is None]
        if miss:
            self.flow_calls += 1
            y_miss = np.atleast_2d(np.asarray(self.flow(idx[miss])))
            for i, y in zip(miss, y_miss):
                self.cache.put(self.workload, idx[i], y)
                found[i] = y
        return np.stack(found)

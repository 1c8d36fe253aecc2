"""Host-side metrics: counters, gauges, histograms in one registry.

A copy of ``repro.obs.metrics`` (host-only): for the same operations a
snapshot and its Prometheus text are byte for byte the reference's.

Design constraints, in order:

1. **Zero perturbation.** Instruments are plain Python dicts of floats
   updated on the host — never device arrays, never anything visible to a
   device kernel — so enabling them cannot move a single bit of
   any trajectory.
2. **Thread safety.** The server's wire handler threads scrape
   (:meth:`MetricsRegistry.snapshot`) while the scheduler thread updates;
   every instrument takes a small lock around its value dict.
3. **One JSON-able shape.** ``snapshot()`` is the single source of truth:
   the wire ``metrics`` verb ships it verbatim, and
   :func:`render_prometheus` renders the same shape to Prometheus text
   exposition format (client- or server-side).

Labels are plain keyword strings (``counter.inc(1, stage="fit")``) encoded
canonically as ``"stage=fit"`` keys in the snapshot, so label sets survive
a JSON round-trip without a schema.

**Collectors** bridge components that keep their own plain counters (the
pool's ``dispatched``, the disk cache's ``hits``/``misses``): a collector
is a zero-argument callable run at snapshot time that copies live values
into gauges — the owning object never holds a registry reference, so
picklable objects (flows, caches) stay picklable.
"""
from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "render_prometheus", "DEFAULT_BUCKETS"]

#: default histogram bucket upper bounds (seconds — sized for flow
#: latencies: milliseconds for cache hits through hours for real flows).
DEFAULT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0,
                   600.0, 3600.0)


def _label_key(labels: dict) -> str:
    """Canonical snapshot key of one label set ('' for unlabeled)."""
    for k, v in labels.items():
        s = str(v)
        if any(c in s for c in ',=\n"') or "," in k or "=" in k:
            raise ValueError(f"label {k}={s!r} contains a reserved "
                             "character (, = \" or newline)")
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def parse_label_key(key: str) -> dict:
    """Inverse of the snapshot's canonical label encoding."""
    if not key:
        return {}
    return dict(part.split("=", 1) for part in key.split(","))


class _Instrument:
    """Shared name/help/lock plumbing of every metric kind."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = str(name)
        self.help = str(help)
        self._lock = threading.Lock()
        self._vals: dict = {}

    def _snapshot(self):
        with self._lock:
            return dict(self._vals)


class Counter(_Instrument):
    """Monotonically non-decreasing accumulator."""

    kind = "counter"

    def inc(self, v: float = 1.0, **labels) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: inc by negative {v}")
        k = _label_key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + float(v)

    def value(self, **labels) -> float:
        return self._vals.get(_label_key(labels), 0.0)


class Gauge(_Instrument):
    """Point-in-time level (queue depth, resident bytes, live jobs)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._vals[_label_key(labels)] = float(v)

    def inc(self, v: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + float(v)

    def dec(self, v: float = 1.0, **labels) -> None:
        self.inc(-v, **labels)

    def value(self, **labels) -> float:
        return self._vals.get(_label_key(labels), 0.0)


class Histogram(_Instrument):
    """Fixed-bucket distribution (Prometheus classic histogram shape).

    Stores per-bucket observation counts plus running sum/count; the
    snapshot keeps buckets NON-cumulative (easier to diff), and the
    Prometheus renderer cumulates into the ``le`` convention.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram {self.name}: need >= 1 bucket")
        self.buckets = tuple(bs)  # +Inf overflow bucket is implicit

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        k = _label_key(labels)
        i = 0
        while i < len(self.buckets) and v > self.buckets[i]:
            i += 1
        with self._lock:
            e = self._vals.get(k)
            if e is None:
                e = self._vals[k] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            e["counts"][i] += 1
            e["sum"] += v
            e["count"] += 1

    def _snapshot(self):
        with self._lock:
            return {k: {"counts": list(e["counts"]), "sum": e["sum"],
                        "count": e["count"]}
                    for k, e in self._vals.items()}


class MetricsRegistry:
    """One process-local namespace of instruments + snapshot collectors.

    ``counter``/``gauge``/``histogram`` are idempotent: asking for an
    existing name returns the existing instrument (so independent
    components can share one registry without coordination); asking for an
    existing name as a *different kind* raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}
        self._collectors: list = []

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help, **kw)
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{inst.kind}, not {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def add_collector(self, fn) -> None:
        """Register a zero-arg callable run at every snapshot (copies a
        component's plain counters into gauges of this registry)."""
        with self._lock:
            self._collectors.append(fn)

    # ------------------------------------------------------------ exposition
    def snapshot(self) -> dict:
        """One JSON-able dict of everything: runs collectors first, then
        reads every instrument under its lock. Safe to call from any
        thread (the wire handler scrapes a live scheduler)."""
        with self._lock:
            collectors = list(self._collectors)
            instruments = list(self._instruments.values())
        for fn in collectors:
            try:
                fn()
            except Exception:
                # A dead component (closed pool, torn-down engine) must
                # never take the scrape down with it.
                pass
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for inst in instruments:
            if inst.kind == "histogram":
                out["histograms"][inst.name] = {
                    "buckets": list(inst.buckets),
                    "series": inst._snapshot(), "help": inst.help}
            else:
                out[inst.kind + "s"][inst.name] = {
                    "series": inst._snapshot(), "help": inst.help}
        return out

    def to_prometheus(self) -> str:
        return render_prometheus(self.snapshot())


def _prom_labels(key: str) -> str:
    if not key:
        return ""
    labels = parse_label_key(key)
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _prom_merge(base: str, extra: str) -> str:
    """Merge an extra label into an already-rendered label block."""
    if not base:
        return "{" + extra + "}"
    return base[:-1] + "," + extra + "}"


def render_prometheus(snapshot: dict) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` dict to Prometheus text
    exposition format (version 0.0.4). Works on the client side of the
    wire too — the snapshot is the wire payload."""
    lines: list[str] = []
    for kind in ("counters", "gauges"):
        for name, rec in sorted(snapshot.get(kind, {}).items()):
            if rec.get("help"):
                lines.append(f"# HELP {name} {rec['help']}")
            lines.append(f"# TYPE {name} {kind[:-1]}")
            for key, v in sorted(rec["series"].items()):
                lines.append(f"{name}{_prom_labels(key)} {v!r}")
    for name, rec in sorted(snapshot.get("histograms", {}).items()):
        if rec.get("help"):
            lines.append(f"# HELP {name} {rec['help']}")
        lines.append(f"# TYPE {name} histogram")
        buckets = rec["buckets"]
        for key, e in sorted(rec["series"].items()):
            base = _prom_labels(key)
            cum = 0
            for le, n in zip(buckets, e["counts"]):
                cum += n
                le_lab = 'le="' + repr(le) + '"'
                lines.append(f"{name}_bucket{_prom_merge(base, le_lab)} "
                             f"{cum}")
            cum += e["counts"][len(buckets)]
            inf_lab = 'le="+Inf"'
            lines.append(f"{name}_bucket{_prom_merge(base, inf_lab)} {cum}")
            lines.append(f"{name}_sum{base} {e['sum']!r}")
            lines.append(f"{name}_count{base} {e['count']}")
    return "\n".join(lines) + ("\n" if lines else "")

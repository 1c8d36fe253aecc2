"""Render an event log into Chrome ``trace_event`` JSON and summaries.

A copy of ``repro.obs.trace``; it renders either package's event logs.

:func:`build_chrome_trace` converts the records of one
:class:`repro_torch.obs.events.EventLog` file into the Trace Event Format that
``chrome://tracing`` and Perfetto load directly:

- span ``B``/``E`` pairs become complete (``"ph": "X"``) events with
  explicit durations, matched per (generation, track, name) as a stack
  (so nested spans of the same name pair inside-out);
- ``I`` records become thread-scoped instants (``"ph": "i"``);
- ``pool.submit`` / ``pool.complete`` instants carrying a ``ticket`` field
  pair into async begin/end (``"ph": "b"/"e"``) events keyed by ticket, so
  every flow evaluation shows as its own bar from dispatch to drain;
- each run **generation** becomes its own ``pid`` group, its timestamps
  rebased to zero (monotonic clocks restart with the process, so raw
  cross-generation stamps don't compare) and the groups laid out
  back-to-back on the timeline with a visible gap.

All timestamps are microseconds, per the format. A span left open by a
crash is closed at its generation's last timestamp and tagged
``"unterminated": true`` in its args.
"""
from __future__ import annotations

from collections import defaultdict

from .events import read_events

__all__ = ["build_chrome_trace", "summarize_events"]

#: visual gap inserted between generations on the rebased timeline (µs).
GEN_GAP_US = 10_000.0


def _us(mono_s: float) -> float:
    return mono_s * 1e6


def _gen_offsets(records: list[dict]) -> dict[int, float]:
    """Per-generation additive offset mapping raw ``mono`` (seconds) to one
    back-to-back microsecond timeline."""
    span: dict[int, list[float]] = {}
    for r in records:
        lo_hi = span.setdefault(r["gen"], [r["mono"], r["mono"]])
        lo_hi[0] = min(lo_hi[0], r["mono"])
        lo_hi[1] = max(lo_hi[1], r["mono"])
    offsets: dict[int, float] = {}
    base = 0.0
    for g in sorted(span):
        lo, hi = span[g]
        offsets[g] = base - _us(lo)
        base += _us(hi - lo) + GEN_GAP_US
    return offsets


def _payload(rec: dict) -> dict:
    return {k: v for k, v in rec.items()
            if k not in ("gen", "kind", "mono", "name", "cat", "track")}


def build_chrome_trace(path_or_records) -> dict:
    """Build ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` from an
    event-log path or a pre-read record list."""
    records = (path_or_records if isinstance(path_or_records, list)
               else read_events(path_or_records))
    offsets = _gen_offsets(records)
    tids: dict[tuple[int, str], int] = {}
    events: list[dict] = []

    def tid_of(gen: int, track: str) -> int:
        k = (gen, track)
        t = tids.get(k)
        if t is None:
            t = tids[k] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": gen,
                           "tid": t, "args": {"name": track}})
        return t

    open_spans: dict[tuple[int, str, str], list[dict]] = defaultdict(list)
    gen_last: dict[int, float] = {}
    for rec in records:
        gen = rec["gen"]
        ts = _us(rec["mono"]) + offsets[gen]
        gen_last[gen] = max(gen_last.get(gen, ts), ts)
        track = rec.get("track") or "run"
        name, kind = rec["name"], rec["kind"]
        base = {"name": name, "cat": rec.get("cat", "event"),
                "pid": gen, "tid": tid_of(gen, track), "ts": ts}
        if kind == "M":
            events.append({**base, "ph": "i", "s": "p",
                           "args": _payload(rec)})
        elif kind == "B":
            open_spans[(gen, track, name)].append({**base,
                                                   "args": _payload(rec)})
        elif kind == "E":
            stack = open_spans.get((gen, track, name))
            if stack:
                b = stack.pop()
                events.append({**b, "ph": "X",
                               "dur": max(ts - b["ts"], 0.0),
                               "args": {**b["args"], **_payload(rec)}})
            # an E with no B (log opened mid-span) is dropped
        elif kind == "I" and name in ("pool.submit", "pool.complete") \
                and "ticket" in rec:
            ph = "b" if name == "pool.submit" else "e"
            events.append({
                "name": f"flow t{rec['ticket']}", "cat": "flow",
                "ph": ph, "id": int(rec["ticket"]), "scope": "flow",
                "pid": gen, "tid": tid_of(gen, track), "ts": ts,
                "args": _payload(rec)})
        else:
            events.append({**base, "ph": "i", "s": "t",
                           "args": _payload(rec)})
    for (gen, track, name), stack in open_spans.items():
        for b in stack:  # crash-interrupted spans: close at the gen's end
            events.append({**b, "ph": "X",
                           "dur": max(gen_last.get(gen, b["ts"])
                                      - b["ts"], 0.0),
                           "args": {**b["args"], "unterminated": True}})
    events.sort(key=lambda e: (e.get("ts", -1.0), e.get("ph") != "M"))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def summarize_events(path_or_records) -> dict:
    """Per-generation, per-track timeline summary of an event log.

    Returns ``{"generations": {gen: {"records", "wall", "duration_s",
    "run"}}, "tracks": {track: {"spans": {name: {"count",
    "total_s"}}, "instants": {name: count}}}}`` — the data behind
    ``tools/trace_report.py``'s text report.
    """
    records = (path_or_records if isinstance(path_or_records, list)
               else read_events(path_or_records))
    gens: dict = {}
    tracks: dict = {}
    open_spans: dict[tuple[int, str, str], list[float]] = defaultdict(list)
    for rec in records:
        g = gens.setdefault(rec["gen"], {
            "records": 0, "run": None, "wall": None,
            "mono_lo": rec["mono"], "mono_hi": rec["mono"]})
        g["records"] += 1
        g["mono_lo"] = min(g["mono_lo"], rec["mono"])
        g["mono_hi"] = max(g["mono_hi"], rec["mono"])
        if rec["kind"] == "M":
            g["run"] = rec.get("run") or g["run"]
            g["wall"] = rec.get("wall", g["wall"])
            continue
        track = rec.get("track") or "run"
        t = tracks.setdefault(track, {"spans": {}, "instants": {}})
        name = rec["name"]
        if rec["kind"] == "B":
            open_spans[(rec["gen"], track, name)].append(rec["mono"])
        elif rec["kind"] == "E":
            stack = open_spans.get((rec["gen"], track, name))
            sp = t["spans"].setdefault(name, {"count": 0, "total_s": 0.0})
            if stack:
                sp["count"] += 1
                sp["total_s"] += max(rec["mono"] - stack.pop(), 0.0)
        else:
            t["instants"][name] = t["instants"].get(name, 0) + 1
    return {
        "generations": {
            g: {"records": v["records"], "run": v["run"], "wall": v["wall"],
                "duration_s": v["mono_hi"] - v["mono_lo"]}
            for g, v in sorted(gens.items())},
        "tracks": tracks}

"""Structured append-only JSON-lines event log with crash-safe generations.

A copy of ``repro.obs.events``: the same JSON-lines records and
generation sidecar, so either package reads the other's logs.

One :class:`EventLog` is one append-only ``.jsonl`` file. Every record is a
single JSON object on its own line, written with ONE ``write()`` call on an
``O_APPEND`` stream and flushed immediately — concurrent writers (and a
SIGKILL mid-run) can truncate only the *last* line, never interleave or
corrupt earlier ones; readers simply skip a torn tail.

Record schema (all records)::

    {"gen": 0,            # run generation (increments on every reopen)
     "kind": "M|B|E|I",   # meta / span begin / span end / instant
     "mono": 12.345678,   # time.monotonic() — ordering within a generation
     "name": "cycle",     # event name ("M" records carry run metadata)
     ...}                 # free-form JSON-able payload fields

plus ``"track"`` (timeline row: a job id, "pool", "scheduler", a scenario
label) and ``"cat"`` (category) where meaningful. ``"M"`` (meta) records
additionally carry ``wall`` (epoch seconds), ``pid`` and ``run`` — the one
wall-clock anchor per generation, so monotonic stamps can be correlated
with the outside world without making event ordering vulnerable to clock
jumps.

**Generations.** Monotonic clocks restart with the process, so a resumed
run must not splice its timestamps into the previous run's. Each open of
an existing log starts a NEW generation: a sidecar ``<path>.gen`` file
(written atomically at open) carries the last generation number across
SIGKILL, the reopened log appends records tagged ``gen+1``, and consumers
(:mod:`repro_torch.obs.trace`) treat generations as disjoint time segments.
Within a generation, ``mono`` never decreases and counters never regress;
across generations only ``gen`` orders — exactly the contract the
SIGKILL-resume tests pin.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

__all__ = ["EventLog", "read_events"]


def _jsonable(x):
    """json.dumps default hook: squash numpy scalars to Python numbers."""
    if hasattr(x, "item"):
        return x.item()
    return str(x)


class EventLog:
    """Append-only JSON-lines event writer (see module docstring).

    ``EventLog(path)`` opens (creates) the log and starts a fresh
    generation; ``run`` names the producing driver in the generation's
    meta record. Emission methods are thread-safe and never raise into
    the caller's control flow on payload problems — telemetry must not be
    able to fail a run.
    """

    def __init__(self, path: str, *, run: str = "",
                 generation: int | None = None):
        self.path = str(path)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        if generation is None:
            generation = self._next_generation()
        self.generation = int(generation)
        self._write_gen_sidecar(self.generation)
        # O_APPEND: the kernel serializes each write() at the file end, so
        # one record = one write = one atomic line.
        self._fd = os.open(self.path,
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self._closed = False
        self.emitted = 0
        self._emit("M", "generation", run=str(run), pid=os.getpid(),
                   wall=time.time())

    # ------------------------------------------------------------ generation
    def _gen_path(self) -> str:
        return self.path + ".gen"

    def _next_generation(self) -> int:
        """Last recorded generation + 1 (0 for a fresh log). The sidecar —
        not the log tail — carries this across SIGKILL: reading it is O(1)
        and immune to a torn final line."""
        try:
            with open(self._gen_path()) as f:
                return int(f.read().strip()) + 1
        except (FileNotFoundError, ValueError):
            return 0

    def _write_gen_sidecar(self, gen: int) -> None:
        tmp = self._gen_path() + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(int(gen)))
        os.replace(tmp, self._gen_path())

    # -------------------------------------------------------------- emission
    def _emit(self, kind: str, name: str, **fields) -> None:
        rec = {"gen": self.generation, "kind": kind,
               "mono": time.monotonic(), "name": str(name)}
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        line = json.dumps(rec, separators=(",", ":"),
                          default=_jsonable) + "\n"
        with self._lock:
            if self._closed:
                return
            os.write(self._fd, line.encode())
            self.emitted += 1

    def instant(self, name: str, *, cat: str | None = None,
                track: str | None = None, **fields) -> None:
        """One point-in-time event."""
        self._emit("I", name, cat=cat, track=track, **fields)

    def begin(self, name: str, *, cat: str | None = None,
              track: str | None = None, **fields) -> None:
        self._emit("B", name, cat=cat, track=track, **fields)

    def end(self, name: str, *, cat: str | None = None,
            track: str | None = None, **fields) -> None:
        self._emit("E", name, cat=cat, track=track, **fields)

    @contextmanager
    def span(self, name: str, *, cat: str | None = None,
             track: str | None = None, **fields):
        """``with log.span("cycle", track="scheduler"): ...`` — emits the
        begin record on entry and the end record on exit (also on an
        exception, tagged ``error=True``)."""
        self.begin(name, cat=cat, track=track, **fields)
        try:
            yield self
        except BaseException:
            self.end(name, cat=cat, track=track, error=True)
            raise
        self.end(name, cat=cat, track=track)

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                os.close(self._fd)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str) -> list[dict]:
    """Parse an event log back into record dicts, in file order.

    A torn final line (SIGKILL mid-write on a non-O_APPEND filesystem) is
    skipped; a torn line anywhere else raises — that would mean real
    corruption, not a crash artifact."""
    out: list[dict] = []
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # torn tail from a crash — expected, drop it
            raise
    return out

"""The port's telemetry (``repro_torch.obs``) against the live reference
(``repro.obs``) on the CPU.

The same operations on both registries give the same snapshot and byte for
byte the same Prometheus text; an event log either package writes is read
and rendered (Chrome trace, summary) by the other, generations included;
``log_progress`` builds the same record and event.
"""
import json

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import numpy as np

from repro import obs as obs_j
from repro_torch import obs

KINDS = ("counters", "gauges", "histograms")


def _record_ops(reg) -> None:
    """One fixed sequence of operations on a registry of either package."""
    c = reg.counter("pool_dispatched_total", "flow evaluations sent")
    c.inc()
    c.inc(2.5, stage="fit")
    c.inc(1, stage="acq", job="j0001")
    g = reg.gauge("server_jobs", "jobs by state")
    g.set(3, state="RUNNING")
    g.inc(2, state="DONE")
    g.dec(0.5, state="DONE")
    g.set(-1.25)
    h = reg.histogram("pool_latency_seconds", "submit -> drain")
    for v in (0.0005, 0.003, 0.003, 1.7, 42.0, 5000.0):
        h.observe(v, source="worker")
    h.observe(0.02, source="cache")
    h2 = reg.histogram("cycle_seconds", buckets=(0.5, 0.1, 2.0))
    h2.observe(0.1)
    h2.observe(3.0)
    reg.counter("bare_total").inc(0)
    box = {"n": 0}
    live = reg.gauge("collected", "copied at snapshot time")
    reg.add_collector(lambda: live.set(box.__setitem__("n", box["n"] + 1)
                                       or box["n"]))
    reg.add_collector(lambda: 1 / 0)  # a dead component never breaks a scrape


def test_snapshot_and_prometheus_text_equal_the_reference():
    reg, reg_j = obs.MetricsRegistry(), obs_j.MetricsRegistry()
    _record_ops(reg)
    _record_ops(reg_j)
    for _ in range(2):  # collectors run again at every snapshot
        snap, snap_j = reg.snapshot(), reg_j.snapshot()
        assert json.dumps(snap, sort_keys=True) == \
            json.dumps(snap_j, sort_keys=True)
        assert obs.render_prometheus(snap) == obs_j.render_prometheus(snap_j)
        assert reg.to_prometheus() == reg_j.to_prometheus()
    # each package renders the other's snapshot (the wire payload) the same
    assert obs.render_prometheus(snap_j) == obs_j.render_prometheus(snap)
    assert obs.render_prometheus({}) == obs_j.render_prometheus({}) == ""
    assert obs.metrics.parse_label_key("a=1,b=x") == \
        obs_j.metrics.parse_label_key("a=1,b=x") == {"a": "1", "b": "x"}


@pytest.mark.parametrize("op", ["negative_inc", "reserved_label",
                                "kind_mismatch", "no_buckets"])
def test_registry_errors_equal_the_reference(op):
    msgs = []
    for pkg in (obs, obs_j):
        reg = pkg.MetricsRegistry()
        with pytest.raises(ValueError) as exc:
            if op == "negative_inc":
                reg.counter("c").inc(-1)
            elif op == "reserved_label":
                reg.counter("c").inc(1, job="a,b")
            elif op == "kind_mismatch":
                reg.counter("m")
                reg.gauge("m")
            else:
                reg.histogram("h", buckets=())
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def _write_log(pkg, path, run: str) -> None:
    """Spans, instants and pool tickets; a span left open (a crash)."""
    with pkg.EventLog(path, run=run) as ev:
        with ev.span("cycle", cat="scheduler", track="scheduler", cycle=0):
            ev.instant("pool.submit", cat="pool", track="pool", ticket=0,
                       row=5, src="worker")
            ev.instant("round", cat="progress", track="resnet50", round=1,
                       adrs=np.float32(0.25), evaluations=np.int64(31))
            ev.instant("pool.complete", cat="pool", track="pool", ticket=0)
        ev.begin("job.step", cat="job", track="j0000", cycle=1)


def test_event_logs_cross_read_and_render(tmp_path):
    """A log the port starts and the reference continues (and the other
    way round) holds two generations; each package reads it, and both
    packages' Chrome traces and summaries of it are equal."""
    for first, second in ((obs, obs_j), (obs_j, obs)):
        path = str(tmp_path / f"{first.__name__}.jsonl")
        _write_log(first, path, "first")
        _write_log(second, path, "second")
        recs, recs_j = obs.read_events(path), obs_j.read_events(path)
        assert recs == recs_j
        assert sorted({r["gen"] for r in recs}) == [0, 1]
        assert [r["run"] for r in recs if r["kind"] == "M"] == \
            ["first", "second"]
        assert all(r["gen"] == 1 for r in recs[len(recs) // 2:])
        trace = obs.build_chrome_trace(path)
        assert trace == obs_j.build_chrome_trace(path)
        assert trace == obs.build_chrome_trace(recs_j)
        phases = {e["ph"] for e in trace["traceEvents"]}
        assert {"X", "b", "e", "i", "M"} <= phases
        assert sum(e["args"].get("unterminated", False)
                   for e in trace["traceEvents"] if e["ph"] == "X") == 2
        assert obs.summarize_events(path) == obs_j.summarize_events(path)
        with open(path + ".gen") as f:
            assert f.read() == "1"


def test_torn_tail_is_dropped_and_torn_middle_raises(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    _write_log(obs, path, "r")
    with open(path, "a") as f:
        f.write('{"gen": 0, "kind": "I", "mo')
    assert obs.read_events(path) == obs_j.read_events(path)
    with open(path, "a") as f:
        f.write('\n{"gen": 0}\n')
    for pkg in (obs, obs_j):
        with pytest.raises(json.JSONDecodeError):
            pkg.read_events(path)


def test_log_progress_record_line_and_event_equal_the_reference(
        tmp_path, capsys):
    rng = np.random.default_rng(0)
    y = rng.random((12, 3)).astype(np.float32)
    ref = y[[1, 4]] * 0.5
    out = {}
    for name, pkg, kw in (("port", obs, {"device": "cpu"}),
                          ("ref", obs_j, {})):
        hist = []
        path = str(tmp_path / f"{name}.jsonl")
        with pkg.EventLog(path, run="t") as ev:
            rec = pkg.log_progress(hist, y, 12, 7, ref, verbose=True,
                                   tag="service", word="eval", wall_s=0.5,
                                   events=ev, track="resnet50", extra=3,
                                   **kw)
            pkg.log_progress(hist, y, 12, 8, None, verbose=True,
                             tag="fleet-svc", label="resnet50:s0",
                             events=ev, **kw)
        line = capsys.readouterr().out
        evs = [{k: v for k, v in r.items() if k != "mono"}
               for r in pkg.read_events(path) if r["kind"] == "I"]
        out[name] = (hist, line, evs)
        assert hist[0] is rec
    (h, line, evs), (h_j, line_j, evs_j) = out["port"], out["ref"]
    assert line == line_j
    assert [r.keys() for r in h] == [r.keys() for r in h_j]
    # ADRS: float64 distances on both sides
    assert h[0]["adrs"] == pytest.approx(h_j[0]["adrs"], rel=1e-6)
    assert [{k: v for k, v in r.items() if k != "adrs"} for r in h] == \
        [{k: v for k, v in r.items() if k != "adrs"} for r in h_j]
    assert [{k: v for k, v in e.items() if k != "adrs"} for e in evs] == \
        [{k: v for k, v in e.items() if k != "adrs"} for e in evs_j]

"""The port's multi-tenant server (``repro_torch.service``: ``JobSpec``,
``Job``, ``TunerServer``, ``serve``, ``request``) against the live
reference on the CPU.

The mix is the ``server_two_jobs`` golden case (``tools/regen_golden.py``:
resnet50 seed 0 with q 2 and min_done 1, transformer seed 1 with q 1, T 6,
over a 64-row JAX-drawn pool). Fed the reference's key schedule
(``JaxKeyDraws`` a job), each multiplexed job picks what the reference's
server picks, and is bit for bit the same job run alone through
``fleet_service``. Preemption, a crash (the server object abandoned) and a
flow fault all resume to the uninterrupted trajectory. The wire API answers
``status`` and ``metrics`` mid-run. The scheduler's invariants are
property-tested on stub jobs, with ``pytest.MonkeyPatch.context()`` inside
the test and no function-scoped fixture.
"""
import importlib.util
import json
import os
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro import obs as obs_j
from repro.core import make_space as make_space_j
from repro.core.pareto import pareto_mask
from repro.service import JobSpec as JobSpecJ
from repro.service import TunerServer as TunerServerJ
from repro.soc import VLSIFlow as VLSIFlowJ
from repro_torch import obs
from repro_torch.core import make_space
from repro_torch.service import (FaultyFlow, JobSpec, TunerServer,
                                 fleet_service, request, serve)
from repro_torch.service import server as server_mod
from repro_torch.soc import DelayedFlow, VLSIFlow

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_propose import JaxKeyDraws  # noqa: E402

_TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools",
                      "regen_golden.py")
_spec = importlib.util.spec_from_file_location("regen_golden", _TOOLS)
regen_golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(regen_golden)

CASE = regen_golden.CASES["server_two_jobs"]
SPECS = [dict(workload=wl, seed=s, **extra, **regen_golden.RUN_KW)
         for wl, s, extra in CASE["jobs"]]
SETTLED = ("DONE", "FAILED", "CANCELLED")


def _jax_draws(spec):
    return JaxKeyDraws(jax.random.PRNGKey(spec.seed))


@pytest.fixture(scope="module")
def golden():
    """The golden pool (JAX-drawn) and each workload's reference front."""
    space = make_space_j()
    pool = np.asarray(space.sample(
        jax.random.PRNGKey(regen_golden.POOL_SEED), regen_golden.N_POOL))
    fronts = {}
    for spec in SPECS:
        y = np.asarray(VLSIFlowJ(space, spec["workload"])(pool))
        fronts[spec["workload"]] = y[np.asarray(pareto_mask(
            jnp.asarray(y.astype(np.float64))))]
    return pool, fronts


@pytest.fixture(scope="module")
def jax_server(golden):
    """The reference's server over the mix (inline executor)."""
    pool, fronts = golden
    with TunerServerJ(make_space_j(), pool, executor="inline") as srv:
        jids = [srv.submit(JobSpecJ(**kw),
                           reference_front=fronts[kw["workload"]])
                for kw in SPECS]
        srv.run_until_idle()
        return [srv.job(j).result() for j in jids]


@pytest.fixture(scope="module")
def alone(golden):
    """Each job of the mix alone through the port's fleet_service."""
    pool, fronts = golden
    out = []
    for kw in SPECS:
        spec = JobSpec(**kw)
        knobs = {k: v for k, v in kw.items() if k not in ("workload", "seed")}
        out.append(fleet_service(
            make_space(), pool, [spec.scenario], executor="inline",
            reference_fronts=fronts, draws=[_jax_draws(spec)],
            device="cpu", **knobs).results[0])
    return out


def _server(pool, **kw):
    return TunerServer(make_space(), pool, device="cpu",
                       draws_factory=_jax_draws, **kw)


def _strip(history, drop=("wall_s",)):
    return [{k: v for k, v in h.items() if k not in drop} for h in history]


def _same(a, b, drop=("wall_s",)):
    np.testing.assert_array_equal(a.evaluated_rows, b.evaluated_rows)
    np.testing.assert_array_equal(a.y, b.y)
    assert _strip(a.history, drop) == _strip(b.history, drop)


def _submit_mix(srv, fronts):
    return [srv.submit(JobSpec(**kw), reference_front=fronts[kw["workload"]])
            for kw in SPECS]


@pytest.mark.parametrize("executor", ["inline", "thread"])
def test_two_jobs_equal_each_job_alone_and_the_reference(
        golden, jax_server, alone, executor, tmp_path):
    pool, fronts = golden
    reg = obs.MetricsRegistry()
    with _server(pool, executor=executor, cache_dir=str(tmp_path),
                 metrics=reg) as srv:
        jids = _submit_mix(srv, fronts)
        srv.run_until_idle()
        for jid, want_alone, want_j in zip(jids, alone, jax_server):
            job = srv.job(jid)
            assert job.status == "DONE", job.error
            got = job.result()
            _same(got, want_alone)
            np.testing.assert_array_equal(got.evaluated_rows,
                                          want_j.evaluated_rows)
            # metrics from two float32 SoC models
            np.testing.assert_allclose(got.y, want_j.y, rtol=1e-5)
            assert got.history[-1]["adrs"] == pytest.approx(
                want_j.history[-1]["adrs"], rel=1e-5)
            keys = ("rounds", "refactors", "block_updates", "fantasy_steps")
            assert {k: got.engine_stats[k] for k in keys} == \
                {k: want_j.engine_stats[k] for k in keys}
        status = srv.status()
    assert status["total_done"] == sum(kw["T"] for kw in SPECS)
    snap = reg.snapshot()
    assert snap["gauges"]["engine_device_bytes"]["series"][""] == 0.0
    assert snap["counters"]["job_transitions_total"]["series"][
        "from=RUNNING,to=DONE"] == 2.0


def test_pause_resume_and_a_crash_resume_bit_for_bit(golden, alone,
                                                     tmp_path):
    pool, fronts = golden
    with _server(pool, executor="inline") as srv:
        jids = _submit_mix(srv, fronts)
        srv.run_cycle()
        srv.run_cycle()
        job = srv.job(jids[0])
        assert job.status == "RUNNING" and job.info()["engine_bytes"] > 0
        srv.pause(jids[0])
        assert job.info()["engine_bytes"] == 0  # eviction freed the engine
        srv.run_cycle()
        srv.resume_job(jids[0])
        srv.run_until_idle()
        for jid, want in zip(jids, alone):
            _same(srv.job(jid).result(), want)

    d = str(tmp_path / "srv")
    srv = _server(pool, executor="inline", checkpoint_dir=d)
    jids = _submit_mix(srv, fronts)
    for _ in range(3):
        srv.run_cycle()
    for job in srv.jobs.values():  # what serve() does on its way out
        if job.status == "RUNNING":
            job.checkpoint()
    srv._save_manifest()
    del srv  # never closed: the crash
    with _server(pool, executor="inline", checkpoint_dir=d,
                 resume=True) as srv2:
        assert all(j.status == "PENDING" for j in srv2.jobs.values())
        srv2.run_until_idle()
        for jid, want in zip(jids, alone):
            # the manifest keeps no reference front (as the reference's):
            # rounds after the restart carry no ADRS
            _same(srv2.job(jid).result(), want, drop=("wall_s", "adrs"))
            assert srv2.job(jid).result_dict()["evaluated_rows"] == \
                want.evaluated_rows.tolist()


def test_flow_fault_fails_its_job_only_and_resumes(golden, alone, tmp_path):
    pool, fronts = golden
    space = make_space()

    def factory(wl):
        flow = VLSIFlow(space, wl, device="cpu")
        return FaultyFlow(flow, fail_calls={3}) if wl == "resnet50" else flow

    with _server(pool, executor="thread", max_workers=1, retries=0,
                 flow_factory=factory, checkpoint_dir=str(tmp_path)) as srv:
        jr, jt = _submit_mix(srv, fronts)
        srv.run_until_idle()
        assert srv.job(jr).status == "FAILED"
        assert "FlakyError" in srv.job(jr).error
        assert srv.job(jt).status == "DONE"
        _same(srv.job(jt).result(), alone[1])
        srv.resume_job(jr)
        srv.run_until_idle()
        assert srv.job(jr).status == "DONE", srv.job(jr).error
        _same(srv.job(jr).result(), alone[0])


def test_proposer_job_pauses_and_equals_the_job_alone(golden):
    """A job with the proposer on edits its private pool; paused mid-run
    (the live pool goes into the eviction record) and resumed, it ends as
    the job alone: rows, metrics and live pool bit for bit."""
    pool, fronts = golden
    kw = dict(SPECS[0], proposer={"enabled": True, "every": 2})
    spec = JobSpec(**kw)
    knobs = {k: v for k, v in kw.items() if k not in ("workload", "seed")}
    want = fleet_service(make_space(), pool, [spec.scenario],
                         executor="inline", draws=[_jax_draws(spec)],
                         reference_fronts=fronts, device="cpu",
                         **knobs).results[0]
    with _server(pool, executor="inline") as srv:
        jid = srv.submit(spec, reference_front=fronts[spec.workload])
        for _ in range(3):
            srv.run_cycle()
        srv.pause(jid)
        srv.resume_job(jid)
        srv.run_until_idle()
        got = srv.job(jid).result()
    _same(got, want)
    np.testing.assert_array_equal(got.pool_live, want.pool_live)
    assert (got.pool_live != pool).any()
    assert got.engine_stats["proposer"]["replaced"] == \
        want.engine_stats["proposer"]["replaced"] > 0


def test_jobspec_wire_dict_equals_the_reference():
    for kw in [{}, SPECS[0], SPECS[1],
               dict(workload="mobilenet", weights=[2, 1, 0.5], priority=3,
                    pool_chunk="auto", bucket=16, fantasy="cl_min", q=3,
                    min_done=2, proposer={"enabled": True, "every": 2})]:
        spec, spec_j = JobSpec(**kw), JobSpecJ(**kw)
        wire = json.loads(json.dumps(spec.as_dict()))
        assert wire == json.loads(json.dumps(spec_j.as_dict()))
        assert JobSpec.from_dict(wire) == spec
        assert JobSpecJ.from_dict(wire) == spec_j
        assert json.dumps(spec.config()) == json.dumps(spec_j.config())
        assert spec.scenario.label == spec_j.scenario.label


@pytest.mark.parametrize("kw", [dict(T=0), dict(q=0),
                                dict(q=2, incremental=False),
                                dict(q=2, min_done=3), dict(fantasy="x"),
                                dict(weights=(1, 2)), dict(bogus=1),
                                dict(proposer=True, incremental=False)])
def test_jobspec_refusals_equal_the_reference(kw):
    msgs = []
    for cls in (JobSpec, JobSpecJ):
        with pytest.raises((ValueError, TypeError)) as exc:
            cls.from_dict(kw)
        msgs.append((type(exc.value), str(exc.value)))
    assert msgs[0] == msgs[1]


def test_wire_status_and_metrics_mid_run(golden):
    """Through ``request``: submit, status, a ``metrics`` scrape while the
    job runs (``engine_device_bytes`` > 0), shutdown. The scrape renders
    to the same Prometheus text in both packages."""
    pool, fronts = golden
    space = make_space()
    srv = _server(pool, executor="thread", max_workers=2,
                  flow_factory=lambda wl: DelayedFlow(
                      VLSIFlow(space, wl, device="cpu"), 0.25))
    got = {}
    ready = threading.Event()
    th = threading.Thread(target=serve, args=(srv,), daemon=True, kwargs=dict(
        ready_cb=lambda p: (got.update(port=p), ready.set())))
    th.start()
    try:
        assert ready.wait(30)
        port = got["port"]
        r = request(port, {"verb": "submit", "spec": SPECS[0]})
        assert r == {"ok": True, "job": "j0000"}
        deadline, scraped = time.time() + 120, None
        while time.time() < deadline:
            s = request(port, {"verb": "status", "job": "j0000"})["status"]
            if s["status"] == "RUNNING" and s["done"] >= 1:
                m = request(port, {"verb": "metrics"})
                assert m["ok"]
                scraped = m["metrics"]
                break
            time.sleep(0.05)
        assert scraped is not None
        assert scraped["gauges"]["engine_device_bytes"]["series"][""] > 0
        assert scraped["counters"]["pool_dispatched_total"]["series"][""] > 0
        assert obs.render_prometheus(scraped) == \
            obs_j.render_prometheus(scraped)
        assert not request(port, {"verb": "bogus"})["ok"]
        assert not request(port, {"verb": "submit", "spec": {"q": 0}})["ok"]
        assert request(port, {"verb": "shutdown"})["ok"]
        th.join(60)
        assert not th.is_alive()
        full = srv.status()
        assert full["jobs"]["j0000"]["status"] == "RUNNING"  # checkpointed
    finally:
        srv.close()


# ------------------------------------------------- scheduler properties
class _StubJob:
    """A Job of the scheduler's surface with a fake trajectory: one
    completion a step."""

    def __init__(self, job_id, spec, **_):
        self.id, self.spec = str(job_id), spec
        self.checkpoint_dir = None
        self.status, self.error = "PENDING", None
        self.submit_seq = self.admit_seq = None
        self.done = self.cycle = 0
        self._snap_mem = None

    label = property(lambda self: f"{self.id}:{self.spec.workload}")

    def _set_status(self, new):
        self.status = new

    def start(self, fpool, flow, *, resume=False):
        self.status = "RUNNING"

    def step(self, fpool):
        assert self.status == "RUNNING", f"stepped a {self.status} job"
        self.cycle += 1
        self.done = min(self.done + 1, self.spec.T)
        if self.done >= self.spec.T:
            self.status = "DONE"
        return 1

    def pause(self, fpool):
        self.status = "PAUSED"

    def cancel(self, fpool):
        self.status = "CANCELLED"

    def checkpoint(self):
        pass

    def info(self):
        return {"id": self.id, "status": self.status, "done": self.done}


def _stub_server(mp, max_active):
    mp.setattr(server_mod, "Job", _StubJob)
    return TunerServer(object(), np.zeros((4, 2)), executor="inline",
                       flow_factory=lambda wl: None, max_active=max_active,
                       device="cpu")


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # the property tests need the optional extra
    given = None

if given is not None:
    _JOBS = st.lists(st.tuples(st.integers(1, 5), st.integers(0, 3)),
                     min_size=1, max_size=5)
    _OPS = st.lists(st.tuples(st.sampled_from(["cycle", "pause", "resume",
                                               "cancel"]),
                              st.integers(0, 5)), min_size=1, max_size=40)

    @settings(max_examples=60, deadline=None)
    @given(jobs=_JOBS, ops=_OPS, max_active=st.integers(1, 4))
    def test_scheduler_invariants_under_arbitrary_interleavings(
            jobs, ops, max_active):
        with pytest.MonkeyPatch.context() as mp:
            srv = _stub_server(mp, max_active)
            jids = [srv.submit(JobSpec(workload="w", seed=i, T=t, priority=p))
                    for i, (t, p) in enumerate(jobs)]
            cancelled = set()
            for verb, pick in ops:
                sel = jids[pick % len(jids)]
                job = srv.job(sel)
                if verb == "pause" and job.status == "RUNNING":
                    srv.pause(sel)
                elif verb == "resume" and job.status == "PAUSED":
                    srv.resume_job(sel)
                elif verb == "cancel" and job.status not in SETTLED:
                    srv.cancel(sel)
                    cancelled.add(sel)
                elif verb == "cycle":
                    before = {j: (srv.job(j).status, srv.job(j).cycle)
                              for j in jids}
                    srv.run_cycle()
                    assert sum(srv.job(j).status == "RUNNING"
                               for j in jids) <= max_active
                    for j in jids:
                        status, cyc = before[j]
                        stepped = srv.job(j).cycle - cyc
                        if status == "RUNNING":
                            assert stepped == 1  # served exactly once
                        elif status == "PENDING":
                            assert stepped in (0, 1)
                        else:
                            assert stepped == 0  # never a settled one
                for j in jids:
                    assert srv.job(j).done <= srv.job(j).spec.T
            for j in jids:
                if srv.job(j).status == "PAUSED" and j not in cancelled:
                    srv.resume_job(j)
            srv.run_until_idle(max_cycles=200)
            for j in jids:
                job = srv.job(j)
                assert job.status == ("CANCELLED" if j in cancelled
                                      else "DONE")
                if j not in cancelled:
                    assert job.done == job.spec.T
            srv.close()

    @settings(max_examples=60, deadline=None)
    @given(jobs=_JOBS)
    def test_admission_respects_priority_then_submission_order(jobs):
        with pytest.MonkeyPatch.context() as mp:
            srv = _stub_server(mp, max_active=None)
            jids = [srv.submit(JobSpec(workload="w", seed=i, T=t, priority=p))
                    for i, (t, p) in enumerate(jobs)]
            srv.run_cycle()  # no cap: every job admits in one cycle
            order = sorted(jids, key=lambda j: srv.job(j).admit_seq)
            keys = [(-srv.job(j).spec.priority, srv.job(j).submit_seq)
                    for j in order]
            assert keys == sorted(keys)
            srv.close()

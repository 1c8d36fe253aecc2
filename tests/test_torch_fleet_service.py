"""The port's fleet service (``repro_torch.service.fleet_service``) and the
fleet's on-disk flow cache (``FlowEvalCache(disk=...)``,
``fleet_tuner(disk_cache=...)``) against the live reference on the CPU.

The fleet is the ``fleet_tuner_incremental`` golden configuration
(``tools/regen_golden.py``: resnet50 seed 0 and transformer seed 1 over a
64-row JAX-drawn pool, T 6); one ``JaxKeyDraws`` a scenario replays the
reference's per-scenario key schedule.
"""
import importlib.util
import os
import signal
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import numpy as np

from repro.core import FleetScenario as FleetScenarioJ
from repro.core import FlowEvalCache as FlowEvalCacheJ
from repro.core import make_space as make_space_j
from repro.service import fleet_service as fleet_service_j
from repro_torch.core import (FleetScenario, FlowEvalCache, fleet_tuner,
                              make_space)
from repro_torch.service import FlowDiskCache, fleet_runner, fleet_service

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_fleet import golden  # noqa: E402,F401  (module fixture)
from test_torch_propose import JaxKeyDraws  # noqa: E402

_TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools",
                      "regen_golden.py")
_spec = importlib.util.spec_from_file_location("regen_golden", _TOOLS)
regen_golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(regen_golden)

SCEN = [tuple(sc) for sc in
        regen_golden.CASES["fleet_tuner_incremental"]["scenarios"]]
KW = dict(regen_golden.RUN_KW)
PROP = {"enabled": True, "every": 2}


def _draws():
    return [JaxKeyDraws(jax.random.PRNGKey(s)) for _, s in SCEN]


def _strip(history):
    return [{k: v for k, v in h.items() if k != "wall_s"} for h in history]


@pytest.fixture(scope="module")
def jax_q2(golden):
    """The reference's fleet service, q = 2 a scenario over four worker
    threads: without and with the proposer."""
    pool, fronts = golden
    space = make_space_j()
    return {prop: fleet_service_j(
        space, pool, [FleetScenarioJ(w, seed=s) for w, s in SCEN], q=2,
        executor="thread", max_workers=4, reference_fronts=fronts,
        proposer=PROP if prop else None, **KW) for prop in (False, True)}


def test_q1_inline_picks_what_fleet_tuner_picks(golden):
    pool, fronts = golden
    space = make_space()
    scen = [FleetScenario(w, seed=s) for w, s in SCEN]
    want = fleet_tuner(space, pool, scen, incremental=True, device="cpu",
                       reference_fronts=fronts, **KW)
    got = fleet_service(space, pool, scen, q=1, executor="inline",
                        reference_fronts=fronts, device="cpu", **KW)
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g.evaluated_rows, w.evaluated_rows)
        # a fleet_tuner flush evaluates both workloads in one multi-workload
        # call; the pool evaluates one design a call
        np.testing.assert_allclose(g.y, w.y, rtol=1e-6)
        assert [h["pareto_size"] for h in g.history] == \
            [h["pareto_size"] for h in w.history]
    assert got.results[0].engine_stats["rounds"] == \
        want.results[0].engine_stats["rounds"]


@pytest.mark.parametrize("proposer", [False, True])
def test_q2_threads_pick_what_the_reference_picks(golden, jax_q2, proposer):
    pool, fronts = golden
    got = fleet_service(make_space(), pool,
                        [FleetScenario(w, seed=s) for w, s in SCEN], q=2,
                        executor="thread", max_workers=4,
                        reference_fronts=fronts, draws=_draws(),
                        proposer=PROP if proposer else None, device="cpu",
                        **KW)
    want = jax_q2[proposer]
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g.evaluated_rows, w.evaluated_rows)
        np.testing.assert_allclose(g.y, w.y, rtol=1e-5)  # two float32 models
        assert [h["pareto_size"] for h in g.history] == \
            [h["pareto_size"] for h in w.history]
        assert g.history[-1]["adrs"] == pytest.approx(w.history[-1]["adrs"],
                                                      rel=1e-5)
    keys = ("rounds", "refactors", "block_updates", "fantasy_steps",
            "frontier_resamples", "scenario_refactors", "mixed_rounds",
            "service")
    gs, ws = got.results[0].engine_stats, want.results[0].engine_stats
    assert {k: gs[k] for k in keys} == {k: ws[k] for k in keys}
    if proposer:
        assert {k: v for k, v in gs["proposer"].items() if k != "wall_s"} \
            == {k: v for k, v in ws["proposer"].items() if k != "wall_s"}
        live = got.results[0].pool_live
        np.testing.assert_array_equal(live, got.results[1].pool_live)
        edited = int((live != pool).any(axis=1).sum())
        assert 0 < edited <= gs["proposer"]["replaced"]


def test_resume_after_a_crash_is_bit_for_bit(golden, tmp_path, monkeypatch):
    pool, fronts = golden
    space = make_space()
    scen = [FleetScenario(w, seed=s) for w, s in SCEN]
    kw = dict(KW, q=2, executor="thread", reference_fronts=fronts,
              cache_dir=str(tmp_path / "cache"), device="cpu")
    want = fleet_service(space, pool, scen, **kw)

    class Killed(Exception):
        pass

    def kill(pid, sig):
        assert (pid, sig) == (os.getpid(), signal.SIGKILL)
        raise Killed
    d = str(tmp_path / "ckpt")
    with monkeypatch.context() as mp:
        mp.setattr(fleet_runner.os, "kill", kill)
        with pytest.raises(Killed):
            fleet_service(space, pool, scen, checkpoint_dir=d, _kill_after=5,
                          **kw)
    got = fleet_service(space, pool, scen, checkpoint_dir=d, resume=True,
                        **kw)
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g.evaluated_rows, w.evaluated_rows)
        np.testing.assert_array_equal(g.y, w.y)
        assert _strip(g.history) == _strip(w.history)
    # the uninterrupted run filled the cache: the resumed run dispatched
    # nothing
    svc = got.results[0].engine_stats["service"]
    assert svc["pool_dispatched"] == 0 and svc["disk"]["misses"] == 0


def test_fleet_tuner_disk_cache_serves_a_second_run(golden, tmp_path):
    pool, fronts = golden
    space = make_space()
    scen = [FleetScenario(w, seed=s) for w, s in SCEN]
    kw = dict(KW, incremental=True, reference_fronts=fronts, device="cpu",
              disk_cache=str(tmp_path))
    first = fleet_tuner(space, pool, scen, **kw)
    second = fleet_tuner(space, pool, scen, **kw)
    assert first.cache.disk_hits == 0 and first.cache.flow_calls > 0
    assert second.cache.flow_calls == 0
    assert second.cache.disk_hits == first.cache.evaluated
    assert "disk hits" in second.cache.summary()
    for a, b in zip(first.results, second.results):
        np.testing.assert_array_equal(a.evaluated_rows, b.evaluated_rows)
        np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("factory", [False, True])
def test_eval_cache_disk_entries_serve_the_reference(golden, tmp_path,
                                                     factory):
    """The port's flushes write the reference's entries (both dispatch
    paths); the reference's cache then resolves the same rows from the
    disk without a flow call, to the same values."""
    pool, _ = golden
    space, space_j = make_space(), make_space_j()
    reqs = [("resnet50", np.array([3, 9, 3, 17])),
            ("transformer", np.array([9, 40]))]
    kw = {}
    if factory:
        from repro_torch.soc import VLSIFlow

        kw = dict(flow_factory=lambda wl: VLSIFlow(space, wl, device="cpu"))
    port = FlowEvalCache(space, pool, ["resnet50", "transformer"],
                         disk=FlowDiskCache(str(tmp_path)), device="cpu",
                         **kw)
    ys = port.evaluate_many(reqs)
    assert (port.misses, port.hits, port.evaluated) == (5, 1, 5)
    ref = FlowEvalCacheJ(space_j, pool, ["resnet50", "transformer"],
                         disk=str(tmp_path))
    ys_j = ref.evaluate_many(reqs)
    assert (ref.disk_hits, ref.flow_calls) == (5, 0)
    for a, b in zip(ys, ys_j):
        np.testing.assert_array_equal(a, b)
    port2 = FlowEvalCache(space, pool, ["resnet50"], disk=str(tmp_path),
                          device="cpu")
    port2.evaluate("resnet50", np.array([17, 3]))
    assert (port2.disk_hits, port2.flow_calls) == (2, 0)


def test_bad_fleets_are_refused(golden):
    pool, _ = golden
    space = make_space()
    with pytest.raises(ValueError, match="at least one scenario"):
        fleet_service(space, pool, [], device="cpu", **KW)
    with pytest.raises(ValueError, match="draws"):
        fleet_service(space, pool, [FleetScenario("resnet50")],
                      draws=_draws(), device="cpu", **KW)

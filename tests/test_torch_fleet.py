"""The port's fleet (``fleet_tuner``, ``FlowEvalCache``, ``fit_gp_batch``,
``imoo_scores_batch``, ``pad_workloads``, ``soc_metrics_multi``) against
the live JAX package on the CPU.

The fleet runs at the ``fleet_tuner_incremental`` golden configuration
(``tools/regen_golden.py``) on a pool drawn by JAX; one
``JaxKeyDraws`` a scenario replays the reference's per-scenario key
schedule (``fleet.py``: ``PRNGKey(seed)``, then ``split(key, 4)`` a round),
so both sides see the same trial rows, frontier subsets and normals.
"""
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import FleetScenario as FleetScenarioJ
from repro.core import fleet_tuner as fleet_tuner_j
from repro.core import make_space as make_space_j
from repro.core.acquisition import imoo_scores_batch as imoo_scores_batch_j
from repro.core.gp import fit_gp_batch as fit_gp_batch_j
from repro.core.gp import pad_training as pad_training_j
from repro.core.pareto import pareto_mask
from repro.core.tuner import frontier_subset_rows
from repro.soc import VLSIFlow as VLSIFlowJ
from repro.soc import get_workload as get_workload_j
from repro.soc import pad_workloads as pad_workloads_j
from repro.soc import soc_metrics_multi as soc_metrics_multi_j
from repro_torch import convert
from repro_torch.core import (FleetScenario, FlowEvalCache, fit_gp,
                              fit_gp_batch, fleet_tuner, imoo_scores_batch,
                              make_space, soc_tuner)
from repro_torch.core.gp import pad_training
from repro_torch.service import FlowDiskCache
from repro_torch.soc import (VLSIFlow, get_workload, metrics_tile,
                             pad_workloads, soc_metrics_multi)

_TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools",
                      "regen_golden.py")
_spec = importlib.util.spec_from_file_location("regen_golden", _TOOLS)
regen_golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(regen_golden)


class JaxKeyDraws:
    """One scenario's key schedule of ``repro.core.fleet`` (the same as
    ``soc_tuner``'s) as a ``TunerDraws``: ``split(key, 3)`` for the ICD
    trials, ``split(key, 4)`` a round, one key an objective for the joint
    samples' normals."""

    def __init__(self, key):
        self.key = key

    def prologue(self, n_pool, n):
        k_icd, _k_init, self.key = jax.random.split(self.key, 3)
        return np.asarray(jax.random.choice(
            k_icd, n_pool, shape=(min(n, n_pool),), replace=False))

    def round(self, n_pool, frontier_subset, m, s):
        self.key, _k_fit, k_acq, k_sub = jax.random.split(self.key, 4)
        sub = frontier_subset_rows(k_sub, n_pool, frontier_subset)
        q = n_pool if sub is None else len(sub)
        eps = np.stack([np.asarray(jax.random.normal(k, (q, s)))
                        for k in jax.random.split(k_acq, m)])
        return sub, eps


CASE = regen_golden.CASES["fleet_tuner_incremental"]
WORKLOADS = ("resnet50", "mobilenet", "transformer")
CACHE_KEYS = ("hits", "misses", "evaluated", "flow_calls")


@pytest.fixture(scope="module")
def golden():
    """The golden pool (JAX-drawn) and each workload's reference front."""
    space = make_space_j()
    pool = np.asarray(space.sample(jax.random.PRNGKey(regen_golden.POOL_SEED),
                                   regen_golden.N_POOL))
    fronts = {}
    for wl in WORKLOADS:
        y = np.asarray(VLSIFlowJ(space, wl)(pool))
        fronts[wl] = y[np.asarray(pareto_mask(jnp.asarray(y.astype(np.float64))))]
    return pool, fronts


def _run_both(pool, fronts, scen, **kw):
    kw = dict(regen_golden.RUN_KW, **kw)
    want = fleet_tuner_j(make_space_j(), pool,
                         [FleetScenarioJ(w, seed=s) for w, s in scen],
                         reference_fronts=fronts, **kw)
    got = fleet_tuner(make_space(), pool,
                      [FleetScenario(w, seed=s) for w, s in scen],
                      reference_fronts=fronts, device="cpu",
                      draws=[JaxKeyDraws(jax.random.PRNGKey(s))
                             for _, s in scen], **kw)
    return got, want


@pytest.mark.parametrize("incremental", [True, False])
def test_fleet_picks_equal_live_jax(golden, incremental):
    pool, fronts = golden
    assert [tuple(sc) for sc in CASE["scenarios"]] == [("resnet50", 0),
                                                        ("transformer", 1)]
    got, want = _run_both(pool, fronts, CASE["scenarios"],
                          incremental=incremental)
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g.evaluated_rows, w.evaluated_rows)
        # metrics from two float32 SoC models (the fused multi-workload
        # flushes included), the rest float64
        assert g.history[-1]["adrs"] == pytest.approx(w.history[-1]["adrs"],
                                                      rel=1e-5)
        assert [h["pareto_size"] for h in g.history] == \
            [h["pareto_size"] for h in w.history]
        np.testing.assert_allclose(g.y, w.y, rtol=1e-5)
    assert {k: getattr(got.cache, k) for k in CACHE_KEYS} == \
        {k: getattr(want.cache, k) for k in CACHE_KEYS}
    assert [sc.label for sc in got.scenarios] == \
        [sc.label for sc in want.scenarios]
    keys = ("rounds", "refactors", "block_updates", "dispatches",
            "frontier_resamples", "scenario_refactors",
            "scenario_block_updates", "mixed_rounds")
    assert {k: got.results[0].engine_stats[k] for k in keys} == \
        {k: want.results[0].engine_stats[k] for k in keys}
    assert got.final_adrs().keys() == want.final_adrs().keys()


@pytest.mark.parametrize("incremental", [False, True])
def test_fleet_of_one_is_soc_tuner(golden, incremental):
    """One scenario: the fleet picks the rows soc_tuner picks on the same
    draws, so its metrics, front and ADRS are bitwise soc_tuner's."""
    pool, fronts = golden
    kw = dict(regen_golden.RUN_KW, incremental=incremental)
    flow = VLSIFlow(make_space(), "resnet50", device="cpu")
    seq = soc_tuner(make_space(), pool, flow, reference_front=fronts["resnet50"],
                    draws=JaxKeyDraws(jax.random.PRNGKey(3)), device="cpu",
                    **kw)
    fr = fleet_tuner(make_space(), pool, [FleetScenario("resnet50", seed=3)],
                     reference_fronts=fronts, device="cpu",
                     draws=[JaxKeyDraws(jax.random.PRNGKey(3))], **kw)
    one = fr.results[0]
    np.testing.assert_array_equal(one.evaluated_rows, seq.evaluated_rows)
    np.testing.assert_array_equal(one.y, seq.y)
    np.testing.assert_array_equal(one.pareto_rows, seq.pareto_rows)
    assert [h["adrs"] for h in one.history] == [h["adrs"] for h in seq.history]
    # the fleet's flushes are the tuner's flow calls, minus the init rows
    # the ICD trials already evaluated
    assert fr.cache.flow_calls == flow.calls
    assert fr.cache.evaluated == len(seq.evaluated_rows)


def test_pad_workloads_equal():
    lists = [get_workload(w) for w in WORKLOADS]
    got = pad_workloads(lists)
    want = pad_workloads_j([get_workload_j(w) for w in WORKLOADS])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (3, 54, 5)
    np.testing.assert_array_equal(got[1].sum(1), [len(x) for x in lists])


@pytest.fixture(scope="module")
def multi_inputs():
    space = make_space_j()
    pool = np.asarray(space.sample(jax.random.PRNGKey(1), 3 * 40))
    vals = space.values(pool).reshape(3, 40, -1).astype(np.float32)
    layers, mask = pad_workloads_j([get_workload_j(w) for w in WORKLOADS])
    return vals, layers.astype(np.float32), mask.astype(np.float32)


def test_soc_metrics_multi_plain_matches_jax(multi_inputs):
    vals, layers, mask = multi_inputs
    want = np.asarray(soc_metrics_multi_j(vals, layers, mask))
    got = soc_metrics_multi(torch.tensor(vals), torch.tensor(layers),
                            torch.tensor(mask)).numpy()
    assert got.shape == (3, 40, 3)
    # float32 sums over the (padded) layers in two frameworks
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_soc_metrics_multi_plain_is_each_workloads_own_model(multi_inputs):
    """Padded layers add exactly nothing: workload w's slice is within
    float32 sum-order noise of the single-workload model on its own
    table."""
    vals, layers, mask = multi_inputs
    got = soc_metrics_multi(torch.tensor(vals), torch.tensor(layers),
                            torch.tensor(mask))
    for w, wl in enumerate(WORKLOADS):
        want = metrics_tile(torch.tensor(vals[w]),
                            torch.tensor(get_workload(wl), dtype=torch.float32))
        torch.testing.assert_close(got[w], want, rtol=1e-6, atol=0.0)


def _gp_batch_inputs(S=2, m=3, d=6, sizes=(13, 10), P=16):
    rng = np.random.default_rng(11)
    xs, ys, masks = [], [], []
    for n in sizes:
        x = (0.4 * rng.normal(size=(n, d))).astype(np.float32)
        y = rng.normal(size=(n, m)).astype(np.float32)
        xp, yp, mk = pad_training_j(jnp.asarray(x), jnp.asarray(y), P)
        xs.append(np.asarray(xp)), ys.append(np.asarray(yp))
        masks.append(np.asarray(mk))
    return np.stack(xs), np.stack(ys), np.stack(masks)


def test_fit_gp_batch_matches_jax():
    """The folded Adam loop against the reference's vmapped one (the
    tolerances of tests/test_torch_gp.py's fit)."""
    x, y, mask = _gp_batch_inputs()
    want = fit_gp_batch_j(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                          steps=30)
    got = fit_gp_batch(torch.tensor(x), torch.tensor(y), torch.tensor(mask),
                       steps=30)
    for a, b in zip(got.params, want.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(got.chol.numpy(), np.asarray(want.chol),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=1e-5,
                               atol=1e-6)


def test_fit_gp_batch_of_one_is_fit_gp():
    """S = 1: folding the scenario axis into the objectives is the
    identity, bit for bit."""
    rng = np.random.default_rng(12)
    x = torch.tensor((0.4 * rng.normal(size=(21, 6))).astype(np.float32))
    y = torch.tensor(rng.normal(size=(21, 3)).astype(np.float32))
    one = fit_gp(x, y, steps=25)
    xp, yp, mk = pad_training(x, y, 24)
    batch = fit_gp_batch(xp[None], yp[None], mk[None], steps=25)
    for a, b in zip(one.params, batch.params):
        assert torch.equal(a, b[0])
    assert torch.equal(one.chol, batch.chol[0])
    assert torch.equal(one.alpha, batch.alpha[0])


@pytest.mark.parametrize("weighted", [False, True])
def test_imoo_scores_batch_matches_jax(weighted):
    """Per-scenario frontier subsets and weights, with JAX-drawn normals
    (the tolerances of tests/test_torch_acquisition.py)."""
    x, y, mask = _gp_batch_inputs()
    states_j = fit_gp_batch_j(jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(mask), steps=30)
    rng = np.random.default_rng(13)
    cand = (0.4 * rng.normal(size=(2, 60, 6))).astype(np.float32)
    sub = np.stack([rng.choice(60, 20, replace=False) for _ in range(2)])
    fc = np.stack([cand[i][sub[i]] for i in range(2)])
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    weights = (np.asarray([[1, 1, 1], [3, 1, 1]], np.float32) if weighted
               else None)
    want = np.asarray(imoo_scores_batch_j(
        states_j, jnp.asarray(cand), keys, s=10,
        frontier_cand=jnp.asarray(fc),
        weights=None if weights is None else jnp.asarray(weights)))
    eps = np.stack([np.stack([np.asarray(jax.random.normal(k, (20, 10)))
                              for k in jax.random.split(key, 3)])
                    for key in keys])
    states_t = convert.gp_state_from_numpy(
        {k: np.asarray(v) for k, v in states_j.params._asdict().items()},
        *(np.asarray(v) for v in states_j[1:]), device="cpu")
    got = imoo_scores_batch(states_t, torch.tensor(cand), torch.tensor(eps),
                            frontier_cand=torch.tensor(fc),
                            weights=None if weights is None
                            else torch.tensor(weights)).numpy()
    assert got.shape == (2, 60)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_flow_cache_accounting(golden):
    """The reference's cache accounting: hits, misses, one flush a request,
    the fused multi-workload flush, values equal to a plain flow call."""
    pool, _ = golden
    space = make_space()
    cache = FlowEvalCache(space, pool, ["resnet50", "transformer"],
                          device="cpu")
    rows = np.arange(10)
    y1 = cache.evaluate("resnet50", rows)
    assert (cache.hits, cache.misses, cache.evaluated) == (0, 10, 10)
    y2 = cache.evaluate("resnet50", rows)
    assert (cache.hits, cache.misses, cache.evaluated) == (10, 10, 10)
    np.testing.assert_array_equal(y1, y2)
    y3 = cache.evaluate("transformer", rows)
    assert cache.misses == 20 and not np.allclose(y1, y3)
    calls = cache.flow_calls
    y4 = cache.evaluate_many([("resnet50", np.asarray([5, 11, 11])),
                              ("transformer", np.asarray([11, 12]))])
    assert cache.misses == 23 and cache.flow_calls == calls + 1
    assert cache.requests == cache.hits + cache.misses
    # a single-workload flush is VLSIFlow's call, bit for bit
    np.testing.assert_array_equal(
        y1, VLSIFlow(space, "resnet50", device="cpu")(pool[rows]))
    # the fused flush agrees with a plain flow call to float32 sum order
    np.testing.assert_allclose(
        y4[1], VLSIFlow(space, "transformer", device="cpu")(pool[[11, 12]]),
        rtol=1e-6)
    assert cache.peek("resnet50", 11) is not None
    assert cache.peek("resnet50", 40) is None
    assert (cache.peek_hits, cache.peek_misses) == (1, 1)
    cache.invalidate_rows([11])
    assert cache.invalidated == 2 and cache.peek("transformer", 11) is None
    assert "requests" in cache.summary()


def test_flow_factory_calls_each_pending_workload(golden):
    pool, _ = golden
    space = make_space()
    flows = {}

    def factory(wl):
        flows[wl] = VLSIFlow(space, wl, device="cpu")
        return flows[wl]

    cache = FlowEvalCache(space, pool, ["resnet50", "mobilenet"],
                          flow_factory=factory, device="cpu")
    cache.evaluate_many([("resnet50", np.arange(4)),
                         ("mobilenet", np.arange(3))])
    assert cache.flow_calls == 2 and cache.evaluated == 7
    assert (flows["resnet50"].evaluated, flows["mobilenet"].evaluated) == (4, 3)


@pytest.mark.parametrize("kw,item", [
    (dict(disk_cache="cache"), "12"), (dict(checkpoint_dir="ckpt"), "12"),
    (dict(resume=True), "12"), (dict(proposer=True), "11"),
    (dict(mesh=object()), "14b.8")])
def test_unported_fleet_options_raise(kw, item, tmp_path):
    """Each option is ported (by the ROADMAP item named): ``disk_cache``,
    ``checkpoint_dir``/``resume`` (item 12) and ``proposer`` (item 11) are
    taken (the proposer on the incremental engine), and ``disk_cache``
    writes every evaluated design to the disk; ``mesh`` (item 14b.8) is
    refused with the reference's ValueErrors where the reference refuses
    it: the exact path, a fleet that does not divide evenly over the mesh
    axis, and the proposer."""
    space = make_space()
    pool = space.sample(torch.Generator().manual_seed(0), 16).numpy()
    run = dict(T=1, n=4, b=2, device="cpu")
    if "mesh" in kw:
        from repro_torch.parallel import Mesh

        two = [FleetScenario("resnet50", seed=s) for s in (0, 1)]
        with pytest.raises(ValueError, match="mesh sharding requires "
                           "incremental=True"):
            fleet_tuner(space, pool, two, mesh=Mesh(["cpu"] * 2, "fleet"),
                        **run)
        with pytest.raises(ValueError, match="fleet size S=2 must divide "
                           "evenly over the 3 devices"):
            fleet_tuner(space, pool, two, incremental=True,
                        mesh=Mesh(["cpu"] * 3, "fleet"), **run)
        with pytest.raises(ValueError, match="proposer is incompatible "
                           "with mesh sharding"):
            fleet_tuner(space, pool, two, incremental=True, proposer=True,
                        mesh=Mesh(["cpu"] * 2, "fleet"), **run)
        return
    for name in ("checkpoint_dir", "disk_cache"):
        if name in kw:
            kw = {name: str(tmp_path / kw[name])}
    fr = fleet_tuner(space, pool, [FleetScenario("resnet50")],
                     incremental=True, **run, **kw)
    assert fr.results[0].engine_stats["rounds"] == 1
    if "checkpoint_dir" in kw:
        assert os.listdir(kw["checkpoint_dir"]) == ["ckpt_000001.npz"]
    if "disk_cache" in kw:
        assert fr.cache.evaluated > 0
        assert len(FlowDiskCache(kw["disk_cache"]).entries()) == \
            fr.cache.evaluated
    assert ("proposer" in fr.results[0].engine_stats) == ("proposer" in kw)


def test_fleet_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    space = make_space()
    pool = space.sample(torch.Generator().manual_seed(0), 16).numpy()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_tuner(space, pool, [FleetScenario("resnet50")], T=1, n=4, b=2)
    with pytest.raises(ValueError, match="draws"):
        fleet_tuner(space, pool, [FleetScenario("resnet50")], T=1, n=4, b=2,
                    device="cpu", draws=[])


def test_weighted_three_workload_fleet_runs_on_the_cpu(golden):
    """Six scenarios over three workloads (the fused flushes), one of them
    weighted: every scenario keeps soc_tuner's result layout."""
    pool, fronts = golden
    scen = [FleetScenario(w, seed=s) for w in WORKLOADS for s in range(2)]
    scen[-1] = FleetScenario("transformer", seed=1, weights=(3.0, 1.0, 1.0))
    fr = fleet_tuner(make_space(), pool, scen, T=2, n=8, b=6, gp_steps=10,
                     reference_fronts=fronts, device="cpu", incremental=True)
    assert len(fr.results) == 6 and fr.cache.misses == fr.cache.evaluated
    for res in fr.results:
        assert len(res.history) == 3
        assert np.isfinite(res.history[-1]["adrs"])
        assert len(set(res.evaluated_rows.tolist())) == len(res.evaluated_rows)
    assert fr.scenarios[-1].label == "transformer:s1:w3x1x1"

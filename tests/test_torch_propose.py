"""The port's between-round proposer (``DesignSpace.snap``,
``core/propose.py``, ``soc_tuner``'s and ``fleet_tuner``'s ``proposer``)
against the live JAX package on the CPU.

:class:`JaxKeyDraws` replays the reference's key schedule through the
port's draws protocol, the proposer's draws included (``fold_in(key,
PROPOSER_FOLD + it)``, then ``fold_in(·, t)``, ``split``, ``randint`` and
``normal`` off the key carried after round ``it``), so both sides see the
same normals and perturbations. Picks, victims and live pools are discrete
and must be equal; the proposer's counters too.
"""
import importlib.util
import os
import tempfile

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
from repro.core import propose as pj
from repro.core import soc_tuner as soc_tuner_j
from repro.core.pareto import pareto_mask as pareto_mask_j
from repro.core.tuner import frontier_subset_rows
from repro.service.checkpoint import latest_snapshot, load_snapshot
from repro.soc import VLSIFlow as VLSIFlowJ
from repro_torch.core import FleetScenario, fleet_tuner, make_space, soc_tuner
from repro_torch.core import propose as pt
from repro_torch.random import PROPOSER_FOLD, GeneratorDraws
from repro_torch.soc import VLSIFlow

_TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools",
                      "regen_golden.py")
_spec = importlib.util.spec_from_file_location("regen_golden", _TOOLS)
regen_golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(regen_golden)


class JaxKeyDraws:
    """``repro.core.tuner.soc_tuner``'s key schedule as a ``TunerDraws``:
    ``split(key, 3)`` for the ICD trials, ``split(key, 4)`` a round, one key
    an objective for the joint samples' normals, and the proposer's keys
    folded off the carried key; its state is the key."""

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

    def propose(self, it, t, draw, p, d):
        k_try = jax.random.fold_in(
            jax.random.fold_in(self.key, PROPOSER_FOLD + it), t)
        k_pick, k_eps = jax.random.split(k_try)
        return (np.asarray(jax.random.randint(k_pick, (draw,), 0, p)),
                np.asarray(jax.random.normal(k_eps, (draw, d))))

    def state_dict(self):
        return {"key": np.asarray(self.key)}

    def load_state_dict(self, d):
        self.key = jnp.asarray(d["key"])


TUNER_KW = dict(T=3, n=10, b=6, gp_steps=25, incremental=True)


@pytest.fixture(scope="module")
def pool96():
    return np.asarray(make_space_j().sample(jax.random.PRNGKey(7), 96))


@pytest.fixture(scope="module")
def golden():
    """The golden pool (JAX-drawn) and the reference fronts."""
    space = make_space_j()
    pool = np.asarray(space.sample(jax.random.PRNGKey(regen_golden.POOL_SEED),
                                   regen_golden.N_POOL))
    fronts = {}
    for wl in ("resnet50", "transformer"):
        y = np.asarray(VLSIFlowJ(space, wl)(pool))
        fronts[wl] = y[np.asarray(pareto_mask_j(jnp.asarray(
            y.astype(np.float64))))]
    return pool, fronts


def _counters(stats):
    return {k: v for k, v in stats.items() if k != "wall_s"}


# ------------------------------------------------------------------ snap
def test_snap_equals_jax_on_random_out_of_range_and_tie_inputs():
    sj, st = make_space_j(), make_space()
    rng = np.random.default_rng(0)
    d = sj.d
    table = np.asarray(sj._norm_table)
    # midpoints between neighbouring candidates: exact float32 ties
    mids = np.stack([(table[i, 0] + table[i, 1]) / np.float32(2.0)
                     for i in range(d)]).astype(np.float32)
    xs = [rng.uniform(0.0, 1.0, size=(64, d)).astype(np.float32),
          rng.uniform(-1.5, 2.5, size=(64, d)).astype(np.float32),
          np.stack([mids, table[:, 0], table[:, 1]]).astype(np.float32),
          rng.normal(size=(3, 5, d)).astype(np.float32)]
    for x in xs:
        want = np.asarray(sj.snap(x))
        got = st.snap(torch.from_numpy(x))
        assert got.dtype == torch.int64 and got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), want)
    # encode then snap is the identity on lattice points
    idx = st.sample(torch.Generator().manual_seed(1), 50)
    np.testing.assert_array_equal(st.snap(st.encode(idx)).numpy(), idx.numpy())


# -------------------------------------------------------- proposer parts
def test_proposer_config_errors_match_jax():
    for arg in ({"bogus": 1}, {"every": 0}, {"n_propose": 0},
                {"scale": -0.1}, {"max_tries": 0}, 3.14):
        errs = []
        for mod in (pj, pt):
            with pytest.raises((ValueError, TypeError)) as info:
                mod.ProposerConfig.from_arg(arg)
            errs.append((type(info.value), str(info.value)))
        assert errs[0] == errs[1]
    assert not pt.ProposerConfig.from_arg(None).enabled
    assert pt.ProposerConfig.from_arg(True).enabled
    cfg = pt.ProposerConfig(enabled=True, every=3)
    assert pt.ProposerConfig.from_arg(cfg) is cfg
    assert pt.ProposerConfig.from_arg(cfg.as_dict()) == cfg
    assert cfg.as_dict() == pj.ProposerConfig(enabled=True, every=3).as_dict()


def test_proposer_stats_roundtrip_and_fold_into_a_duck_typed_registry():
    st = pt.ProposerStats(rounds=3, proposed=7, replaced=5, wall_s=0.25)
    assert pt.ProposerStats.from_dict(st.as_dict()) == st

    class _Reg:
        def __init__(self):
            self.vals = {}

        def counter(self, name, help=""):
            reg = self

            class _C:
                def inc(self, v=1):
                    reg.vals[name] = reg.vals.get(name, 0) + v

            return _C()

    regs = []
    for s in (st, pj.ProposerStats(**st.as_dict())):
        reg = _Reg()
        s.fold_into(reg)
        regs.append(reg.vals)
    assert regs[0] == regs[1]
    assert regs[0]["pool_proposed_total"] == 7
    assert regs[0]["proposer_seconds_total"] == 0.25
    reg = _Reg()
    pt.ProposerStats().fold_into(reg)  # zero stats add nothing
    assert reg.vals == {}


def test_pareto_parents_equal_jax():
    rng = np.random.default_rng(3)
    pool_idx = rng.integers(0, 4, size=(40, 6)).astype(np.int64)
    pool_idx[7] = pool_idx[3]  # the same design twice
    evaluated = [[0, 3, 5, 9, 12, 17], [7, 2, 30, 31], []]
    ys = [rng.random((6, 3)), rng.random((4, 3)), None]
    ys[1][0] = ys[0][1]  # row 7 (= row 3's design) on both fronts
    want = pj.pareto_parents(pool_idx, evaluated, ys)
    got = pt.pareto_parents(pool_idx, evaluated, ys, device="cpu")
    assert got.dtype == np.int64 and len(got) >= 2
    np.testing.assert_array_equal(got, want)
    assert len(pt.pareto_parents(pool_idx, [[]], [None], device="cpu")) == 0


@pytest.mark.parametrize("scale,n_propose", [(0.15, 4), (0.3, 6), (0.03, 8)])
def test_propose_candidates_equal_jax(pool96, scale, n_propose):
    """The same children from the same keys: float32 perturbations, snap's
    nearest slot and the dedup against the pool and each other (0.03 is a
    crowded neighborhood: the retries widen it)."""
    sj, st = make_space_j(), make_space()
    parents = pool96[:5].astype(np.int64)
    exclude = {np.asarray(r, np.int64).tobytes() for r in pool96}
    key = jax.random.PRNGKey(11)
    it = 4
    want = pj.propose_candidates(
        sj, jax.random.fold_in(key, PROPOSER_FOLD + it), parents,
        n_propose=n_propose, scale=scale, exclude=exclude)
    draws = JaxKeyDraws(key)
    got = pt.propose_candidates(
        st, lambda t, n, p, d: draws.propose(it, t, n, p, d), parents,
        n_propose=n_propose, scale=scale, exclude=exclude)
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)
    for vec in got:
        assert vec.tobytes() not in exclude
    none = pt.propose_candidates(st, draws.propose, parents[:0], n_propose=4,
                                 scale=0.3, exclude=set())
    assert none.shape == (0, st.d)


def test_generator_draws_keep_the_round_stream_and_restore_state():
    """The proposer's draws come from a second generator: drawing them does
    not move the rounds', and a restored state replays both."""
    a, b = GeneratorDraws(5, "cpu"), GeneratorDraws(5, "cpu")
    a.prologue(100, 10), b.prologue(100, 10)
    a.propose(0, 0, 8, 3, 26)
    sa, sb = a.round(100, 50, 3, 10), b.round(100, 50, 3, 10)
    np.testing.assert_array_equal(sa[0], sb[0])
    assert torch.equal(sa[1], sb[1])
    snap = a.state_dict()
    assert all(v.dtype == np.uint8 for v in snap.values())
    want = (a.round(100, 50, 3, 10), a.propose(1, 0, 8, 3, 26))
    c = GeneratorDraws(99, "cpu")
    c.load_state_dict(snap)
    got = (c.round(100, 50, 3, 10), c.propose(1, 0, 8, 3, 26))
    np.testing.assert_array_equal(got[0][0], want[0][0])
    assert torch.equal(got[0][1], want[0][1])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    picks, eps = got[1]
    assert picks.dtype == np.int64 and eps.dtype == np.float32
    assert eps.shape == (8, 26) and picks.max() < 3


# ----------------------------------------------------------- the drivers
def _run_soc(pool, seed, *, jax_side, workload="resnet50", ref=None,
             ckpt_dir=None, **kw):
    if jax_side:
        space = make_space_j()
        return soc_tuner_j(space, pool, VLSIFlowJ(space, workload),
                           key=jax.random.PRNGKey(seed), reference_front=ref,
                           checkpoint_dir=ckpt_dir, **kw)
    space = make_space()
    return soc_tuner(space, pool, VLSIFlow(space, workload, device="cpu"),
                     draws=JaxKeyDraws(jax.random.PRNGKey(seed)),
                     reference_front=ref, device="cpu", **kw)


def _assert_soc_equal(got, want, want_pool):
    np.testing.assert_array_equal(got.evaluated_rows, want.evaluated_rows)
    assert _counters(got.engine_stats["proposer"]) == \
        _counters(want.engine_stats["proposer"])
    keys = ("rounds", "refactors", "block_updates", "pool_replacements",
            "v_chunk_refreshes")
    assert {k: got.engine_stats[k] for k in keys} == \
        {k: want.engine_stats[k] for k in keys}
    assert got.engine_stats["pool_replacements"] == \
        got.engine_stats["proposer"]["replaced"] > 0
    np.testing.assert_array_equal(got.pool_live, want_pool)


@pytest.mark.parametrize("seed,prop", [
    (0, {"enabled": True, "n_propose": 3, "scale": 0.3}),
    (2, {"enabled": True, "n_propose": 3, "scale": 0.3}),
    (1, {"enabled": True, "every": 2, "n_propose": 5})])
def test_soc_tuner_proposer_equals_live_jax(pool96, seed, prop):
    """Picks, the proposer's counters and the final live pool (the JAX
    run's, read from its last checkpoint) equal the reference's; the
    caller's pool is untouched."""
    pool_copy = pool96.copy()
    with tempfile.TemporaryDirectory() as d:
        want = _run_soc(pool96, seed, jax_side=True, ckpt_dir=d,
                        proposer=prop, **TUNER_KW)
        want_pool = load_snapshot(latest_snapshot(d))["pool_live"]
    got = _run_soc(pool96, seed, jax_side=False, proposer=prop, **TUNER_KW)
    np.testing.assert_array_equal(pool96, pool_copy)
    assert (want_pool != pool_copy).any()
    _assert_soc_equal(got, want, want_pool)


def test_soc_tuner_proposer_equals_live_jax_at_the_golden_config(golden):
    pool, fronts = golden
    case = regen_golden.CASES["soc_tuner_incremental"]
    kw = dict(regen_golden.RUN_KW, incremental=True, proposer=True)
    with tempfile.TemporaryDirectory() as d:
        want = _run_soc(pool, case["seed"], jax_side=True, ckpt_dir=d,
                        workload=case["workload"], ref=fronts["resnet50"],
                        **kw)
        want_pool = load_snapshot(latest_snapshot(d))["pool_live"]
    got = _run_soc(pool, case["seed"], jax_side=False,
                   workload=case["workload"], ref=fronts["resnet50"], **kw)
    _assert_soc_equal(got, want, want_pool)
    # metrics from two float32 SoC models (ulps apart), the rest float64
    assert got.history[-1]["adrs"] == pytest.approx(want.history[-1]["adrs"],
                                                     rel=1e-5)


def test_fleet_proposer_equals_live_jax_at_the_golden_config(golden):
    """Fleet-wide proposal (union of fronts, max over scenarios, scenario
    0's draws): each scenario's picks, the counters, the live pool that the
    cache aliases and the cache's invalidations equal the reference's."""
    pool, fronts = golden
    case = regen_golden.CASES["fleet_tuner_incremental"]
    scen = [tuple(sc) for sc in case["scenarios"]]
    kw = dict(regen_golden.RUN_KW, incremental=True, proposer=True)
    want = fleet_tuner_j(make_space_j(), pool,
                         [FleetScenarioJ(w, seed=s) for w, s in scen],
                         reference_fronts=fronts, **kw)
    got = fleet_tuner(make_space(), pool,
                      [FleetScenario(w, seed=s) for w, s in scen],
                      reference_fronts=fronts, device="cpu",
                      draws=[JaxKeyDraws(jax.random.PRNGKey(s))
                             for _, s in scen], **kw)
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g.evaluated_rows, w.evaluated_rows)
        assert g.history[-1]["adrs"] == pytest.approx(w.history[-1]["adrs"],
                                                      rel=1e-5)
        np.testing.assert_array_equal(g.pool_live, want.cache.pool_idx)
    assert _counters(got.results[0].engine_stats["proposer"]) == \
        _counters(want.results[0].engine_stats["proposer"])
    assert got.results[0].engine_stats["proposer"]["replaced"] > 0
    for k in ("pool_replacements", "v_chunk_refreshes"):
        assert got.results[0].engine_stats[k] == \
            want.results[0].engine_stats[k]
    np.testing.assert_array_equal(got.cache.pool_idx, want.cache.pool_idx)
    assert (got.cache.invalidated, got.cache.evaluated) == \
        (want.cache.invalidated, want.cache.evaluated)


def _traj(res):
    return (res.evaluated_rows, res.y,
            [{k: v for k, v in h.items() if k != "wall_s"}
             for h in res.history])


def _assert_same_traj(a, b):
    for x, y in zip(_traj(a), _traj(b)):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def test_proposer_off_and_a_noop_proposal_are_the_proposerless_run(
        pool96, monkeypatch):
    """``enabled=False`` is the run without the knob, bit for bit, with no
    ``proposer`` stats; an enabled proposer whose steps replace nothing
    leaves the trajectory as it is too (its draws never advance the round
    stream). Both with the default ``GeneratorDraws`` and for the fleet."""
    space = make_space()
    flow = VLSIFlow(space, "resnet50", device="cpu")
    base = soc_tuner(space, pool96, flow, seed=4, device="cpu", **TUNER_KW)
    off = soc_tuner(space, pool96, flow, seed=4, device="cpu",
                    proposer={"enabled": False}, **TUNER_KW)
    _assert_same_traj(base, off)
    assert "proposer" not in off.engine_stats and off.pool_live is None
    import repro_torch.core.fleet as fleet_mod
    import repro_torch.core.tuner as tuner_mod
    monkeypatch.setattr(tuner_mod, "propose_and_replace",
                        lambda *a, **k: None)
    noop = soc_tuner(space, pool96, flow, seed=4, device="cpu",
                     proposer=True, **TUNER_KW)
    _assert_same_traj(base, noop)
    np.testing.assert_array_equal(noop.pool_live, pool96)
    scen = [FleetScenario("resnet50", 4), FleetScenario("mobilenet", 1)]
    fkw = dict(TUNER_KW, device="cpu")
    fbase = fleet_tuner(space, pool96, scen, **fkw)
    monkeypatch.setattr(fleet_mod, "propose_and_replace",
                        lambda *a, **k: None)
    for prop in ({"enabled": False}, True):
        other = fleet_tuner(space, pool96, scen, proposer=prop, **fkw)
        for a, b in zip(fbase.results, other.results):
            _assert_same_traj(a, b)


def test_proposer_requires_incremental(pool96):
    space = make_space()
    flow = VLSIFlow(space, "resnet50", device="cpu")
    msgs = []
    for fn in (lambda: soc_tuner(space, pool96, flow, T=2, n=10, b=6,
                                 incremental=False, proposer=True,
                                 device="cpu"),
               lambda: fleet_tuner(space, pool96, [FleetScenario("resnet50")],
                                   T=2, n=10, b=6, incremental=False,
                                   proposer={"enabled": True}, device="cpu"),
               lambda: soc_tuner_j(make_space_j(), pool96,
                                   VLSIFlowJ(make_space_j(), "resnet50"),
                                   T=2, n=10, b=6, incremental=False,
                                   proposer=True)):
        with pytest.raises(ValueError) as info:
            fn()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] == msgs[2] and "incremental" in msgs[0]

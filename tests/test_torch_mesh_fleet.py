"""The port's fleet over a mesh (``BatchedBOEngine``, ``fleet_tuner`` and
``fleet_service`` with ``mesh=``: scenario groups, one a device) against
its unsharded run and the live JAX package on the CPU.

The groups run on repeated CPU devices, as the reference's own test forces
two CPU host devices. One ``JaxKeyDraws`` a scenario replays the
reference's key schedule. Under a mesh the refactor decision is fleet-wide
(``repro.core.engine``: any drifting scenario refactors them all), so a
mesh run equals the unsharded run only where that run has no mixed round;
a config with mixed rounds shows the difference, and there the mesh run
equals the reference's run under a one-device ``jax.sharding.Mesh``, which
takes the same fleet-wide decision.
"""
import types

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import numpy as np
from jax.sharding import Mesh as MeshJ

from repro.core import FleetScenario as FleetScenarioJ
from repro.core import fleet_tuner as fleet_tuner_j
from repro.core import make_space as make_space_j
from repro.core.engine import BatchedBOEngine as BatchedBOEngineJ
from repro.core.tuner import frontier_subset_rows
from repro_torch.core import FleetScenario, fleet_tuner, make_space
from repro_torch.core.engine import BatchedBOEngine
from repro_torch.parallel import Mesh
from repro_torch.service import fleet_service

#: the reference's two-device test (``tests/test_pool_scaling.py``)
KW = dict(T=2, n=8, b=6, gp_steps=20, incremental=True)
#: a config whose unsharded run splits its fleet: at round 3 the drifts
#: are 0.5017 and 0.4918 against drift_tol 0.5 (seeds 4 and 5)
MIXED = dict(T=4, n=8, b=6, gp_steps=20, incremental=True, drift_tol=0.5)
SEEDS = (0, 1)
MIXED_SEEDS = (4, 5)
STAT_KEYS = ("rounds", "refactors", "block_updates", "dispatches",
             "frontier_resamples", "scenario_refactors",
             "scenario_block_updates", "mixed_rounds")


class JaxKeyDraws:
    """One scenario's key schedule of ``repro.core.fleet`` as a
    ``TunerDraws`` (``tests/test_torch_fleet.py``'s)."""

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


def _mesh(n):
    return Mesh(["cpu"] * n, ("fleet",))


@pytest.fixture(scope="module")
def pool():
    return np.asarray(make_space_j().sample(jax.random.PRNGKey(0), 64))


def _port(pool, seeds=SEEDS, **kw):
    return fleet_tuner(make_space(), pool,
                       [FleetScenario("resnet50", seed=s) for s in seeds],
                       device="cpu",
                       draws=[JaxKeyDraws(jax.random.PRNGKey(s))
                              for s in seeds], **kw)


def _reference(pool, seeds=SEEDS, **kw):
    return fleet_tuner_j(make_space_j(), pool,
                         [FleetScenarioJ("resnet50", seed=s) for s in seeds],
                         **kw)


def _stats(fr):
    return {k: fr.results[0].engine_stats[k] for k in STAT_KEYS}


def _same_picks(a, b, rtol=None):
    for x, y in zip(a.results, b.results):
        np.testing.assert_array_equal(x.evaluated_rows, y.evaluated_rows)
        if rtol is None:
            np.testing.assert_array_equal(x.y, y.y)
        else:  # two float32 SoC models
            np.testing.assert_allclose(x.y, y.y, rtol=rtol)


def test_two_groups_equal_unsharded_and_reference(pool):
    """(a) The reference's config: 2 groups (``pool_chunk=13``) pick what
    the unsharded port and the live reference pick."""
    plain = _port(pool, **KW)
    sharded = _port(pool, mesh=_mesh(2), pool_chunk=13, **KW)
    want = _reference(pool, **KW)
    assert _stats(plain)["mixed_rounds"] == 0
    _same_picks(sharded, plain)
    _same_picks(sharded, want, rtol=1e-5)
    assert _stats(sharded) == _stats(plain) == _stats(want)


def test_mixed_rounds_refactor_fleet_wide(pool):
    """(b) Where the unsharded fleet mixes, the mesh refactors every
    scenario, as the reference's one-device mesh does."""
    kw = dict(MIXED, seeds=MIXED_SEEDS)
    plain = _port(pool, **kw)
    sharded = _port(pool, mesh=_mesh(2), **kw)
    want = _reference(pool, mesh=MeshJ(np.asarray(jax.devices()[:1]),
                                       ("fleet",)), **kw)
    _same_picks(sharded, want, rtol=1e-5)
    assert _stats(sharded) == _stats(want)
    got, split = _stats(sharded), _stats(plain)
    assert split["mixed_rounds"] == 1 and got["mixed_rounds"] == 0
    # every refactor round refactors both scenarios
    assert got["scenario_refactors"] == 2 * got["refactors"]
    assert got["scenario_refactors"] > split["scenario_refactors"]


def test_fleet_service_mesh_equals_unsharded(pool):
    """(c) ``fleet_service(mesh=...)``, q = 2 over threads: the fantasy
    chains run group by group and pick what the unsharded service picks.
    At the default drift_tol of 1.0 the unsharded service has a mixed
    round (so the mesh's fleet-wide refactor parts from it); at 2.0 it
    has none."""
    kw = dict(T=6, q=2, executor="thread", max_workers=2, n=8, b=6,
              gp_steps=20, drift_tol=2.0, device="cpu")
    scen = [FleetScenario("resnet50", seed=s) for s in SEEDS]
    plain = fleet_service(make_space(), pool, scen, **kw)
    sharded = fleet_service(make_space(), pool, scen, mesh=_mesh(2), **kw)
    assert _stats(plain)["mixed_rounds"] == 0
    _same_picks(sharded, plain)
    assert plain.results[0].engine_stats["fantasy_steps"] > 0
    assert _stats(sharded) == _stats(plain)
    assert sharded.results[0].engine_stats["fantasy_steps"] == \
        plain.results[0].engine_stats["fantasy_steps"]


def test_mesh_checkpoint_resumes_bit_for_bit(pool, tmp_path):
    """(d) A mesh run cut after round 2 and resumed under the same mesh
    equals the uninterrupted run; its snapshot has the unsharded engine's
    layout, array for array."""
    kw = dict(MIXED, mesh=_mesh(2), device="cpu")
    scen = [FleetScenario("resnet50", seed=s) for s in MIXED_SEEDS]

    def run(**extra):  # the default draws, whose state a checkpoint keeps
        return fleet_tuner(make_space(), pool, scen, **dict(kw, **extra))

    full = run()
    d = str(tmp_path / "ckpt")
    run(checkpoint_dir=d, T=2)
    resumed = run(checkpoint_dir=d, resume=True)
    _same_picks(resumed, full)
    for a, b in zip(resumed.results, full.results):
        assert [{k: v for k, v in h.items() if k != "wall_s"}
                for h in a.history] == \
            [{k: v for k, v in h.items() if k != "wall_s"} for h in b.history]
    assert _stats(resumed) == _stats(full)


@pytest.mark.parametrize("mesh,axis", [
    (Mesh(["cpu"] * 4, ("fleet",)), None),
    (Mesh(np.array([["cpu"] * 2] * 3, dtype=object), ("x", "fleet")),
     "fleet")])
def test_engine_state_dict_gathers_the_unsharded_layout(mesh, axis):
    """Four scenarios over 4 groups, and over 2 groups along the second
    axis of a 3 x 2 mesh: each round's picks and the snapshot (L, V, the
    padded batch, y*) equal the unsharded engine's; a fresh mesh engine
    loaded from it continues identically, and the pool's scores are the
    unsharded engine's."""
    rng = np.random.default_rng(3)
    pools = np.stack([rng.normal(size=(24, 5)) / np.sqrt(5)
                      for _ in range(4)]).astype(np.float32)
    kw = dict(gp_steps=15, warm_steps=5, pool_chunk=7, device="cpu")
    plain = BatchedBOEngine(pools, **kw)
    sharded, again = (BatchedBOEngine(pools, mesh=mesh, mesh_axis=axis, **kw)
                      for _ in range(2))
    assert len(sharded._groups) == (4 if axis is None else 2)
    W = np.random.default_rng(9).normal(size=(5, 3))

    def flow(si, rows):
        return np.tanh(pools[si][rows] @ W) + 0.1 * si

    init = [[0, 1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11], [1, 3, 5, 7, 9, 11]]
    for eng in (plain, sharded):
        eng.observe(init, [flow(si, r) for si, r in enumerate(init)])
    gen = np.random.default_rng(4)
    for _ in range(3):
        eps = gen.normal(size=(4, 3, 24, 10)).astype(np.float32)
        a, b = plain.select(eps), sharded.select(eps)
        np.testing.assert_array_equal(a, b)
        for eng in (plain, sharded):
            eng.observe([[int(p)] for p in a],
                        [flow(si, [int(p)]) for si, p in enumerate(a)])
    snap, ref = sharded.state_dict(), plain.state_dict()
    again.load_state_dict(snap)
    assert plain.stats.mixed_rounds == 0
    for key in ("L", "V"):
        np.testing.assert_array_equal(snap["state"][key], ref["state"][key])
    for key in ("rows_pad", "y_pad", "mask"):
        np.testing.assert_array_equal(snap["last_batch"][key],
                                      ref["last_batch"][key])
    np.testing.assert_array_equal(snap["last_ystar"], ref["last_ystar"])
    eps = gen.normal(size=(4, 3, 24, 10)).astype(np.float32)
    picks = [e.select(eps) for e in (plain, sharded, again)]
    np.testing.assert_array_equal(picks[0], picks[1])
    np.testing.assert_array_equal(picks[0], picks[2])
    np.testing.assert_array_equal(sharded.pool_scores(), plain.pool_scores())


def _message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_mesh_refusals_match_the_reference(pool):
    """(e) The exact path, an uneven split and the proposer are refused
    with the reference's ValueErrors, word for word; an axis the mesh does
    not have is a KeyError, as there."""
    pools = np.zeros((2, 16, 5), np.float32)
    one = MeshJ(np.asarray(jax.devices()[:1]), ("fleet",))
    three = types.SimpleNamespace(axis_names=("fleet",),
                                  devices=np.empty((3,), object))
    assert _message(lambda: BatchedBOEngine(
        pools, incremental=False, mesh=_mesh(1), device="cpu")) == \
        _message(lambda: BatchedBOEngineJ(pools, incremental=False,
                                          mesh=one))
    assert _message(lambda: BatchedBOEngine(pools, mesh=_mesh(3),
                                            device="cpu")) == \
        _message(lambda: BatchedBOEngineJ(pools, mesh=three))
    kw = dict(T=1, n=4, b=2, incremental=True, proposer=True)
    assert _message(lambda: _port(pool, mesh=_mesh(2), **kw)) == \
        _message(lambda: _reference(pool, mesh=one, **kw))
    assert _message(lambda: fleet_service(
        make_space(), pool, [FleetScenario("resnet50", seed=s)
                             for s in SEEDS], mesh=_mesh(2), device="cpu",
        **kw)) == _message(lambda: _reference(pool, mesh=one, **kw))
    with pytest.raises(KeyError):
        BatchedBOEngine(pools, mesh=_mesh(2), mesh_axis="data", device="cpu")
    with pytest.raises(KeyError):
        BatchedBOEngineJ(pools, mesh=one, mesh_axis="data")


def _engines(mesh_groups, pools, **kw):
    return (BatchedBOEngine(pools, **kw),
            BatchedBOEngine(pools, mesh=_mesh(mesh_groups), **kw))


@pytest.mark.parametrize("groups", [2, 4])
def test_pool_edits_under_a_mesh_equal_the_unsharded_engine(groups):
    """Under a mesh the fleet's engine holds no device array: the groups
    hold the pool, the masks and the state. A replacement, an append, a
    refused replacement of an evaluated row, the ids, the stats, the
    scores, the picks and the snapshot (with its ``pool_edit`` block) equal
    the unsharded engine's; a fresh mesh engine on the edited pool resumes
    from that snapshot; ``release`` frees every group."""
    rng = np.random.default_rng(5)
    pools = np.stack([rng.normal(size=(20, 5)) / np.sqrt(5)
                      for _ in range(4)]).astype(np.float32)
    kw = dict(gp_steps=12, warm_steps=4, pool_chunk=6, device="cpu")
    plain, sharded = _engines(groups, pools, **kw)
    assert sharded.pool is None and sharded._pool_c is None
    assert sharded.device_bytes() == plain.device_bytes()  # the fleet once
    W = np.random.default_rng(2).normal(size=(5, 3))

    def flow(eng, si, rows):  # the unsharded engine holds the live pool
        return np.tanh(plain.pool[si][rows].numpy() @ W)

    init = [[0, 1, 2, 3], [4, 5, 6], [1, 7, 8], [2, 9, 10, 11]]
    gen = np.random.default_rng(6)
    for eng in (plain, sharded):
        eng.observe(init, [flow(eng, si, r) for si, r in enumerate(init)])
    eps = gen.normal(size=(4, 3, 20, 10)).astype(np.float32)
    np.testing.assert_array_equal(plain.select(eps), sharded.select(eps))
    cols = (rng.normal(size=(4, 2, 5)) / np.sqrt(5)).astype(np.float32)
    new = (rng.normal(size=(4, 3, 5)) / np.sqrt(5)).astype(np.float32)
    for eng in (plain, sharded):
        with pytest.raises(ValueError) as err:
            eng.pool_replace([3, 15], cols)
        eng.err = str(err.value)
        eng.pool_replace([13, 15], cols)
        eng.rows_new = eng.pool_append(new)
    assert sharded.err == plain.err
    np.testing.assert_array_equal(sharded.rows_new, plain.rows_new)
    np.testing.assert_array_equal(sharded.candidate_ids, plain.candidate_ids)
    np.testing.assert_array_equal(sharded.pool_scores(), plain.pool_scores())
    assert sharded.N == plain.N == 23
    eps = gen.normal(size=(4, 3, 23, 10)).astype(np.float32)
    picks = plain.select(eps)
    np.testing.assert_array_equal(sharded.select(eps), picks)
    assert sharded.stats.as_dict() == plain.stats.as_dict()
    snap, ref = sharded.state_dict(), plain.state_dict()
    assert snap.keys() == ref.keys()
    np.testing.assert_array_equal(snap["pool_edit"]["pool"],
                                  ref["pool_edit"]["pool"])
    np.testing.assert_array_equal(snap["state"]["V"], ref["state"]["V"])
    again = BatchedBOEngine(ref["pool_edit"]["pool"], mesh=_mesh(groups),
                            **kw)
    again.load_state_dict(snap)
    np.testing.assert_array_equal(again.candidate_ids, plain.candidate_ids)
    np.testing.assert_array_equal(again.pool_scores(), plain.pool_scores())
    assert sharded._state is None
    assert sharded.device_bytes() == plain.device_bytes() > 0
    sharded.release()
    assert sharded.device_bytes() == 0
    assert all(g.pool is None for g in sharded._groups)


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_mesh_groups_run_their_gp_work_at_the_fleets_batch(groups,
                                                          monkeypatch):
    """Every group of a six-scenario fleet fits, factors and samples its
    frontiers at the whole fleet's batch of 6 scenarios (its own padded
    with copies of its first): the shapes under which, on the card, its
    GPs get the unsharded fleet's bits."""
    from repro_torch.core import engine as E

    seen = []
    for name in ("_fit_batch", "_chol_refactor_batch", "_chol_block_batch",
                 "_beta_ystar_batch"):
        def spy(*args, _f=getattr(E, name), _n=name):
            lead = args[2] if _n == "_fit_batch" else args[0].log_var
            seen.append((_n, lead.shape[0]))
            return _f(*args)
        monkeypatch.setattr(E, name, spy)
    rng = np.random.default_rng(7)
    pools = np.stack([rng.normal(size=(16, 4)) / np.sqrt(4)
                      for _ in range(6)]).astype(np.float32)
    kw = dict(gp_steps=6, warm_steps=3, drift_tol=1e9, device="cpu")
    plain, sharded = _engines(groups, pools, **kw)
    W = np.random.default_rng(8).normal(size=(4, 3))
    init = [[(si + k) % 16 for k in range(9)] for si in range(6)]
    for _ in range(3):
        for eng in (plain, sharded):
            eng.observe(init, [np.tanh(pools[si][r] @ W)
                               for si, r in enumerate(init)])
        eps = rng.normal(size=(6, 3, 16, 10)).astype(np.float32)
        seen.clear()
        picks = sharded.select(eps)
        assert len(seen) == 3 * groups  # fit, factors, frontier a group
        assert all(S == 6 for _, S in seen), seen
        np.testing.assert_array_equal(picks, plain.select(eps))
        init = [[int(p)] for p in picks]
    assert sharded.stats.block_updates == plain.stats.block_updates > 0

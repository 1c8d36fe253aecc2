"""The port's BatchedBOEngine against the live JAX package on the CPU.

Two scenarios, each with its own pool and training rows, are driven side by
side through the reference's ``BatchedBOEngine`` (per-scenario keys) and the
port's (the normals those keys draw, handed over as ``eps``): the picks and
the refactor decisions must be equal. A forced mixed round, ragged pending
fantasy chains under the three liars, the chunk grid, the snapshot and a
fleet of one (against :class:`BOEngine`) are covered.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import numpy as np

from repro.core import engine as ej
from repro_torch import convert
from repro_torch.core import engine as et

S, M, N, D = 2, 3, 40, 5
KW = dict(incremental=True, gp_steps=25, warm_steps=5)


def _eps(key, q, s=10):
    """The normals the reference's ``_frontier_ystar`` draws from ``key``."""
    return np.stack([np.asarray(jax.random.normal(k, (q, s)))
                     for k in jax.random.split(key, M)])


def _pools():
    return np.stack([np.random.default_rng(20 + si).normal(size=(N, D))
                     for si in range(S)]).astype(np.float32)


def _flow(pool, si):
    W = np.random.default_rng(99 + si).normal(size=(D, M))

    def f(rows):
        x = pool[si][np.asarray(rows, np.int64)]
        return (np.tanh(x @ W)
                + 0.1 * np.sin(x.sum(1))[:, None]).astype(np.float32)

    return f


def _engine(pools, jax_engine, **kw):
    kw = {**KW, **kw}
    if jax_engine:
        return ej.BatchedBOEngine(pools, **kw)
    return et.BatchedBOEngine(pools, device="cpu", **kw)


def _drive(pools, *, rounds, jax_engine=False, n_init=(10, 13), seed=3,
           q=0, pending=None, fantasy="mean", **kw):
    """Observe each scenario's first rows, then ``rounds`` rounds (and one
    q-batch with ``pending`` when ``q``); returns (picks, engine)."""
    flows = [_flow(pools, si) for si in range(S)]
    eng = _engine(pools, jax_engine, **kw)
    init = [list(range(si, si + n_init[si])) for si in range(S)]
    eng.observe(init, [f(r) for f, r in zip(flows, init)])
    key = jax.random.PRNGKey(seed)
    picks = []

    def arg(k):
        keys = jax.random.split(k, S)
        return keys if jax_engine else [_eps(kk, N) for kk in keys]

    for _ in range(rounds):
        key, k = jax.random.split(key)
        nxt = [int(p) for p in eng.select(arg(k))]
        picks.append(nxt)
        eng.observe([[p] for p in nxt], [f([p]) for f, p in zip(flows, nxt)])
    if q:
        key, k = jax.random.split(key)
        picks.append(np.asarray(eng.select_q(
            arg(k), q, pending=pending, fantasy=fantasy)).tolist())
    return picks, eng


STAT_KEYS = ("rounds", "refactors", "block_updates", "dispatches",
             "fantasy_steps", "frontier_resamples", "scenario_refactors",
             "scenario_block_updates", "mixed_rounds")


def _stats(eng):
    return {k: getattr(eng.stats, k) for k in STAT_KEYS}


@pytest.mark.parametrize("incremental", [False, True])
def test_batched_picks_and_decisions_equal_live_jax(incremental):
    """Six rounds across a bucket growth (refactors, block updates)."""
    pools = _pools()
    want, ej_eng = _drive(pools, rounds=6, jax_engine=True,
                          incremental=incremental)
    got, et_eng = _drive(pools, rounds=6, incremental=incremental)
    assert got == want
    assert _stats(et_eng) == _stats(ej_eng)
    if incremental:
        assert et_eng.stats.block_updates >= 1
        assert et_eng.device_bytes() == ej_eng.device_bytes()


def _drifts(pools):
    """Each scenario's drift at the second round, from one-scenario engines
    (the batched engine's per-scenario decision compares these)."""
    out = []
    for si in range(S):
        f = _flow(pools, si)
        eng = et.BOEngine(pools[si], device="cpu", drift_tol=1e9, **KW)
        init = list(range(si, si + (10, 13)[si]))
        eng.observe(init, f(init))
        key = jax.random.PRNGKey(3)
        for _ in range(2):
            key, k = jax.random.split(key)
            nxt = eng.select(_eps(jax.random.split(k, S)[si], N))
            eng.observe([nxt], f([nxt]))
        out.append(eng.stats.last_drift)
    return out


def test_forced_mixed_round_equals_live_jax():
    """A drift tolerance between the two scenarios' drifts: one scenario
    refactors while the other block-updates, on both sides."""
    pools = _pools()
    d = sorted(_drifts(pools))
    # the set-up splits the fleet by far more than float32 noise
    assert d[1] - d[0] > 1e-4 * d[1], d
    tol = 0.5 * (d[0] + d[1])
    want, ej_eng = _drive(pools, rounds=3, jax_engine=True, drift_tol=tol)
    got, et_eng = _drive(pools, rounds=3, drift_tol=tol)
    assert got == want
    assert et_eng.stats.mixed_rounds >= 1
    assert _stats(et_eng) == _stats(ej_eng)


@pytest.mark.parametrize("fantasy", ["mean", "cl_min", "cl_max"])
def test_select_q_with_ragged_pending_equals_live_jax(fantasy):
    pools = _pools()
    pend = [[30, 31, 32], [35]]   # ragged on purpose
    want, ej_eng = _drive(pools, rounds=2, q=2, pending=pend, fantasy=fantasy,
                          jax_engine=True)
    got, et_eng = _drive(pools, rounds=2, q=2, pending=pend, fantasy=fantasy)
    assert got == want
    for si in range(S):
        assert not set(got[-1][si]) & set(pend[si])
    assert et_eng.stats.fantasy_steps == (3 + 1) + (1 + 1)
    assert _stats(et_eng) == _stats(ej_eng)


def test_select_q_scenario_without_pending_keeps_the_round_pick():
    """A scenario with nothing pending in a fleet that has pending rows
    elsewhere takes idle steps: its first pick is the round's own."""
    pools = _pools()
    _, e1 = _drive(pools, rounds=1)
    _, e2 = _drive(pools, rounds=1)
    eps = [_eps(k, N) for k in jax.random.split(jax.random.PRNGKey(9), S)]
    ref = e1.select(eps)
    picks = e2.select_q(eps, 1, pending=[[30, 31], []])
    assert int(picks[1, 0]) == int(ref[1])
    assert int(picks[0, 0]) not in (30, 31)


@pytest.mark.parametrize("chunk", [7, 40])
def test_batched_picks_do_not_depend_on_the_chunk_size(chunk):
    pools = _pools()
    ref, _ = _drive(pools, rounds=7, q=2, pending=[[30], []])
    got, eng = _drive(pools, rounds=7, q=2, pending=[[30], []],
                      pool_chunk=chunk)
    assert got == ref
    assert eng._nc == -(-N // chunk)


def test_batched_state_dict_roundtrip():
    """Two snapshots taken at the same point (after a restore, before any
    round) are equal, and the restored engine picks what the live one
    picks."""
    pools = _pools()
    _, eng = _drive(pools, rounds=3)
    sd = eng.state_dict()
    restored = _engine(pools, False)
    restored.load_state_dict(sd)
    sd_b = restored.state_dict()
    for k in ("L", "V"):
        np.testing.assert_array_equal(sd["state"][k], sd_b["state"][k])
    for si in range(S):
        np.testing.assert_array_equal(sd["rows"][str(si)],
                                      sd_b["rows"][str(si)])
        np.testing.assert_array_equal(sd["ys"][str(si)], sd_b["ys"][str(si)])
    assert sd["stats"] == sd_b["stats"]
    frozen = {k: sd["state"][k].copy() for k in ("L", "V")}
    eps = [_eps(k, N) for k in jax.random.split(jax.random.PRNGKey(5), S)]
    np.testing.assert_array_equal(restored.select(eps), eng.select(eps))
    for k in ("L", "V"):  # K4 wrote V in place; the snapshot is a copy
        np.testing.assert_array_equal(sd["state"][k], frozen[k])
    eng.release()
    assert eng.device_bytes() == 0


def test_reference_snapshot_continues_in_the_port():
    """The JAX engine's state_dict, loaded into the port, gives its next
    picks."""
    pools = _pools()
    _, jeng = _drive(pools, rounds=3, jax_engine=True)
    teng = _engine(pools, False)
    teng.load_state_dict(convert.engine_state_from_numpy(jeng.state_dict()))
    keys = jax.random.split(jax.random.PRNGKey(11), S)
    np.testing.assert_array_equal(teng.select([_eps(k, N) for k in keys]),
                                  np.asarray(jeng.select(keys)))


@pytest.mark.parametrize("incremental", [False, True])
def test_fleet_of_one_is_the_sequential_engine(incremental):
    """S = 1: the batched engine's rounds pick what BOEngine picks, bit for
    bit (the fold of the scenario axis is the identity)."""
    pool = _pools()[:1]
    f = _flow(pool, 0)
    kw = {**KW, "incremental": incremental}
    one = et.BOEngine(pool[0], device="cpu", **kw)
    fleet = et.BatchedBOEngine(pool, device="cpu", **kw)
    init = list(range(11))
    one.observe(init, f(init))
    fleet.observe([init], [f(init)])
    key = jax.random.PRNGKey(4)
    for _ in range(5):
        key, k = jax.random.split(key)
        e = _eps(k, N)
        p1 = one.select(e)
        assert [p1] == fleet.select([e]).tolist()
        one.observe([p1], f([p1]))
        fleet.observe([[p1]], [f([p1])])
    if incremental:
        assert torch.equal(one._state.L, fleet._state.L[0])
        assert torch.equal(one._state.V, fleet._state.V[0])


def test_batched_engine_refusals(monkeypatch):
    pools = _pools()
    # the reference's mesh refusals, word for word: the exact path, and a
    # fleet that does not divide evenly over the mesh axis
    from repro_torch.parallel import Mesh

    with pytest.raises(ValueError, match="mesh sharding requires "
                       "incremental=True"):
        et.BatchedBOEngine(pools, incremental=False, device="cpu",
                           mesh=Mesh(["cpu"], ("fleet",)))
    with pytest.raises(ValueError, match=r"fleet size S=2 must divide "
                       r"evenly over the 3 devices of mesh axis 'fleet'"):
        et.BatchedBOEngine(pools, device="cpu",
                           mesh=Mesh(["cpu"] * 3, ("fleet",)))
    with pytest.raises(ValueError, match=r"\[S, N, d\]"):
        et.BatchedBOEngine(pools[0], device="cpu")
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            et.BatchedBOEngine(pools)  # the default device is cuda
    eng = _engine(pools, False)
    with pytest.raises(RuntimeError, match="before observe"):
        eng.select([_eps(jax.random.PRNGKey(0), N)] * S)
    eng.observe([[0, 1, 2], [3, 4]], [np.ones((3, 3)), np.ones((2, 3))])
    with pytest.raises(ValueError, match="fantasy"):
        eng.select_q([_eps(jax.random.PRNGKey(0), N)] * S, 2, fantasy="x")
    with pytest.raises(ValueError, match="entries"):
        eng.select_q([_eps(jax.random.PRNGKey(0), N)] * S, 2, pending=[[1]])
    exact = _engine(pools, False, incremental=False)
    exact.observe([[0, 1, 2], [3, 4]], [np.ones((3, 3)), np.ones((2, 3))])
    with pytest.raises(ValueError, match="incremental"):
        exact.select_q([_eps(jax.random.PRNGKey(0), N)] * S, 2)

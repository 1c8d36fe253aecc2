"""The port's mutable pools (``candidate_ids``, ``pool_append``,
``pool_replace``, the dirty-chunk V refresh, ``pool_scores`` and the
snapshot's ``pool_edit`` block) against the live JAX package on the CPU,
case by case after ``tests/test_pool_mutation.py``, for both engines.

The engines are driven side by side with the reference's key schedule: each
round's key is split from a seed key and the port is handed the normals
that key draws (``split(key, m)``, ``normal(k, (q, s))``; a batched round
splits one key a scenario first). Picks and counters must be equal; the
scores are float32 sums of two libraries and agree within rtol = atol =
1e-4 with equal ``-inf`` positions. Properties of the port alone (a cold
edit is a fresh engine, a refreshed chunk is a full refactor's, a snapshot
round-trips) are bitwise.
"""
import re

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import engine as ej
from repro_torch import convert
from repro_torch.core import engine as et
from repro_torch.kernels import round_fused as K4

GP = dict(gp_steps=10)  # tiny fits: the parity claims are picks, not quality
M = 2                   # objectives of _yfun


def _mkpool(n, d=5, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _yfun(pool):
    """Deterministic 2-objective metrics from (final) pool content."""
    p = np.asarray(pool, np.float64)

    def f(rows):
        sub = p[np.asarray(rows, np.int64)]
        y = np.stack([np.abs(sub).sum(-1), 1.0 + np.cos(sub).sum(-1) ** 2],
                     axis=-1)
        return y.astype(np.float32)

    return f


def _eps(key, q, s=10):
    """The normals the reference's ``_frontier_ystar`` draws from ``key``."""
    return np.stack([np.asarray(jax.random.normal(k, (q, s)))
                     for k in jax.random.split(key, M)])


def _make(cls_name, pool, jax_engine, **kw):
    """A ``BOEngine`` or ``BatchedBOEngine`` of the reference or the port."""
    mod = ej if jax_engine else et
    extra = {} if jax_engine else {"device": "cpu"}
    return getattr(mod, cls_name)(jnp.asarray(pool) if jax_engine else pool,
                                  **GP, **kw, **extra)


def _is_jax(eng):
    return isinstance(eng, (ej.BOEngine, ej.BatchedBOEngine))


def _run_rounds(eng, yf, seed=11, rounds=3, q=2):
    """The reference test's observe/select_q rounds; returns the picks."""
    batched = isinstance(eng, (ej.BatchedBOEngine, et.BatchedBOEngine))
    key = jax.random.PRNGKey(seed)
    picks_all = []
    for _ in range(rounds):
        key, k = jax.random.split(key)
        if batched:
            keys = jax.random.split(k, eng.S)
            arg = keys if _is_jax(eng) else [_eps(kk, eng.N) for kk in keys]
            picks = np.asarray(eng.select_q(arg, q=q))
            rows = np.unique(picks.reshape(-1))
            eng.observe([rows] * eng.S, [yf(rows), 2.0 * yf(rows)])
        else:
            arg = k if _is_jax(eng) else _eps(k, eng.N)
            picks = np.asarray(eng.select_q(arg, q=q))
            rows = picks.reshape(-1)
            eng.observe(rows, yf(rows))
        picks_all.append(picks)
    return np.concatenate([p.reshape(-1) for p in picks_all])


def _observe(eng, rows, yf):
    if isinstance(eng, (ej.BatchedBOEngine, et.BatchedBOEngine)):
        eng.observe([rows] * eng.S,
                    [yf(rows)] + [2.0 * yf(rows)] * (eng.S - 1))
    else:
        eng.observe(rows, yf(rows))


def _unevaluated(eng, rows):
    """The rows of ``rows`` that no scenario of ``eng`` has evaluated."""
    ev = np.asarray(eng._eval_mask).reshape(-1, eng.N).any(0)
    return [r for r in rows if not ev[r]]


def _stack(p):
    return np.stack([p, 0.5 * p])


ENGINES = {"BOEngine": lambda p: p, "BatchedBOEngine": _stack}


def _cols(cls_name, cols):
    return ENGINES[cls_name](np.asarray(cols, np.float32))


# ------------------------------------------------------------ stable ids
@pytest.mark.parametrize("cls_name", list(ENGINES))
def test_candidate_ids_equal_live_jax(cls_name):
    mk = ENGINES[cls_name]
    engs = [_make(cls_name, mk(_mkpool(12)), j) for j in (True, False)]
    for eng in engs:
        np.testing.assert_array_equal(eng.candidate_ids, np.arange(12))
        rows = eng.pool_append(_cols(cls_name, _mkpool(3, seed=1)))
        np.testing.assert_array_equal(rows, [12, 13, 14])
        eng.pool_replace([3, 7], _cols(cls_name, _mkpool(2, seed=2)))
    jeng, teng = engs
    np.testing.assert_array_equal(teng.candidate_ids, jeng.candidate_ids)
    ids = teng.candidate_ids
    assert ids[3] == 15 and ids[7] == 16
    assert (teng.stats.pool_appends, teng.stats.pool_replacements) == \
        (jeng.stats.pool_appends, jeng.stats.pool_replacements) == (3, 2)
    np.testing.assert_array_equal(teng.pool.numpy(), np.asarray(jeng.pool))


# ----------------------------------------------- cold-edit bitwise parity
@pytest.mark.parametrize("chunk", [8, 16, None])
def test_cold_replace_bitwise_matches_fresh_engine(chunk):
    """Replacing unevaluated columns of a cold engine is constructing it on
    the edited pool, bit for bit (row 0, the pad chunk's alias, chunk-edge
    rows and the last row), and picks what the reference picks."""
    final = _mkpool(30, seed=3)          # 30 < pad: pad copies row 0
    victims = np.asarray([0, 7, 8, 29])  # chunk edges for C=8
    start = final.copy()
    start[victims] = _mkpool(4, seed=4) + 5.0
    yf = _yfun(final)
    init = [2, 5, 17]

    edited = et.BOEngine(start, pool_chunk=chunk, device="cpu", **GP)
    edited.pool_replace(victims, final[victims])
    edited.observe(init, yf(init))
    fresh = et.BOEngine(final, pool_chunk=chunk, device="cpu", **GP)
    fresh.observe(init, yf(init))
    want = ej.BOEngine(jnp.asarray(start), pool_chunk=chunk, **GP)
    want.pool_replace(victims, final[victims])
    want.observe(init, yf(init))

    got = _run_rounds(edited, yf)
    np.testing.assert_array_equal(got, _run_rounds(fresh, yf))
    np.testing.assert_array_equal(got, _run_rounds(want, yf))
    np.testing.assert_array_equal(edited.pool_scores(), fresh.pool_scores())


def test_cold_append_bitwise_matches_fresh_engine():
    full = _mkpool(34, seed=5)  # 24 -> 34 crosses a C=8 chunk boundary
    yf = _yfun(full)
    init = [1, 9, 20]
    grown = et.BOEngine(full[:24], pool_chunk=8, device="cpu", **GP)
    np.testing.assert_array_equal(grown.pool_append(full[24:]),
                                  np.arange(24, 34))
    grown.observe(init, yf(init))
    fresh = et.BOEngine(full, pool_chunk=8, device="cpu", **GP)
    fresh.observe(init, yf(init))
    want = ej.BOEngine(jnp.asarray(full[:24]), pool_chunk=8, **GP)
    want.pool_append(full[24:])
    want.observe(init, yf(init))
    got = _run_rounds(grown, yf)
    np.testing.assert_array_equal(got, _run_rounds(fresh, yf))
    np.testing.assert_array_equal(got, _run_rounds(want, yf))


def test_cold_replace_batched_bitwise():
    base = _mkpool(20, seed=6)
    final = _stack(base)                            # [S=2, N, d]
    victims = np.asarray([0, 10, 19])
    start = final.copy()
    start[:, victims] = _mkpool(3, seed=7) + 4.0
    yf = _yfun(final[0])
    init = [3, 12]
    engs = {}
    for name, pool, j in (("edited", start, False), ("fresh", final, False),
                          ("jax", start, True)):
        eng = _make("BatchedBOEngine", pool, j, pool_chunk=8)
        if pool is start:
            eng.pool_replace(victims, final[:, victims])
        _observe(eng, init, yf)
        engs[name] = eng
    got = _run_rounds(engs["edited"], yf)
    np.testing.assert_array_equal(got, _run_rounds(engs["fresh"], yf))
    np.testing.assert_array_equal(got, _run_rounds(engs["jax"], yf))
    np.testing.assert_array_equal(engs["edited"].pool_scores(),
                                  engs["fresh"].pool_scores())


# -------------------------------------------------------------- refusals
def _error(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_pool_replace_validation_matches_live_jax():
    """The same refusals with the reference's texts, both engines (a fleet
    refuses a row any scenario has evaluated)."""
    yf = _yfun(_mkpool(16))
    engs = [_make("BOEngine", _mkpool(16), j) for j in (True, False)]
    for eng in engs:
        eng.observe([2, 5], yf([2, 5]))
    one = _mkpool(1, seed=9)
    for call, match in (
            (lambda e: e.pool_replace([5], one), "evaluated"),
            (lambda e: e.pool_replace([3, 3], _mkpool(2, seed=9)),
             "duplicate"),
            (lambda e: e.pool_replace([16], one), r"in \[0, 16\)"),
            (lambda e: e.pool_replace([3], _mkpool(1, d=3, seed=9)),
             "expected columns"),
            (lambda e: e.pool_replace([3], _mkpool(2, seed=9)),
             "1 rows but 2"),
            (lambda e: e.pool_append(_mkpool(2, d=4, seed=9)),
             "expected columns")):
        want, got = (_error(lambda: call(e)) for e in engs)
        assert got == want
        assert re.search(match, got)
    pools = np.stack([_mkpool(16), _mkpool(16, seed=1)])
    bengs = [_make("BatchedBOEngine", pools, j) for j in (True, False)]
    for beng in bengs:
        beng.observe([[4], []], [yf([4]), None])
    msgs = [_error(lambda: b.pool_replace([4], np.stack([one] * 2)))
            for b in bengs]
    assert msgs[0] == msgs[1] and "evaluated" in msgs[1]
    msgs = [_error(lambda: b.pool_replace([3], one)) for b in bengs]
    assert msgs[0] == msgs[1] and "[S, k, d]" in msgs[1]


# --------------------------------------------- warm edits: dirty V chunks
@pytest.mark.parametrize("cls_name", list(ENGINES))
def test_warm_edits_refresh_only_dirty_chunks(cls_name):
    """After a round, a replace inside one chunk refreshes that chunk, row 0
    also the pad chunk, an append the tail and the new chunks: the counts
    equal the reference's, and the next rounds pick what it picks."""
    mk = ENGINES[cls_name]
    pool = _mkpool(30, seed=10)  # C=8 -> 4 chunks, pad in the last
    yf = _yfun(pool)
    counts, picks = [], []
    for j in (True, False):
        eng = _make(cls_name, mk(pool), j, pool_chunk=8)
        _observe(eng, [1, 4, 22], yf)
        _run_rounds(eng, yf, rounds=1)
        before = eng.stats.v_chunk_refreshes
        eng.pool_replace([9, 10], _cols(cls_name, _mkpool(2, seed=11)))
        c = [eng.stats.v_chunk_refreshes - before]
        eng.pool_replace([0], _cols(cls_name, _mkpool(1, seed=12)))
        c.append(eng.stats.v_chunk_refreshes - before)
        eng.pool_append(_cols(cls_name, _mkpool(5, seed=13)))  # chunks 3, 4
        c.append(eng.stats.v_chunk_refreshes - before)
        counts.append(c)
        picks.append(_run_rounds(eng, _yfun(np.concatenate(
            [pool, _mkpool(5, seed=13)])), rounds=2, seed=13))
    assert counts[1] == counts[0] == [1, 3, 5]
    np.testing.assert_array_equal(picks[1], picks[0])


@pytest.mark.parametrize("cls_name", list(ENGINES))
def test_refreshed_chunk_is_bitwise_a_full_refactor(cls_name):
    """A warm replace's refreshed chunks hold, in every row, exactly what a
    full plain-K4 refactor (s0 = 0 over every chunk) under the same state
    gives."""
    mk = ENGINES[cls_name]
    pool = _mkpool(30, seed=14)
    pool[0] = pool[2] + 1e-3  # beside an evaluated row: never picked
    yf = _yfun(pool)
    eng = _make(cls_name, mk(pool), False, pool_chunk=8)
    _observe(eng, [2, 6, 19], yf)
    _run_rounds(eng, yf, rounds=2)
    rows = _unevaluated(eng, (0, 12, 13, 14))[:2]
    V_before = eng._state.V.clone()
    eng.pool_replace(rows, _cols(cls_name, _mkpool(2, seed=15)))
    # each row's chunk, and the pad chunk when row 0 changed (the
    # sequential run keeps row 0 unevaluated; the fleet's picks it)
    dirty = sorted({r // 8 for r in rows} | ({3} if 0 in rows else set()))
    assert (0 in rows) == (cls_name == "BOEngine")
    clean = [j for j in range(4) if j not in dirty]
    for si in eng._scenarios():
        a = eng._frozen_args(si)
        full = a["V"].clone()
        K4.round_select_plain(*(a[k] if k != "V" else full
                                for k in et._K4_ARGS), s0=0)
        assert torch.equal(a["V"][dirty], full[dirty])
        before = V_before if si is None else V_before[si]
        assert torch.equal(a["V"][clean], before[clean])


# ---------------------------------------------------------- pool_scores
@pytest.mark.parametrize("cls_name", list(ENGINES))
def test_pool_scores_match_live_jax(cls_name):
    """The scores of the last round's frozen state: the reference's within
    rtol = atol = 1e-4, -inf on the same (evaluated) columns, after a warm
    replace too; the port's are bitwise the same after a snapshot."""
    mk = ENGINES[cls_name]
    pool = _mkpool(24, seed=19)
    yf = _yfun(pool)
    engs = []
    for j in (True, False):
        eng = _make(cls_name, mk(pool), j, pool_chunk=8)
        _observe(eng, [1, 2, 9], yf)
        _run_rounds(eng, yf, rounds=2)
        engs.append(eng)
    for step in range(2):
        want, got = (np.asarray(e.pool_scores()) for e in engs)
        assert got.shape == want.shape == mk(np.zeros(24)).shape
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        live = np.isfinite(want)
        assert np.isfinite(got[live]).all() and live.sum() > 10
        np.testing.assert_allclose(got[live], want[live], rtol=1e-4,
                                   atol=1e-4)
        for e in engs:
            e.pool_replace([3, 20], _cols(cls_name, _mkpool(2, seed=20)))
    teng = engs[1]
    twin = _make(cls_name, teng.pool.numpy(), False, pool_chunk=8)
    twin.load_state_dict(teng.state_dict())
    np.testing.assert_array_equal(twin.pool_scores(), teng.pool_scores())


def test_pool_scores_contract():
    pool = _mkpool(24, seed=19)
    yf = _yfun(pool)
    msgs = []
    for j in (True, False):
        exact = _make("BOEngine", pool, j, incremental=False)
        exact.observe([1, 2], yf([1, 2]))
        eng = _make("BOEngine", pool, j)
        eng.observe([1, 2, 9], yf([1, 2, 9]))
        for e in (exact, eng):
            with pytest.raises(RuntimeError) as info:
                e.pool_scores()
            msgs.append(str(info.value))
    assert msgs[:2] == msgs[2:]
    assert "incremental" in msgs[2] and "completed round" in msgs[3]


# -------------------------------------------------------------- snapshots
@pytest.mark.parametrize("cls_name", list(ENGINES))
def test_warm_edit_checkpoint_roundtrip_bitwise(cls_name):
    """Snapshot an engine after warm pool edits; a fresh engine on the
    edited pool restores it bit-exactly and continues identically."""
    mk = ENGINES[cls_name]
    pool = _mkpool(28, seed=14)
    yf = _yfun(pool)
    eng = _make(cls_name, mk(pool), False, pool_chunk=8)
    _observe(eng, [2, 6, 19], yf)
    _run_rounds(eng, yf, rounds=1)
    eng.pool_replace([3, 11], _cols(cls_name, _mkpool(2, seed=15)))
    snap = eng.state_dict()
    assert snap["pool_edit"]["C"] == 8
    twin = _make(cls_name, eng.pool.numpy(), False, pool_chunk=8)
    twin.load_state_dict(snap)
    np.testing.assert_array_equal(twin.candidate_ids, eng.candidate_ids)
    np.testing.assert_array_equal(twin.pool_scores(), eng.pool_scores())
    np.testing.assert_array_equal(_run_rounds(eng, yf, seed=16),
                                  _run_rounds(twin, yf, seed=16))


def test_edited_snapshot_refuses_mismatched_pool():
    pool = _mkpool(16, seed=17)
    msgs = []
    for j in (True, False):
        eng = _make("BOEngine", pool, j)
        eng.pool_replace([3], _mkpool(1, seed=18))
        snap = eng.state_dict()
        if not j:
            snap = convert.engine_state_from_numpy(snap)
        other = _make("BOEngine", pool, j)  # the un-edited pool
        msgs.append(_error(lambda: other.load_state_dict(snap)))
    assert msgs[0] == msgs[1] and "pool content does not match" in msgs[1]


@pytest.mark.parametrize("cls_name", list(ENGINES))
def test_jax_edited_snapshot_continues_in_the_port(cls_name):
    """A JAX engine's snapshot taken after warm edits (and an append that
    grows the chunk grid), loaded through ``convert`` into a port engine on
    the JAX engine's live pool, picks what the JAX engine picks next."""
    mk = ENGINES[cls_name]
    pool = _mkpool(30, seed=21)
    yf = _yfun(np.concatenate([pool, _mkpool(3, seed=23)]))
    jeng = _make(cls_name, mk(pool), True, pool_chunk=8)
    _observe(jeng, [2, 6, 19], yf)
    _run_rounds(jeng, yf, rounds=2)
    jeng.pool_replace(_unevaluated(jeng, (0, 11, 12, 13, 1))[:2],
                      _cols(cls_name, _mkpool(2, seed=22)))
    jeng.pool_append(_cols(cls_name, _mkpool(3, seed=23)))
    snap = convert.engine_state_from_numpy(jeng.state_dict())
    assert snap["pool_edit"]["ids"].dtype == np.int64
    teng = _make(cls_name, np.asarray(jeng.pool), False, pool_chunk=8)
    teng.load_state_dict(snap)
    np.testing.assert_array_equal(teng.candidate_ids, jeng.candidate_ids)
    assert teng.stats.v_chunk_refreshes == jeng.stats.v_chunk_refreshes
    np.testing.assert_array_equal(_run_rounds(teng, yf, seed=24),
                                  _run_rounds(jeng, yf, seed=24))


def test_engine_stats_fold_into_a_duck_typed_registry():
    stats = et.EngineStats(rounds=4, refactors=1, pool_replacements=3,
                           v_chunk_refreshes=2,
                           stage_wall_s={"fit": 0.5, "round_fused": 0.25})
    regs = []
    for st in (stats, ej.EngineStats(**stats.as_dict())):
        reg = _Registry()
        st.fold_into(reg)
        regs.append(reg.vals)
    assert regs[0] == regs[1]
    assert regs[0][("engine_pool_replacements_total", ())] == 3
    assert regs[0][("engine_stage_seconds_total", (("stage", "fit"),))] == 0.5
    assert ("engine_pool_appends_total", ()) not in regs[0]  # zero: nothing


class _Registry:
    """Anything with ``counter(name, help).inc(v, **labels)``."""

    def __init__(self):
        self.vals = {}

    def counter(self, name, help=""):
        reg = self

        class _C:
            def inc(self, v=1, **labels):
                key = (name, tuple(sorted(labels.items())))
                reg.vals[key] = reg.vals.get(key, 0) + v

        return _C()

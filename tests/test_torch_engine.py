"""The port's incremental BOEngine against the live JAX package on the CPU.

Helpers are held against their JAX twins on numpy inputs (float32 ulps
apart: a triangular solve there, a row-by-row substitution here); whole
engines are driven side by side with the same normals (the reference's
``split(key, m)`` / ``normal(k, (q, s))`` schedule, handed to the port as
``eps``), and their picks and refactor decisions must be equal.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import engine as ej
from repro.core.gp import GPParams as GPParamsJ
from repro_torch import convert
from repro_torch.core import engine as et
from repro_torch.core.gp import GPParams
from repro_torch.kernels import round_fused as K4


def _eps(key, m, q, s=10):
    """The normals the reference's ``_frontier_ystar`` draws from ``key``."""
    return np.stack([np.asarray(jax.random.normal(k, (q, s)))
                     for k in jax.random.split(key, m)])


def _params(rng, m, d):
    return dict(log_ls=(0.3 * rng.normal(size=(m, d))).astype(np.float32),
                log_var=(0.2 * rng.normal(size=(m,))).astype(np.float32),
                log_noise=(-4.0 + 0.3 * rng.normal(size=(m,))).astype(np.float32))


def _both(p):
    return (GPParamsJ(*(jnp.asarray(p[k]) for k in ("log_ls", "log_var", "log_noise"))),
            GPParams(*(torch.tensor(p[k]) for k in ("log_ls", "log_var", "log_noise"))))


def _train_set(rng, P, n, d):
    """Padded training rows as the engine builds them (+10 on pad rows)."""
    mask = np.concatenate([np.zeros(n), np.ones(P - n)]).astype(np.float32)
    x = (0.4 * rng.normal(size=(P, d)) + 10.0 * mask[:, None]).astype(np.float32)
    return x, mask


def test_chol_block_matches_jax():
    rng = np.random.default_rng(0)
    m, d, P, s0 = 3, 5, 24, 16
    pj, pt = _both(_params(rng, m, d))
    x, mask = _train_set(rng, P, 19, d)
    x_old = x.copy()
    x_old[s0:] += 10.0  # the old trailing rows: pads, since replaced
    L_old = ej._chol_refactor(pj, jnp.asarray(x_old), jnp.asarray(mask))
    want = ej._chol_block(pj, L_old, jnp.asarray(x), jnp.asarray(mask), s0)
    got = et._chol_block(pt, torch.tensor(np.asarray(L_old)), torch.tensor(x),
                         torch.tensor(mask), s0)
    # float32 solves and Cholesky of two libraries; pad rows are ~1e3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)
    full = et._chol_refactor(pt, torch.tensor(x), torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5, atol=5e-4)


@pytest.mark.parametrize("s0", [0, 8, 24])
def test_v_update_matches_jax_v_chunk_block(s0):
    """K4's plain V update (the port's twin of ``_v_chunk_refactor`` and
    ``_v_chunk_block``) on one chunk."""
    rng = np.random.default_rng(1 + s0)
    m, d, P, C = 3, 5, 24, 37
    pj, pt = _both(_params(rng, m, d))
    x, mask = _train_set(rng, P, 20, d)
    pc = (0.4 * rng.normal(size=(C, d))).astype(np.float32)
    L = ej._chol_refactor(pj, jnp.asarray(x), jnp.asarray(mask))
    Vc = ej._v_chunk_refactor(pj, L, jnp.asarray(x), jnp.asarray(pc))
    Lt = torch.tensor(np.asarray(L))

    def update(V, s):
        return K4.v_update_plain(torch.exp(pt.log_ls), torch.exp(pt.log_var),
                                 Lt, V[None], torch.tensor(x),
                                 torch.tensor(pc)[None], s)[0]

    got0 = update(torch.zeros((m, P, C)), 0)
    np.testing.assert_allclose(got0.numpy(), np.asarray(Vc), rtol=2e-5,
                               atol=2e-5)
    want = (Vc if s0 >= P else
            ej._v_chunk_block(pj, L, Vc, jnp.asarray(x), jnp.asarray(pc), s0))
    got = update(torch.tensor(np.asarray(Vc)), s0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_col_moments_matches_jax():
    rng = np.random.default_rng(2)
    m, P, C = 3, 16, 50
    log_var = (0.2 * rng.normal(size=(m,))).astype(np.float32)
    beta = rng.normal(size=(m, P)).astype(np.float32)
    V = (0.2 * rng.normal(size=(m, P, C))).astype(np.float32)
    mu_j, sd_j = jax.vmap(ej._col_moments)(jnp.asarray(log_var),
                                           jnp.asarray(beta), jnp.asarray(V))
    mu_t, sd_t = et._col_moments(torch.tensor(log_var), torch.tensor(beta),
                                 torch.tensor(V))
    # the same sequential order on both sides: float32 ulps only
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(sd_t.numpy(), np.asarray(sd_j), rtol=1e-6,
                               atol=1e-6)


def test_frontier_ystar_matches_jax():
    rng = np.random.default_rng(3)
    m, d, P, q, s = 3, 5, 16, 40, 10
    pj, pt = _both(_params(rng, m, d))
    x, mask = _train_set(rng, P, 13, d)
    xq = (0.4 * rng.normal(size=(q, d))).astype(np.float32)
    yn = rng.normal(size=(P, m)).astype(np.float32)
    y_mean = np.linspace(-1, 1, m).astype(np.float32)
    y_std = np.linspace(0.5, 2, m).astype(np.float32)
    L = ej._chol_refactor(pj, jnp.asarray(x), jnp.asarray(mask))
    beta = ej._train_beta(L, jnp.asarray(yn))
    key = jax.random.PRNGKey(4)
    want = ej._frontier_ystar(pj, L, beta, jnp.asarray(x), jnp.asarray(xq),
                              jnp.asarray(y_mean), jnp.asarray(y_std), key, s)
    Lt = torch.tensor(np.asarray(L))
    bt = et._train_beta(Lt, torch.tensor(yn))
    np.testing.assert_allclose(bt.numpy(), np.asarray(beta), rtol=1e-5,
                               atol=1e-5)
    got = et._frontier_ystar(pt, Lt, bt, torch.tensor(x), torch.tensor(xq),
                             torch.tensor(y_mean), torch.tensor(y_std),
                             torch.tensor(_eps(key, m, q, s)))
    # a q x q Cholesky of a near-singular posterior covariance (jitter
    # 1e-4·var) in two libraries: 1e-4 absolute on O(1) maxima
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_padded_batch_equal():
    y = np.random.default_rng(5).random((5, 3)).astype(np.float32)
    for P in (5, 8, 16):
        got = et.BOEngine._padded_batch([4, 1, 7, 2, 9], y, P)
        want = ej.BOEngine._padded_batch([4, 1, 7, 2, 9], y, P)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- engine runs
def _pool(n, d=5, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _flow(pool, m=3):
    W = np.random.default_rng(99).normal(size=(pool.shape[1], m))

    def f(rows):
        x = pool[np.asarray(rows)]
        return (np.tanh(x @ W)
                + 0.1 * np.sin(x.sum(1))[:, None]).astype(np.float32)

    return f


KW = dict(incremental=True, gp_steps=25, warm_steps=5, drift_tol=5.0)


def _drive(pool, *, rounds, q=0, n_init=12, seed=3, jax_engine=False,
           sub_step=1, fantasy="mean", pending=(), **kw):
    """One incremental engine (the port's, or the JAX package's) driven with
    the reference key schedule; returns (picks, engine)."""
    f = _flow(pool)
    kw = {**KW, **kw}
    eng = (ej.BOEngine(pool, **kw) if jax_engine
           else et.BOEngine(pool, device="cpu", **kw))
    init = list(range(n_init))
    eng.observe(init, f(init))
    key = jax.random.PRNGKey(seed)
    sub = np.arange(0, pool.shape[0], sub_step, dtype=np.int32)
    picks = []

    def arg(k):
        return k if jax_engine else _eps(k, 3, len(sub))

    for _ in range(rounds):
        key, k = jax.random.split(key)
        nxt = eng.select(arg(k), sub_rows=sub)
        picks.append(int(nxt))
        eng.observe([nxt], f([nxt]))
    if q:
        key, k = jax.random.split(key)
        picks.append([int(r) for r in eng.select_q(
            arg(k), q=q, sub_rows=sub, fantasy=fantasy, pending=pending)])
    return picks, eng


@pytest.mark.parametrize("pool_chunk", [None, 7])
def test_engine_picks_and_decisions_equal_live_jax(pool_chunk):
    """6 rounds across a bucket growth (P 16 -> 24: refactors and block
    updates), then one fantasy q-batch of 2, against the JAX engine."""
    pool = _pool(48, seed=48)
    pool[41] = pool[37] = pool[5]   # exact ties across chunk boundaries
    want, ej_eng = _drive(pool, rounds=6, q=2, jax_engine=True,
                          pool_chunk=pool_chunk)
    got, et_eng = _drive(pool, rounds=6, q=2, pool_chunk=pool_chunk)
    assert got == want
    keys = ("rounds", "refactors", "block_updates", "dispatches",
            "fantasy_steps", "frontier_resamples")
    assert {k: getattr(et_eng.stats, k) for k in keys} == \
        {k: getattr(ej_eng.stats, k) for k in keys}
    assert et_eng.stats.refactors >= 2 and et_eng.stats.block_updates >= 1
    assert et_eng.device_bytes() == ej_eng.device_bytes()


@pytest.mark.parametrize("fantasy", ["cl_min", "cl_max"])
def test_liar_fantasies_with_pending_rows_equal_live_jax(fantasy):
    """Constant-liar imputation, with an in-flight row fantasized first."""
    pool = _pool(40, seed=10)
    want, _ = _drive(pool, rounds=2, q=2, jax_engine=True, fantasy=fantasy,
                     pending=[30])
    got, eng = _drive(pool, rounds=2, q=2, fantasy=fantasy, pending=[30])
    assert got == want and 30 not in got[-1]
    assert eng.stats.fantasy_steps == 2


def test_block_updates_stay_exact_over_ten_rounds():
    pool = _pool(64, seed=6)
    f = _flow(pool)
    eng = et.BOEngine(pool, gp_steps=40, warm_steps=5, drift_tol=5.0,
                      device="cpu")
    eng.observe(list(range(12)), f(list(range(12))))
    key = jax.random.PRNGKey(5)
    for _ in range(10):
        key, k = jax.random.split(key)
        nxt = eng.select(_eps(k, 3, 64))
        assert eng.refactor_residual() < 5e-4
        eng.observe([nxt], f([nxt]))
    assert eng.stats.block_updates > 0 and eng.stats.refactors >= 1
    assert eng.stats.rounds == 10


def test_picks_do_not_depend_on_the_chunk_size():
    pool = _pool(64)
    ref, eng = _drive(pool, rounds=9, q=2, sub_step=2, gp_steps=30)
    assert eng.stats.block_updates > 0 and eng.stats.refactors >= 1
    for chunk in (7, 64, 100):
        got, _ = _drive(pool, rounds=9, q=2, sub_step=2, gp_steps=30,
                        pool_chunk=chunk)
        assert got == ref, f"pool_chunk={chunk} diverged: {got} != {ref}"


def test_chunked_ties_keep_the_first_index():
    pool = _pool(48, seed=2)
    pool[37] = pool[5]   # tie pair across the chunk-8 boundary
    pool[41] = pool[5]   # three-way tie
    f = _flow(pool)

    def picks_for(chunk):
        eng = et.BOEngine(pool, pool_chunk=chunk, device="cpu", **KW)
        eng.observe(list(range(10, 20)), f(list(range(10, 20))))
        key = jax.random.PRNGKey(0)
        out = []
        for _ in range(4):
            key, k = jax.random.split(key)
            nxt = eng.select(_eps(k, 3, 48))
            out.append(nxt)
            eng.observe([nxt], f([nxt]))
        return out

    ref = picks_for(None)
    assert picks_for(8) == ref
    tied = [p for p in ref if p in (5, 37, 41)]
    if tied:
        assert tied[0] == 5 and tied == sorted(tied)


def test_state_dict_roundtrip_is_bit_exact_and_a_copy():
    pool = _pool(24, d=4, seed=7)
    f = _flow(pool)
    kw = dict(gp_steps=6, warm_steps=3, bucket=4, device="cpu")
    eng = et.BOEngine(pool, **kw)
    eng.observe(list(range(7)), f(list(range(7))))
    key = jax.random.PRNGKey(1)
    first = eng.select(_eps(key, 3, 24))
    eng.observe([first], f([first]))
    sd = eng.state_dict()
    frozen = {k: v.copy() for k, v in sd["state"].items()
              if isinstance(v, np.ndarray)}
    restored = et.BOEngine(pool, **kw)
    restored.load_state_dict(sd)
    e2 = _eps(jax.random.fold_in(key, 1), 3, 24)
    assert restored.select(e2) == eng.select(e2)
    sd_a, sd_b = eng.state_dict(), restored.state_dict()
    for k in ("L", "V"):
        np.testing.assert_array_equal(sd_a["state"][k], sd_b["state"][k])
        # the first snapshot did not move with the live state
        np.testing.assert_array_equal(sd["state"][k], frozen[k])
    np.testing.assert_array_equal(sd_a["rows"], sd_b["rows"])
    np.testing.assert_array_equal(sd_a["y"], sd_b["y"])
    eng.release()
    assert eng.device_bytes() == 0
    with pytest.raises(RuntimeError, match="released"):
        eng.state_dict()


def test_jax_state_dict_continues_in_the_port():
    """A JAX engine's snapshot, loaded through ``convert``, gives the JAX
    engine's next pick."""
    pool = _pool(40, seed=8)
    _, jeng = _drive(pool, rounds=3, jax_engine=True)
    teng = et.BOEngine(pool, device="cpu", **KW)
    teng.load_state_dict(convert.engine_state_from_numpy(jeng.state_dict()))
    key = jax.random.PRNGKey(11)
    sub = np.arange(40, dtype=np.int32)
    assert teng.select(_eps(key, 3, 40), sub_rows=sub) == \
        int(jeng.select(key, sub_rows=sub))
    assert teng.stats.rounds == jeng.stats.rounds


def test_engine_knob_errors():
    pool = _pool(16)
    with pytest.raises(ValueError, match="pool_chunk requires"):
        et.BOEngine(pool, incremental=False, pool_chunk=4, device="cpu")
    with pytest.raises(ValueError, match="profile_stages requires"):
        et.BOEngine(pool, incremental=False, profile_stages=True, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        et.BOEngine(pool, pool_chunk=0, device="cpu")
    assert et.auto_chunk(100) == 100 and et.auto_chunk(10**6) == 21845
    eng = et.BOEngine(pool, device="cpu", **KW)
    eng.observe([0, 1, 2], _flow(pool)([0, 1, 2]))
    with pytest.raises(ValueError, match="fantasy must be"):
        eng.select_q(_eps(jax.random.PRNGKey(0), 3, 16), q=2, fantasy="x")
    with pytest.raises(ValueError, match="too few"):
        eng.select_q(_eps(jax.random.PRNGKey(0), 3, 16), q=14)


def test_profile_stages_pick_what_the_fused_round_picks():
    pool = _pool(40, seed=9)
    ref, _ = _drive(pool, rounds=4, q=2)
    got, eng = _drive(pool, rounds=4, q=2, profile_stages=True)
    assert got == ref
    acc = eng.stats.stage_wall_s
    assert set(acc) == set(et.PROFILE_STAGES) | {"round_total"}
    assert sum(acc[k] for k in et.PROFILE_STAGES) <= acc["round_total"]

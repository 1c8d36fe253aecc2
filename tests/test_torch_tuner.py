"""The port's ``soc_tuner`` against the live JAX package at the
``soc_tuner_exact`` and ``soc_tuner_incremental`` golden configurations
(``tools/regen_golden.py``).

The pool comes from JAX. :class:`JaxKeyDraws` replays the reference's key
schedule with ``jax.random`` through the port's draws protocol, so both runs
see the same trial rows, frontier subsets and normals; the pick sequences
must then be equal.
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

from repro.core import make_space as make_space_j
from repro.core import soc_tuner as soc_tuner_j
from repro.core.pareto import pareto_mask
from repro.core.tuner import frontier_subset_rows
from repro.core.tuner import merge_trial_evals as merge_trial_evals_j
from repro.soc import VLSIFlow as VLSIFlowJ
from repro_torch.core import BOEngine, make_space, soc_tuner
from repro_torch.core.tuner import merge_trial_evals
from repro_torch.soc import VLSIFlow

_TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools",
                      "regen_golden.py")
_spec = importlib.util.spec_from_file_location("regen_golden", _TOOLS)
regen_golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(regen_golden)

CASE = regen_golden.CASES["soc_tuner_exact"]
CASE_INC = regen_golden.CASES["soc_tuner_incremental"]


class JaxKeyDraws:
    """``repro.core.tuner.soc_tuner``'s key schedule as a ``TunerDraws``:
    ``split(key, 3)`` for the ICD trials, ``split(key, 4)`` per round, one
    key per objective for the joint-sample normals (``gp_joint_samples``)."""

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


@pytest.fixture(scope="module")
def golden_pool():
    space = make_space_j()
    pool = np.asarray(space.sample(jax.random.PRNGKey(regen_golden.POOL_SEED),
                                   regen_golden.N_POOL))
    y = np.asarray(VLSIFlowJ(space, CASE["workload"])(pool))
    ref = y[np.asarray(pareto_mask(jnp.asarray(y.astype(np.float64))))]
    return pool, ref


@pytest.mark.parametrize("seed", [CASE["seed"], 5])
def test_exact_tuner_picks_equal_live_jax(golden_pool, seed):
    pool, ref = golden_pool
    assert CASE["driver"] == "soc_tuner" and not CASE["incremental"]
    kw = dict(regen_golden.RUN_KW)
    flow_j = VLSIFlowJ(make_space_j(), CASE["workload"])
    want = soc_tuner_j(make_space_j(), pool, flow_j,
                       key=jax.random.PRNGKey(seed), reference_front=ref, **kw)
    flow = VLSIFlow(make_space(), CASE["workload"], device="cpu")
    got = soc_tuner(make_space(), pool, flow,
                    draws=JaxKeyDraws(jax.random.PRNGKey(seed)),
                    reference_front=ref, device="cpu", **kw)
    np.testing.assert_array_equal(got.evaluated_rows, want.evaluated_rows)
    # metrics come from two float32 SoC models (ulps apart), the rest is
    # float64: the final ADRS agrees to well under 1e-5 relative
    assert got.history[-1]["adrs"] == pytest.approx(want.history[-1]["adrs"],
                                                     rel=1e-5)
    assert [h["pareto_size"] for h in got.history] == \
        [h["pareto_size"] for h in want.history]
    np.testing.assert_allclose(got.v, want.v, rtol=1e-5, atol=1e-7)
    assert got.space.pinned == want.space.pinned
    np.testing.assert_array_equal(got.pareto_rows, want.pareto_rows)
    assert (flow.calls, flow.evaluated) == (flow_j.calls, flow_j.evaluated)
    # the port keeps the counters of the code it has; the reference's others
    # (batched engine, pool edits) stay 0 on this path
    assert got.engine_stats == {k: want.engine_stats[k]
                                for k in got.engine_stats}
    assert not any(v for k, v in want.engine_stats.items()
                   if k not in got.engine_stats)
    assert got.engine_stats["dispatches"] == 5 * kw["T"]


def _run_both(pool, ref, seed, **extra):
    kw = dict(regen_golden.RUN_KW, **extra)
    flow_j = VLSIFlowJ(make_space_j(), CASE_INC["workload"])
    want = soc_tuner_j(make_space_j(), pool, flow_j,
                       key=jax.random.PRNGKey(seed), reference_front=ref, **kw)
    flow = VLSIFlow(make_space(), CASE_INC["workload"], device="cpu")
    got = soc_tuner(make_space(), pool, flow,
                    draws=JaxKeyDraws(jax.random.PRNGKey(seed)),
                    reference_front=ref, device="cpu", **kw)
    assert (flow.calls, flow.evaluated) == (flow_j.calls, flow_j.evaluated)
    return got, want


@pytest.mark.parametrize("seed", [CASE_INC["seed"], 5])
def test_incremental_tuner_picks_equal_live_jax(golden_pool, seed):
    pool, ref = golden_pool
    assert CASE_INC["driver"] == "soc_tuner" and CASE_INC["incremental"]
    got, want = _run_both(pool, ref, seed, incremental=True)
    np.testing.assert_array_equal(got.evaluated_rows, want.evaluated_rows)
    # metrics from two float32 SoC models (ulps apart), the rest float64
    assert got.history[-1]["adrs"] == pytest.approx(want.history[-1]["adrs"],
                                                     rel=1e-5)
    keys = ("rounds", "refactors", "block_updates", "dispatches",
            "frontier_resamples")
    assert {k: got.engine_stats[k] for k in keys} == \
        {k: want.engine_stats[k] for k in keys}


def test_incremental_q2_tuner_picks_equal_live_jax(golden_pool):
    pool, ref = golden_pool
    got, want = _run_both(pool, ref, CASE_INC["seed"], incremental=True, q=2,
                          T=3)
    np.testing.assert_array_equal(got.evaluated_rows, want.evaluated_rows)
    assert got.engine_stats["fantasy_steps"] == \
        want.engine_stats["fantasy_steps"] == 3
    assert got.history[-1]["adrs"] == pytest.approx(want.history[-1]["adrs"],
                                                     rel=1e-5)


def test_merge_trial_evals_equal():
    y_init = np.arange(6, dtype=np.float32).reshape(2, 3)
    trial_y = np.arange(12, dtype=np.float32).reshape(4, 3) + 100
    for reuse in (True, False):
        got = merge_trial_evals([5, 2], y_init, np.array([2, 7, 7, 1]),
                                trial_y, reuse)
        want = merge_trial_evals_j([5, 2], y_init, np.array([2, 7, 7, 1]),
                                   trial_y, reuse)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("kw", [dict(checkpoint_dir="ckpt"),
                                dict(proposer=True)])
def test_unported_options_raise(kw, tmp_path):
    """Both knobs are ported (ROADMAP item 11 and item 12's checkpoint
    part): ``checkpoint_dir`` writes a snapshot a round, and the proposer
    on the exact engine raises ValueError, as the reference does, before
    any flow budget is spent."""
    space = make_space()
    pool = space.sample(torch.Generator().manual_seed(0), 16).numpy()
    flow = VLSIFlow(space, device="cpu")
    if "proposer" in kw:
        with pytest.raises(ValueError, match="requires incremental=True"):
            soc_tuner(space, pool, flow, T=1, n=4, b=2, device="cpu", **kw)
        assert flow.calls == 0  # checked before any flow budget is spent
        return
    d = str(tmp_path / kw["checkpoint_dir"])
    res = soc_tuner(space, pool, flow, T=1, n=4, b=2, device="cpu",
                    checkpoint_dir=d)
    assert res.engine_stats["rounds"] == 1
    assert os.listdir(d) == ["ckpt_000001.npz"]


def test_q_batches_need_the_incremental_engine():
    space = make_space()
    pool = space.sample(torch.Generator().manual_seed(0), 16).numpy()
    flow = VLSIFlow(space, device="cpu")
    with pytest.raises(ValueError, match="requires incremental=True"):
        soc_tuner(space, pool, flow, T=1, n=4, b=2, q=2, device="cpu")
    assert flow.calls == 0


def test_engine_rejects_incremental_and_q_batches(monkeypatch):
    pool = torch.rand(10, 4)
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BOEngine(pool)  # the default device is cuda
    eng = BOEngine(pool, incremental=False, gp_steps=2, device="cpu")
    with pytest.raises(RuntimeError, match="before observe"):
        eng.select(torch.zeros(3, 10, 2))
    eng.observe([0, 1, 2], np.random.default_rng(0).random((3, 3)))
    with pytest.raises(ValueError, match="requires incremental=True"):
        eng.select_q(torch.zeros(3, 10, 2), q=2)
    pick = eng.select(torch.zeros(3, 10, 2))
    assert pick not in (0, 1, 2) and eng.stats.rounds == 1

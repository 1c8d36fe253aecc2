"""The port's §IV baselines (``repro_torch.core.baselines``) against the
live JAX package on the CPU.

Both sides run at ``tests/conftest.py``'s 256-row ``small_pool`` with
T 4 and b 6, for keys 0 and 1. :class:`KeyDraws` hands the port the
reference's numpy seed (``jax.random.randint`` of the unsplit key) and, for
``icd``, the reference's ``space.sample(key, n)``, so both sides make the
same draws. The evaluated rows are discrete and must be equal; metrics and
ADRS are float32 from two frameworks.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import numpy as np

from repro.core import run_baseline as run_baseline_j
from repro.core.pareto import pareto_front as pareto_front_j
from repro.core.space import TABLE_I as TABLE_I_J
from repro.core.space import DesignSpace as DesignSpaceJ
from repro.soc import VLSIFlow as VLSIFlowJ
from repro_torch.core import BASELINES, make_space, run_baseline
from repro_torch.random import GeneratorDraws
from repro_torch.soc import VLSIFlow
from test_torch_propose import JaxKeyDraws  # noqa: E402

#: metrics: float32 cost model, sums over layers in another order
RTOL_Y = 1e-5
#: ADRS: float64 over those metrics
RTOL_ADRS = 1e-5


class KeyDraws(JaxKeyDraws):
    """:class:`JaxKeyDraws` plus the draws of ``icd`` and the baselines,
    each from the unsplit key as the reference draws them."""

    def designs(self, space, n):
        return np.asarray(DesignSpaceJ(TABLE_I_J, space.pinned).sample(
            self.key, n))

    def baseline_seed(self):
        return int(jax.random.randint(self.key, (), 0, 2**31 - 1))


@pytest.fixture(scope="module")
def ref_front(space, small_pool):
    return pareto_front_j(VLSIFlowJ(space, "resnet50")(small_pool))


@pytest.mark.parametrize("key", [0, 1])
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_matches_reference(name, key, space, small_pool, ref_front):
    flow_j = VLSIFlowJ(space, "resnet50")
    want = run_baseline_j(name, space, small_pool, flow_j, T=4, b=6,
                          key=jax.random.PRNGKey(key),
                          reference_front=ref_front)
    flow = VLSIFlow(make_space(), "resnet50", device="cpu")
    got = run_baseline(name, make_space(), small_pool, flow, T=4, b=6,
                       draws=KeyDraws(jax.random.PRNGKey(key)),
                       reference_front=ref_front, device="cpu")
    np.testing.assert_array_equal(got.evaluated_rows, want.evaluated_rows)
    np.testing.assert_allclose(got.y, want.y, rtol=RTOL_Y)
    assert len(got.history) == len(want.history) == 4 + 1
    for h, w in zip(got.history, want.history):
        assert (h["round"], h["evaluations"], h["pareto_size"]) == \
            (w["round"], w["evaluations"], w["pareto_size"])
        np.testing.assert_allclose(h["adrs"], w["adrs"], rtol=RTOL_ADRS)
    np.testing.assert_array_equal(got.pareto_rows, want.pareto_rows)
    assert (flow.calls, flow.evaluated) == (flow_j.calls, flow_j.evaluated)
    assert flow.evaluated == len(set(got.evaluated_rows.tolist()))


def test_baseline_default_draws_and_errors(small_pool):
    """The default draws are ``GeneratorDraws(0, device)``; an unknown
    name raises before any evaluation."""
    space = make_space()
    a = run_baseline("random", space, small_pool,
                     VLSIFlow(space, device="cpu"), T=3, b=4, device="cpu")
    b = run_baseline("random", space, small_pool,
                     VLSIFlow(space, device="cpu"), T=3, b=4,
                     draws=GeneratorDraws(0, "cpu"), device="cpu")
    np.testing.assert_array_equal(a.evaluated_rows, b.evaluated_rows)
    assert len(set(a.evaluated_rows.tolist())) == 4 + 3
    flow = VLSIFlow(space, device="cpu")
    with pytest.raises(ValueError, match="unknown baseline"):
        run_baseline("annealing", space, small_pool, flow, T=2, b=3,
                     device="cpu")
    assert flow.calls == 0


def test_new_entry_points_need_the_card_unless_asked_for_the_cpu(
        monkeypatch, small_pool):
    from repro_torch.core import hypervolume, nondominated_sort
    from repro_torch.soc import SimplifiedFlow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    space = make_space()
    y = np.random.default_rng(0).random((6, 3))
    flow = VLSIFlow(space, device="cpu")
    for call in (lambda: run_baseline("random", space, small_pool, flow,
                                      T=1, b=2),
                 lambda: hypervolume(y, np.ones(3)),
                 lambda: nondominated_sort(y),
                 lambda: SimplifiedFlow(space)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert flow.calls == 0
    assert hypervolume(y, np.full(3, 2.0), device="cpu") > 0
    assert nondominated_sort(y, device="cpu").shape == (6,)

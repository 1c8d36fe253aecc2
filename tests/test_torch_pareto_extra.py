"""``hypervolume`` and ``nondominated_sort`` of the port against the live
JAX package on the CPU. Both decide dominance in float32 and sweep in
float64, in the same order, so hypervolumes agree to float64 rounding
(rtol 1e-12) and ranks are equal."""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import numpy as np

from repro.core import pareto as pj
from repro_torch.core import hypervolume, nondominated_sort

#: float64 sweeps over the same rows in the same order
RTOL_HV = 1e-12


def _front(seed, n, m):
    """A seeded front: ``n`` rows on a curved trade-off, a quarter of them
    duplicated, two rows beyond the reference point and a dominated row."""
    rng = np.random.default_rng(seed)
    u = rng.dirichlet(np.ones(m), size=n) ** 0.5
    f = np.vstack([u, u[: n // 4], u[:1] + 0.05, np.full((2, m), 1.5)])
    ref = np.full(m, 1.2)
    return rng.permutation(f), ref


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("seed,n", [(0, 5), (1, 12), (2, 24)])
def test_hypervolume_matches_reference(m, seed, n):
    f, ref = _front(seed, n, m)
    want = pj.hypervolume(f, ref)
    got = hypervolume(f, ref, device="cpu")
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=RTOL_HV, atol=0)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_hypervolume_edge_cases_match_reference(m):
    ref = np.ones(m)
    empty = np.zeros((0, m))
    beyond = np.full((3, m), 2.0)
    one = np.full((1, m), 0.25)
    for f in (empty, beyond, one, np.vstack([one, one, beyond])):
        want = pj.hypervolume(f, ref)
        got = hypervolume(f, ref, device="cpu")
        np.testing.assert_allclose(got, want, rtol=RTOL_HV, atol=0)
    assert hypervolume(empty, ref, device="cpu") == 0.0
    assert hypervolume(beyond, ref, device="cpu") == 0.0
    with pytest.raises(NotImplementedError):
        hypervolume(np.full((2, 4), 0.5), np.ones(4), device="cpu")


def test_hypervolume_of_an_ehvi_sample_matches_reference():
    """The baselines' use: a front plus one sampled point, the reference
    point 1.1 × the front's maxima (``_ehvi_scores``)."""
    rng = np.random.default_rng(7)
    y = rng.random((30, 3)) * np.array([5.0, 900.0, 3.0])
    front = y[np.asarray(pj.pareto_mask(y))]
    ref = front.max(axis=0) * 1.1 + 1e-9
    for s in rng.random((8, 3)) * np.array([5.0, 900.0, 3.0]):
        f = np.vstack([front, s[None]])
        np.testing.assert_allclose(hypervolume(f, ref, device="cpu"),
                                   pj.hypervolume(f, ref), rtol=RTOL_HV,
                                   atol=0)


@pytest.mark.parametrize("max_fronts", [32, 3, 1])
@pytest.mark.parametrize("n,m", [(1, 3), (50, 2), (160, 3)])
def test_nondominated_sort_matches_reference(n, m, max_fronts):
    rng = np.random.default_rng(n + m)
    y = np.round(rng.random((n, m)), 2)  # rounded: ties and duplicates
    want = pj.nondominated_sort(y, max_fronts=max_fronts)
    got = nondominated_sort(y, max_fronts=max_fronts, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.max() <= max_fronts


def test_nondominated_sort_of_no_rows():
    got = nondominated_sort(np.zeros((0, 3)), device="cpu")
    np.testing.assert_array_equal(got, pj.nondominated_sort(np.zeros((0, 3))))

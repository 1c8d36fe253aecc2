"""The ``pareto_count`` kernel's plain version, Pareto fronts and ADRS
against ``repro``'s (XLA form and Pallas kernel in interpret mode)."""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np

from repro.core import pareto as jpareto
from repro.kernels.backend import dominance_counts_xla
from repro.kernels.pareto_count import ops as pc_ops
from repro_torch.core import pareto as tpareto
from repro_torch.kernels import pareto_count as K3


def _metrics(seed, n, m, levels):
    """Metrics on a coarse grid (ties in every objective) plus duplicated
    rows."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, levels, (n, m)).astype(np.float32) / levels
    y[n // 2:n // 2 + n // 5] = y[:n // 5]
    return y


@pytest.mark.parametrize("n,m,levels", [(1, 3, 4), (5, 2, 3), (130, 3, 6),
                                        (257, 3, 50), (300, 2, 1000)])
def test_counts_equal_xla_and_pallas(n, m, levels):
    y = _metrics(n + m, n, m, levels)
    got = K3.dominance_counts(torch.from_numpy(y))
    assert got.dtype == torch.int32 and got.shape == (n,)
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(dominance_counts_xla(jnp.asarray(y))))
    np.testing.assert_array_equal(got, np.asarray(pc_ops.dominance_counts(jnp.asarray(y))))


def test_duplicates_dominate_nothing():
    y = torch.ones((150, 3))
    assert bool((K3.dominance_counts(y) == 0).all())


def test_pareto_front_and_mask_equal():
    y = _metrics(7, 400, 3, 40)
    mask = tpareto.pareto_mask(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(mask, np.asarray(jpareto.pareto_mask(jnp.asarray(y))))
    np.testing.assert_array_equal(tpareto.pareto_front(y, device="cpu"),
                                  jpareto.pareto_front(y))


def test_front_is_decided_in_float32():
    """The reference hands float64 to JAX with x64 off: two rows that differ
    only below float32 resolution tie, and neither dominates."""
    y = np.array([[1.0, 2.0, 3.0], [1.0 + 1e-12, 2.0, 3.0]])
    np.testing.assert_array_equal(tpareto.pareto_front(y, device="cpu"),
                                  jpareto.pareto_front(y))
    assert len(tpareto.pareto_front(y, device="cpu")) == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_adrs_equal(seed):
    rng = np.random.default_rng(seed)
    ref, lrn = rng.random((20, 3)), rng.random((9, 3))
    assert tpareto.adrs(ref, lrn) == jpareto.adrs(ref, lrn)
    norm = np.array([2.0, 1.0, 0.5])
    assert tpareto.adrs(ref, lrn, norm) == jpareto.adrs(ref, lrn, norm)
    assert tpareto.adrs(ref, lrn[:0]) == float("inf")


@pytest.mark.parametrize("n,m", [(64, 3), (70, 3), (130, 2), (300, 5)])
def test_counts_with_inf_and_nan_rows_equal_xla_and_pallas(n, m):
    """+inf rows (as the Pallas wrapper's pad rows), a row holding a NaN
    (dominates nothing, dominated by nothing) and an all-NaN row: the plain
    counts equal JAX's XLA form and its Pallas kernel in interpret mode."""
    y = _metrics(n * m, n, m, 9)
    y[3] = np.inf
    y[n - 2] = np.inf
    y[5, m - 1] = np.inf
    y[7, m // 2] = np.nan
    y[n - 1] = np.nan
    got = K3.dominance_counts(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, np.asarray(dominance_counts_xla(jnp.asarray(y))))
    np.testing.assert_array_equal(got, np.asarray(pc_ops.dominance_counts(jnp.asarray(y))))
    assert got[7] == 0 and got[n - 1] == 0
    assert got[3] == got[n - 2] > 0

"""The ``pairdist`` kernel's plain version, the median bandwidth, TED
selection and ICD importance against ``repro``'s."""
import warnings

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np

from repro.core.icd import icd_from_data as icd_from_data_j
from repro.core import make_space as make_space_j
from repro.core import sampling as jsampling
from repro.kernels.backend import rbf_xla, sqdist_xla
from repro.kernels.pairdist import ops as pd_ops
from repro.soc import VLSIFlow as VLSIFlowJ
from repro_torch.core.icd import icd_from_data
from repro_torch.core import make_space
from repro_torch.core import sampling as tsampling
from repro_torch.kernels import pairdist as K2


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (7, 3, 5), (100, 50, 26),
                                   (130, 257, 26)])
def test_pairdist_plain_matches_xla_and_pallas(n, m, d):
    rng = np.random.default_rng(n * m + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal((m, d)).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = K2.pairdist(xt, yt).numpy()
    # same formula, float32 matmuls in other libraries: the cancellation in
    # |x|^2+|y|^2-2xy leaves a few ulps of the norms (|x|^2 ~ d here)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(got, np.asarray(sqdist_xla(xj, yj)),
                               rtol=1e-5, atol=1e-5 * d)
    # the Pallas kernel accumulates in 128-wide padded tiles (its own tests
    # hold it to 2e-4 of the XLA form)
    np.testing.assert_allclose(got, np.asarray(pd_ops.pairwise_sqdist(xj, yj)),
                               rtol=2e-4, atol=2e-4)
    got_rbf = K2.pairdist(xt, yt, bandwidth=1.7).numpy()
    np.testing.assert_allclose(got_rbf, np.asarray(rbf_xla(xj, yj, 1.7)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_rbf, np.asarray(pd_ops.rbf_kernel(xj, yj, 1.7)),
                               rtol=1e-4, atol=1e-4)
    assert (got >= 0).all()


def test_pairdist_rejects_bad_input_and_differentiates():
    x = torch.rand(4, 3)
    with pytest.raises(ValueError, match="feature dims"):
        K2.pairdist(x, torch.rand(4, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        K2.pairdist(x.to("meta"), x.to("meta"))
    xg = x.clone().requires_grad_(True)
    K2.pairdist(xg, xg, differentiable=True).sum().backward()
    assert torch.isfinite(xg.grad).all()


@pytest.mark.parametrize("n", [2, 5, 8, 9])
def test_median_bandwidth_matches_jnp_median(n):
    """n(n-1)/2 off-diagonal values: even for n = 5, 8 (the midpoint of the
    two middle values, which torch.median would not give), odd for 2, 9."""
    rng = np.random.default_rng(n)
    x = rng.random((n, 26)).astype(np.float32)
    d2 = np.array(sqdist_xla(jnp.asarray(x), jnp.asarray(x)))
    want = jsampling._median_bandwidth_from_sqdist(jnp.asarray(d2))
    got = tsampling._median_bandwidth_from_sqdist(torch.from_numpy(d2))
    assert got == want


def _pool_and_v(seed, n):
    rng = np.random.default_rng(seed)
    space = make_space_j()
    pool = np.stack([rng.integers(0, f.t, n) for f in space.features], axis=1)
    v = rng.random(26) * 0.3
    return pool, v


@pytest.mark.parametrize("seed,n,b", [(0, 64, 8), (1, 300, 20), (2, 500, 12)])
def test_ted_rows_equal(seed, n, b):
    pool, v = _pool_and_v(seed, n)
    rows_j, pruned_j, icd_j = jsampling.soc_init(make_space_j(), pool, v,
                                                 v_th=0.07, b=b)
    rows_t, pruned_t, icd_t = tsampling.soc_init(make_space(), pool, v,
                                                 v_th=0.07, b=b, device="cpu")
    np.testing.assert_array_equal(icd_t.numpy(), np.asarray(icd_j))
    assert pruned_t.pinned == pruned_j.pinned
    np.testing.assert_array_equal(rows_t, np.asarray(rows_j))
    assert len(set(rows_t.tolist())) == b


def test_ted_cap_subsamples_and_counts():
    pool, v = _pool_and_v(3, 200)
    x_j = jsampling.transform_to_icd(make_space_j(), jnp.asarray(pool), v)
    x_t = tsampling.transform_to_icd(make_space(), torch.as_tensor(pool), v)
    tsampling.TED_CAP_STATS.update(capped_calls=0, dropped_candidates=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jsampling.ted_select(x_j, 10, max_pool=64)
    with pytest.warns(UserWarning, match="exceeds max_pool=64"):
        got = tsampling.ted_select(x_t, 10, max_pool=64)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert tsampling.TED_CAP_STATS == {"capped_calls": 1,
                                       "dropped_candidates": 136}


@pytest.mark.parametrize("seed,n", [(0, 10), (1, 30)])
def test_icd_importance_equal(seed, n):
    pool, _ = _pool_and_v(seed, n)
    y = np.asarray(VLSIFlowJ(make_space_j(), "resnet50")(pool))
    want = icd_from_data_j(make_space_j(), pool, y)
    got = icd_from_data(make_space(), pool, y)
    np.testing.assert_array_equal(got, want)  # the same float64 numpy
    assert np.linalg.norm(got) == pytest.approx(1.0)

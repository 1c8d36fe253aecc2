"""The rest of Algorithms 1-2 and the design space's helpers against the
live JAX package on the CPU: ``pairdist_chunked``, the uncapped TED path
above ``TED_MAX_POOL`` rows, ``ted_select(bandwidth=)``,
``soc_init(ted_pool=)``, ``median_bandwidth``, ``pairwise_sqdist``,
``fold_ted_stats``, the ``icd`` driver (replayed from the reference's key)
and ``describe`` / ``pruned_fraction`` / ``feature_index``."""
import warnings

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import icd as icd_j
from repro.core import make_space as make_space_j
from repro.core import sampling as sj
from repro.obs import MetricsRegistry as MetricsRegistryJ
from repro.soc import VLSIFlow as VLSIFlowJ
from repro_torch.core import icd, make_space
from repro_torch.core import sampling as st
from repro_torch.kernels import pairdist as K2
from repro_torch.obs import MetricsRegistry
from repro_torch.soc import VLSIFlow
from test_torch_baselines import KeyDraws  # noqa: E402

#: float32 squared distances from two frameworks: a few ulps of the norms
RTOL_D2, ATOL_D2 = 1e-5, 1e-5 * 26
#: a median of those distances, square-rooted
RTOL_BW = 1e-5
#: ICD importance: float64 over float32 metrics from two frameworks
RTOL_V = 1e-5


def _pool_x(n, seed):
    """``n`` TABLE I designs in the plain encoded space, float32."""
    space = make_space_j()
    idx = space.sample(jax.random.PRNGKey(seed), n)
    return np.asarray(space.encode(idx), np.float32)


@pytest.mark.parametrize("n,m", [(300, 300), (4500, 20), (97, 511)])
def test_pairdist_chunked_is_bitwise_the_monolithic_call(n, m):
    rng = np.random.default_rng(n + m)
    x = torch.from_numpy(rng.random((n, 26), dtype=np.float32))
    y = torch.from_numpy(rng.random((m, 26), dtype=np.float32))
    for bw in (None, 0.8):
        full = K2.pairdist(x, y, bandwidth=bw)
        for chunk in (1, 7, m, m + 5):
            got = K2.pairdist_chunked(x, y, chunk=chunk, bandwidth=bw)
            assert torch.equal(got, full), (chunk, bw)
    with pytest.raises(ValueError, match="chunk"):
        K2.pairdist_chunked(x, y, chunk=0)


def test_uncapped_ted_above_the_cap_matches_reference():
    """``max_pool=None`` at N = 4500 > ``TED_MAX_POOL``: the reference builds
    the kernel matrix from 4096-column XLA blocks, the port from one call;
    rows equal."""
    x = _pool_x(4500, 11)
    before = dict(st.TED_CAP_STATS)
    want = sj.ted_select(jnp.asarray(x), b=6, mu=0.1, max_pool=None)
    got = st.ted_select(torch.from_numpy(x), b=6, mu=0.1, max_pool=None)
    np.testing.assert_array_equal(got, want)
    assert st.TED_CAP_STATS == before  # the uncapped path counts nothing


def _ted_float64(x, b, mu, bandwidth):
    """Greedy TED (Algorithm 2, lines 4-8) in float64 from the exact d²:
    the picks and each step's scores."""
    x = x.astype(np.float64)
    K = np.exp(-((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
               / (2.0 * bandwidth**2 + 1e-12))
    taken, rows, scores = np.zeros(len(x), bool), [], []
    for _ in range(b):
        s = (K * K).sum(0) / (np.diag(K) + mu)
        s[taken] = -np.inf
        z = int(np.argmax(s))
        K = K - np.outer(K[:, z], K[:, z]) / (K[z, z] + mu)
        taken[z] = True
        rows.append(z)
        scores.append(s)
    return np.asarray(rows), scores


#: a float64 TED score gap below which float32 d² decides the pick
RTOL_TED_TIE = 1e-5


def test_ted_select_with_a_bandwidth_matches_reference():
    """Fixed bandwidths below the median heuristic's 2.82 on this pool. The
    port picks the float64 TED's rows at each. The reference picks the same
    rows at 1.3 and 2.0; at 0.5 its third pick is a near-tie (float64 scores
    2.3e-6 apart, ROADMAP queue 3) that its float32 d² sends the other way,
    so there the two agree up to that step and the step is checked to be a
    tie."""
    x = _pool_x(400, 12)
    for bw in (0.5, 1.3, 2.0):
        want = sj.ted_select(jnp.asarray(x), b=8, bandwidth=bw)
        got = st.ted_select(torch.from_numpy(x), b=8, bandwidth=bw)
        exact, scores = _ted_float64(x, 8, 0.1, bw)
        np.testing.assert_array_equal(got, exact)
        if bw != 0.5:
            np.testing.assert_array_equal(got, want)
            continue
        step = int(np.argmax(got != want))
        assert step == 2 and np.array_equal(got[:step], want[:step])
        s = scores[step]
        assert abs(s[got[step]] - s[want[step]]) < RTOL_TED_TIE * s[got[step]]


def test_soc_init_ted_pool_caps_like_the_reference():
    space_j, space = make_space_j(), make_space()
    pool = np.asarray(space_j.sample(jax.random.PRNGKey(13), 300))
    v = np.random.default_rng(0).random(space.d)
    for ted_pool in (128, None):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want, pruned_j, _ = sj.soc_init(space_j, pool, v, v_th=0.3, b=6,
                                            ted_pool=ted_pool)
            got, pruned, pool_icd = st.soc_init(space, pool, v, v_th=0.3,
                                                b=6, ted_pool=ted_pool,
                                                device="cpu")
        np.testing.assert_array_equal(got, want)
        assert pruned.pinned == pruned_j.pinned
        assert pool_icd.shape == (300, space.d)


def test_fold_ted_stats_matches_reference():
    stats = {"capped_calls": 2, "dropped_candidates": 1000}
    regs = []
    for mod, reg in ((sj, MetricsRegistryJ()), (st, MetricsRegistry())):
        saved = dict(mod.TED_CAP_STATS)
        mod.TED_CAP_STATS.update(stats)
        try:
            mod.fold_ted_stats(reg)
        finally:
            mod.TED_CAP_STATS.update(saved)
        regs.append(reg.snapshot()["counters"])
    assert regs[1] == regs[0]
    assert regs[1]["ted_dropped_candidates_total"]["series"][""] == 1000
    empty = MetricsRegistry()
    saved = dict(st.TED_CAP_STATS)
    st.TED_CAP_STATS.update(capped_calls=0, dropped_candidates=0)
    try:
        st.fold_ted_stats(empty)
    finally:
        st.TED_CAP_STATS.update(saved)
    assert not empty.snapshot()["counters"]


@pytest.mark.parametrize("n,m", [(1, 1), (9, 40), (130, 257)])
def test_pairwise_sqdist_and_median_bandwidth_match_reference(n, m):
    a, b = _pool_x(n, n), _pool_x(m, m + 1)
    got = st.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(sj.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_D2, atol=ATOL_D2)
    np.testing.assert_allclose(st.median_bandwidth(torch.from_numpy(b)),
                               sj.median_bandwidth(jnp.asarray(b)),
                               rtol=RTOL_BW)


@pytest.mark.parametrize("key,n,pin", [(0, 30, False), (1, 12, True)])
def test_icd_replayed_from_the_key_matches_reference(key, n, pin):
    space_j, space = make_space_j(), make_space()
    if pin:  # a pruned space: the pins are honored by both samplers
        v = np.linspace(0.0, 1.0, space.d)
        space_j, space = space_j.prune(v, 0.3), space.prune(v, 0.3)
    v_j, idx_j, y_j = icd_j(space_j, VLSIFlowJ(space_j, "resnet50"), n,
                            jax.random.PRNGKey(key))
    flow = VLSIFlow(space, "resnet50", device="cpu")
    v, idx, y = icd(space, flow, n, KeyDraws(jax.random.PRNGKey(key)))
    np.testing.assert_array_equal(idx, idx_j)
    np.testing.assert_allclose(y, y_j, rtol=1e-5)
    np.testing.assert_allclose(v, v_j, rtol=RTOL_V, atol=1e-12)
    assert (flow.calls, flow.evaluated) == (1, n)


def test_space_helpers_match_reference():
    space_j, space = make_space_j(), make_space()
    v = np.random.default_rng(3).random(space.d)
    for a, b in ((space_j, space), (space_j.prune(v, 0.4), space.prune(v, 0.4))):
        assert b.describe() == a.describe()
        assert b.pruned_fraction() == a.pruned_fraction()
        assert b.pruned_fraction(space) == a.pruned_fraction(space_j)
        for name in a.names():
            assert b.feature_index(name) == a.feature_index(name)
    assert "PINNED=" in space.prune(v, 0.4).describe()
    assert 0.0 < space.prune(v, 0.4).pruned_fraction() < 1.0
    with pytest.raises(ValueError):
        space.feature_index("NoSuchKnob")

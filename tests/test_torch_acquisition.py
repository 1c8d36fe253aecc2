"""The port's IMOO acquisition against ``repro.core.acquisition``."""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import acquisition as jacq
from repro.core import gp as jgp
from repro_torch import convert
from repro_torch.core import acquisition as tacq


def _state(seed, n=19, d=6, m=3):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    y = np.stack([np.sin(3 * x.sum(1)), x[:, 0] ** 2 + x[:, 3],
                  np.cos(4 * x[:, 5])][:m], 1).astype(np.float32)
    sj = jgp.fit_gp(jnp.asarray(x), jnp.asarray(y), steps=20)
    st = convert.gp_state_from_numpy(
        {"log_ls": sj.params.log_ls, "log_var": sj.params.log_var,
         "log_noise": sj.params.log_noise},
        sj.x, sj.y, sj.y_mean, sj.y_std, sj.chol, sj.alpha, device="cpu")
    return sj, st, rng.random((60, d)).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_mes_information_gain(weighted):
    rng = np.random.default_rng(4)
    mean = rng.standard_normal((50, 3)).astype(np.float32)
    std = (0.05 + rng.random((50, 3))).astype(np.float32)
    # frontier maxima straddling the means: gamma spans both tails, where the
    # 1e-9 clip of the cdf is active
    ystar = (rng.standard_normal((10, 3)) * 4).astype(np.float32)
    w = np.array([1.0, 3.0, 0.5], np.float32) if weighted else None
    want = np.asarray(jacq.mes_information_gain(
        jnp.asarray(mean), jnp.asarray(std), jnp.asarray(ystar),
        None if w is None else jnp.asarray(w)))
    got = tacq.mes_information_gain(
        torch.from_numpy(mean), torch.from_numpy(std), torch.from_numpy(ystar),
        None if w is None else torch.from_numpy(w)).numpy()
    # exp/log/erfc in two float32 libraries: a few ulps of terms up to ~40
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.argmax(got) == np.argmax(want)


def test_frontier_maxima_and_imoo_scores_from_the_same_state():
    sj, st, cand = _state(1)
    key, s = jax.random.PRNGKey(2), 8
    fc = cand[:24]
    eps = np.stack([np.asarray(jax.random.normal(k, (fc.shape[0], s)))
                    for k in jax.random.split(key, 3)])
    want_y = np.asarray(jacq.frontier_maxima(sj, jnp.asarray(fc), key, s=s))
    got_y = tacq.frontier_maxima(st, torch.from_numpy(fc), torch.from_numpy(eps))
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=1e-4, atol=1e-4)
    want = np.asarray(jacq.imoo_scores(sj, jnp.asarray(cand), key, s=s,
                                       frontier_cand=jnp.asarray(fc)))
    got = tacq.imoo_scores(st, torch.from_numpy(cand), torch.from_numpy(eps),
                           frontier_cand=torch.from_numpy(fc)).numpy()
    assert got.shape == (60,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.argmax(got) == np.argmax(want)

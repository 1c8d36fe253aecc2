"""The port's GP surrogate against ``repro.core.gp``: padding,
standardization, the 25-step Adam fit, and posterior predictions and joint
samples from the same state (carried across by ``repro_torch.convert``) and
the same normals."""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import gp as jgp
from repro.core import make_space as make_space_j
from repro.core.sampling import transform_to_icd
from repro.soc import VLSIFlow as VLSIFlowJ
from repro_torch import convert
from repro_torch.core import gp as tgp


def _data(seed, n):
    """ICD-space training inputs and negated metrics, as the engine fits."""
    rng = np.random.default_rng(seed)
    space = make_space_j()
    idx = np.stack([rng.integers(0, f.t, n + 40) for f in space.features], 1)
    v = rng.random(26)
    v[rng.random(26) < 0.4] = 0.0  # pruned (constant) features, as after Alg. 2
    x = np.asarray(transform_to_icd(space, jnp.asarray(idx), v + 1e-3))
    y = -np.asarray(VLSIFlowJ(space, "resnet50")(idx[:n]))
    return np.array(x[:n]), y.astype(np.float32), np.array(x[n:])


def _state_to_port(s):
    return convert.gp_state_from_numpy(
        {"log_ls": s.params.log_ls, "log_var": s.params.log_var,
         "log_noise": s.params.log_noise},
        s.x, s.y, s.y_mean, s.y_std, s.chol, s.alpha, device="cpu")


@pytest.mark.parametrize("n", [13, 16])
def test_pad_training_and_standardize_equal(n):
    x, y, _ = _data(n, n)
    xj, yj, mj = jgp.pad_training(jnp.asarray(x), jnp.asarray(y))
    xt, yt, mt = tgp.pad_training(torch.tensor(x), torch.tensor(y))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert xt.shape[0] % tgp.PAD_BUCKET == 0
    want = jgp._standardize(yj, mj)
    got = tgp._standardize(yt, mt)
    for g, w in zip(got, want):  # float32 moments, another summation order
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_params_after_25_steps(seed):
    x, y, _ = _data(seed, 21)
    sj = jgp.fit_gp(jnp.asarray(x), jnp.asarray(y), steps=25)
    st = tgp.fit_gp(torch.from_numpy(x), torch.from_numpy(y), steps=25)
    # Adam's steps are normalized, so gradient rounding differences move the
    # log-parameters by a few float32 ulps x lr per step (measured ~2e-6)
    for name in ("log_ls", "log_var", "log_noise"):
        np.testing.assert_allclose(getattr(st.params, name).numpy(),
                                   np.asarray(getattr(sj.params, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(st.alpha.numpy(), np.asarray(sj.alpha),
                               rtol=1e-3, atol=1e-3)


def test_predict_and_joint_samples_from_the_same_state():
    x, y, xq = _data(2, 21)
    sj = jgp.fit_gp(jnp.asarray(x), jnp.asarray(y), steps=25)
    st = _state_to_port(sj)
    mj, sdj = jgp.gp_predict(sj, jnp.asarray(xq))
    mt, sdt = tgp.gp_predict(st, torch.from_numpy(xq))
    scale = np.abs(np.asarray(mj)).max(axis=0)
    # float32 products and triangular solves in two libraries: ~1e-6 of the
    # de-standardized scale (measured 4e-6 on unit scale)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0,
                               atol=1e-4 * scale.max())
    np.testing.assert_allclose(sdt.numpy(), np.asarray(sdj), rtol=1e-4,
                               atol=1e-4 * scale.max())
    key, s = jax.random.PRNGKey(9), 10
    want = np.asarray(jgp.gp_joint_samples(sj, jnp.asarray(xq), key, s=s))
    eps = np.stack([np.asarray(jax.random.normal(k, (xq.shape[0], s)))
                    for k in jax.random.split(key, y.shape[1])])
    got = tgp.gp_joint_samples(st, torch.from_numpy(xq), torch.from_numpy(eps))
    assert got.shape == (s, xq.shape[0], 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale.max())


def test_failed_cholesky_is_nan_like_jax():
    bad = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    want = np.asarray(jnp.linalg.cholesky(bad))
    got = tgp._cholesky(torch.from_numpy(bad)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any()
    good = tgp._cholesky(torch.eye(2))
    assert torch.equal(good, torch.eye(2))


def test_convert_and_default_params():
    p = jgp._default_params(3, 26)
    d = {"log_ls": np.asarray(p.log_ls), "log_var": np.asarray(p.log_var),
         "log_noise": np.asarray(p.log_noise)}
    got = convert.gp_params_from_numpy(d, "cpu")
    for k in d:
        np.testing.assert_array_equal(getattr(got, k).numpy(), d[k])
    tp = tgp.default_params(3, 26, "cpu")
    for a, b in zip(tp, p):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

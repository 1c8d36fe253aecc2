"""K4 ``round_fused``: the port's plain version against the JAX package's
staged oracle (``round_fused/ref.py::round_select_ref``) and its Pallas
kernel run in interpret mode (``ops.round_select(interpret=True)``).

Inputs are made with numpy from a seed and handed to both packages. The
picks must be equal; V agrees to rtol = atol = 2e-5 (the port substitutes
row by row with float64-rounded ``exp``, the reference calls a triangular
solve: float32 ulps, amplified by the conditioning of L).
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np

from repro.kernels.round_fused import ops as rf_ops
from repro.kernels.round_fused.ref import round_select_ref
from repro_torch.kernels import round_fused as K4

NAMES = ("ls", "var", "L", "V", "x", "beta", "ystar", "pool_c", "evalm_c",
         "y_mean", "y_std", "weights")


def _problem(nc, C, d, P, m, S, seed):
    """SPD Cholesky factors, a V cache consistent with them (so s0 > 0
    reuses correct leading rows), frontier samples, a few evaluated
    columns — as numpy arrays. Features are scaled by 1/sqrt(d) so kernel
    entries stay O(0.1) at every d: unscaled, d = 26 gives entries of
    ~e^-26 and every column's score ties to the last ulp."""
    rng = np.random.default_rng(seed)
    f = np.float32
    sc = 1.5 / np.sqrt(d)
    A = rng.normal(size=(m, P, P)) / np.sqrt(P)
    K = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(P)
    evalm = np.zeros((nc, C), bool)
    evalm[0, :min(3, C)] = True
    prob = dict(
        ls=np.exp(0.3 * rng.normal(size=(m, d))).astype(f),
        var=np.exp(0.2 * rng.normal(size=(m,))).astype(f),
        L=np.linalg.cholesky(K).astype(f),
        V=np.zeros((nc, m, P, C), f),
        x=(sc * rng.normal(size=(P, d))).astype(f),
        beta=rng.normal(size=(m, P)).astype(f),
        ystar=rng.normal(size=(S, m)).astype(f),
        pool_c=(sc * rng.normal(size=(nc, C, d))).astype(f),
        evalm_c=evalm,
        y_mean=np.linspace(-1.0, 1.0, m).astype(f),
        y_std=np.linspace(0.5, 2.0, m).astype(f),
        weights=np.linspace(0.2, 1.0, m).astype(f))
    prob["V"] = _ref(prob, 0)[0]
    return prob


def _ref(prob, s0):
    v, i = round_select_ref(**{k: jnp.asarray(a) for k, a in prob.items()},
                            s0=s0)
    return np.asarray(v), int(i)


def _plain(prob, s0):
    t = {k: torch.tensor(a) for k, a in prob.items()}
    before = K4.launches
    v, i = K4.round_select(*(t[k] for k in NAMES), s0=s0)
    assert K4.launches == before  # CPU tensors: the plain version, no launch
    assert i.dtype == torch.int32 and i.dim() == 0
    return v.numpy(), int(i)


SHAPES = [
    (2, 130, 5, 24, 3, 10, 16),   # unaligned C and d, partial reuse
    (1, 48, 26, 8, 2, 5, 0),      # full refactor, sub-tile chunk
    (3, 7, 3, 16, 3, 10, 8),      # tiny ragged chunks
    (2, 64, 5, 24, 3, 10, 24),    # s0 == P: score-only, V untouched
    (1, 1024, 26, 32, 2, 10, 16),  # one wide chunk
]


@pytest.mark.parametrize("nc,C,d,P,m,S,s0", SHAPES)
def test_plain_matches_jax_ref_and_interpret_kernel(nc, C, d, P, m, S, s0):
    prob = _problem(nc, C, d, P, m, S, seed=nc * C + d + s0)
    want_v, want_i = _ref(prob, s0)
    got_v, got_i = _plain(prob, s0)
    assert got_i == want_i
    np.testing.assert_allclose(got_v, want_v, rtol=2e-5, atol=2e-5)
    kv, ki = rf_ops.round_select(**{k: jnp.asarray(a) for k, a in prob.items()},
                                 s0=s0, interpret=True)
    assert got_i == int(ki)
    np.testing.assert_allclose(got_v, np.asarray(kv), rtol=2e-5, atol=2e-5)
    if s0 >= P:  # score-only hands V back untouched
        np.testing.assert_array_equal(got_v, prob["V"])


@pytest.mark.parametrize("s0", [24, 100])
def test_score_only_leaves_v_untouched(s0):
    prob = _problem(2, 40, 4, 24, 3, 6, seed=5)
    got_v, got_i = _plain(prob, s0)
    np.testing.assert_array_equal(got_v, prob["V"])
    assert got_i == _ref(prob, s0)[1]


def test_ties_go_to_the_first_index_across_chunks_and_tiles():
    """Duplicated winners later in the same chunk (past a 128 tile) and in
    the next chunk tie exactly; the first index wins, then the next one."""
    prob = _problem(2, 130, 5, 16, 3, 8, seed=11)
    _, win = _ref(prob, 0)
    j, c = divmod(win, 130)
    pc = prob["pool_c"]
    pc[j, 129 if c < 129 else 128] = pc[j, c]
    pc[(j + 1) % 2, 5] = pc[j, c]
    prob["V"] = _ref({**prob, "V": np.zeros_like(prob["V"])}, 0)[0]
    want_v, want_i = _ref(prob, 0)
    got_v, got_i = _plain(prob, 0)
    assert got_i == want_i
    em = prob["evalm_c"].reshape(-1)
    em[got_i] = True
    prob["evalm_c"] = em.reshape(2, 130)
    _, want_i2 = _ref(prob, 0)
    _, got_i2 = _plain(prob, 0)
    assert got_i2 == want_i2 != got_i
    # the duplicates score bit-identically in the plain version
    t = {k: torch.tensor(a) for k, a in prob.items()}
    V = K4.v_update_plain(t["ls"], t["var"], t["L"], t["V"], t["x"],
                          t["pool_c"], 0)
    mu, sd = K4.col_moments_plain(t["var"], t["beta"], V[(j + 1) % 2])
    mu0, sd0 = K4.col_moments_plain(t["var"], t["beta"], V[j])
    assert torch.equal(mu[:, 5], mu0[:, c]) and torch.equal(sd[:, 5], sd0[:, c])


def test_nan_chunk_is_skipped_like_the_reference():
    """A NaN score poisons only its chunk: the engine's scan (and the JAX
    oracle) skips that chunk, even if it held the best finite score; a NaN
    L (a failed Cholesky) leaves nothing to pick, so the index is 0."""
    prob = _problem(3, 20, 4, 8, 3, 5, seed=2)
    _, win = _ref(prob, 0)
    j = win // 20
    prob["pool_c"][j, (win + 1) % 20] = np.nan
    want_v, want_i = _ref(prob, 0)
    got_v, got_i = _plain(prob, 0)
    assert got_i == want_i and got_i // 20 != j
    np.testing.assert_allclose(got_v, want_v, rtol=2e-5, atol=2e-5)
    prob["L"] = np.full_like(prob["L"], np.nan)
    assert _plain(prob, 0)[1] == _ref(prob, 0)[1] == 0


def test_select_plain_rules():
    inf = np.inf
    s = torch.tensor([[-inf, -inf], [-inf, -inf]])
    assert int(K4.select_plain(s)) == 0
    s = torch.tensor([[1.0, 3.0], [3.0, 2.0], [np.nan, 9.0]])
    assert int(K4.select_plain(s)) == 1  # strict > keeps the earlier chunk
    s = torch.tensor([[1.0, np.nan], [0.5, 0.2]])
    assert int(K4.select_plain(s)) == 2


def test_wrapper_checks_its_arguments():
    prob = _problem(1, 8, 3, 8, 2, 4, seed=0)
    t = {k: torch.tensor(a) for k, a in prob.items()}
    args = [t[k] for k in NAMES]
    with pytest.raises(ValueError, match="V has shape"):
        K4.round_select(*args[:3], t["V"][..., :4].contiguous(), *args[4:], s0=0)
    with pytest.raises(TypeError, match="torch.bool"):
        K4.round_select(*args[:8], t["evalm_c"].float(), *args[9:], s0=0)
    with pytest.raises(ValueError, match="expected 2 dims"):
        K4.round_select(*args[:4], t["x"][0], *args[5:], s0=0)
    with pytest.raises(ValueError, match="s0 must be"):
        K4.round_select(*args, s0=-1)
    with pytest.raises(TypeError, match="float32"):
        K4.round_select(*args[:4], t["x"].double(), *args[5:], s0=0)

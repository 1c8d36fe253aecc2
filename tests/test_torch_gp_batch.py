"""The port's batched GP work against the reference on the CPU: the NLL
that ``repro_torch.core.gp._fit`` descends equals the reference's
(``repro.core.gp._nll_one`` summed over a vmap) in value and gradients,
for GPs that share their rows and for GPs with rows of their own; and a
batch padded with copies of its first scenario, as a mesh's scenario group
pads its GP work to the whole fleet's batch, gives each scenario the
values the whole fleet gives it (on the card:
``tests/test_torch_cuda.py``)."""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import gp as gp_j
from repro_torch.core import engine as E
from repro_torch.core import gp


@pytest.mark.parametrize("shared_x", [True, False])
def test_nll_matches_the_reference(shared_x):
    """Value and gradients of the summed NLL of 6 GPs (shared rows [n, d],
    or rows of their own [6, n, d]) within float32 sum order of
    ``jax.value_and_grad`` of the reference's."""
    rng = np.random.default_rng(1)
    B, n, d = 6, 24, 5
    x = (0.3 * rng.normal(size=(n, d) if shared_x else (B, n, d))
         ).astype(np.float32)
    y = rng.normal(size=(n, B)).astype(np.float32)
    mask = np.zeros((n,) if shared_x else (B, n), np.float32)
    mask[..., 20:] = 1.0
    params = [(0.1 * rng.normal(size=(B, d)) - 0.5).astype(np.float32),
              (0.1 * rng.normal(size=B)).astype(np.float32),
              (0.1 * rng.normal(size=B) - 4.0).astype(np.float32)]

    leaves = [torch.tensor(t, requires_grad=True) for t in params]
    val = gp._nll(*leaves, torch.tensor(x), torch.tensor(y),
                  torch.tensor(mask))
    grads = torch.autograd.grad(val, leaves)

    rows = None if shared_x else 0

    def loss(ls, var, noise):
        return jnp.sum(jax.vmap(gp_j._nll_one,
                                in_axes=(0, 0, 0, rows, 1, rows))(
            ls, var, noise, x, y, mask))

    want, want_grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(*params)
    np.testing.assert_allclose(val.item(), float(want), rtol=1e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5,
                                   atol=1e-5)


def _inputs(S=6, P=24, d=5, m=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    mask = torch.zeros((S, P))
    mask[:, 20:] = 1.0
    x = 0.3 * torch.randn((S, P, d), generator=gen) + 10.0 * mask[:, :, None]
    yn = torch.randn((S, P, m), generator=gen)
    eps = torch.randn((S, m, 16, 4), generator=gen)
    pool = 0.3 * torch.randn((S, 40, d), generator=gen)
    sub = torch.arange(16).expand(S, 16)
    p0 = gp.default_params(m, d, "cpu")
    p0 = gp.GPParams(*(t.expand(S, *t.shape).contiguous() for t in p0))
    return dict(p0=p0, x=x, yn=yn, mask=mask, eps=eps, pool=pool, sub=sub,
                mean=torch.zeros((S, m)), std=torch.ones((S, m)))


def _gp_work(a: dict, idx: torch.Tensor, n: int) -> list:
    """The engine's batched GP work on the scenarios ``idx``: the fit, a
    refactor, a block update from 16 and the frontier samples; the first
    ``n`` scenarios' results."""
    def g(t):
        return t[idx]

    fit = gp._fit_batch(gp.GPParams(*map(g, a["p0"])), g(a["x"]), g(a["yn"]),
                        g(a["mask"]), 8)
    L0 = E._chol_refactor_batch(fit, g(a["x"]), g(a["mask"]))
    L = E._chol_block_batch(fit, L0, g(a["x"]), g(a["mask"]), 16)
    beta, ystar = E._beta_ystar_batch(fit, L, g(a["x"]), g(a["yn"]),
                                      g(a["mean"]), g(a["std"]), g(a["pool"]),
                                      g(a["sub"]), g(a["eps"]))
    return [t[:n] for t in (*fit, L0, L, beta, ystar)]


@pytest.mark.parametrize("G", [1, 2, 3])
def test_a_padded_group_gets_the_whole_fleets_gp_work(G):
    """Groups of G of 6 scenarios, each padded to 6 with copies of its
    first (``BatchedBOEngine._fleet_index``): every group's fit, factors,
    whitened targets and frontier samples are the whole fleet's, bit for
    bit."""
    a = _inputs()
    whole = _gp_work(a, torch.arange(6), 6)
    for lo in range(0, 6, G):
        idx = torch.arange(lo, lo + G)
        padded = torch.cat([idx, idx[:1].expand(6 - G)])
        for k, (got, want) in enumerate(zip(_gp_work(a, padded, G), whole)):
            assert torch.equal(got, want[lo:lo + G]), (lo, k)

"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Run them on a GPU
host with ``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the shared conftest imports
jax, which this file does not need).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.core import make_space
from repro_torch.kernels import pairdist as K2
from repro_torch.kernels import pareto_count as K3
from repro_torch.kernels import systolic_eval as K1
from repro_torch.soc.workloads import get_workload

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("workload", ["resnet50", "mobilenet", "transformer"])
@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_systolic_eval_matches_plain(dev, workload, n):
    space = make_space()
    idx = space.sample(torch.Generator().manual_seed(n), n).numpy()
    vals = torch.as_tensor(space.values(idx), dtype=torch.float32, device=dev)
    layers = torch.as_tensor(get_workload(workload), dtype=torch.float32,
                             device=dev)
    before = K1.launches
    got = K1.soc_metrics(vals, layers)
    assert K1.launches == before + 1
    # float32 sums over the layers in another order, powf/log2f ulps
    torch.testing.assert_close(got, K1.soc_metrics_plain(vals, layers),
                               rtol=2e-5, atol=0)


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (63, 65, 26), (130, 257, 26),
                                   (64, 2500, 26), (200, 100, 40)])
def test_pairdist_matches_plain(dev, n, m, d):
    g = torch.Generator(device=dev).manual_seed(n + m + d)
    x = torch.rand((n, d), generator=g, device=dev)
    y = torch.rand((m, d), generator=g, device=dev)
    scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
    atol = 2 * d * 2.0 ** -24 * scale  # cancellation in |x|^2+|y|^2-2xy
    torch.testing.assert_close(K2.pairdist(x, y), K2.pairdist_plain(x, y),
                               rtol=1e-5, atol=atol)
    inv2s2 = 1.0 / (2 * 0.9 ** 2 + 1e-12)
    torch.testing.assert_close(K2.pairdist(x, y, bandwidth=0.9),
                               K2.pairdist_plain(x, y, 0.9),
                               rtol=1e-5, atol=inv2s2 * atol + 1e-6)


@pytest.mark.parametrize("n,m", [(1, 3), (31, 3), (33, 2), (600, 3), (2500, 3),
                                 (700, 8)])
def test_pareto_count_equals_plain(dev, n, m):
    rng = np.random.default_rng(n * m)
    y = rng.integers(0, 7, (n, m)).astype(np.float32)  # many ties
    y[n // 2:] = y[: n - n // 2]                        # duplicated rows
    yt = torch.as_tensor(y, device=dev)
    got = K3.dominance_counts(yt)
    assert got.dtype == torch.int32
    assert torch.equal(got, K3.dominance_counts_plain(yt))


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.rand((8, 6), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        K2.pairdist(x.t(), x.t())
    with pytest.raises(ValueError, match="different devices"):
        K2.pairdist(x, x.cpu())
    with pytest.raises(ValueError, match="objectives"):
        K3.dominance_counts(torch.rand((8, 9), device=dev))


def test_small_tuner_on_the_card_picks_what_the_cpu_picks(dev):
    from repro_torch.core import soc_tuner
    from repro_torch.random import GeneratorDraws
    from repro_torch.soc import VLSIFlow

    space = make_space()
    pool = space.sample(torch.Generator().manual_seed(7), 64).numpy()
    rows = {}
    for d in ("cuda", "cpu"):
        flow = VLSIFlow(space, "resnet50", device=d)
        rows[d] = soc_tuner(space, pool, flow, T=4, n=10, b=8, gp_steps=25,
                            draws=GeneratorDraws(3, "cpu"),
                            device=d).evaluated_rows
    np.testing.assert_array_equal(rows["cuda"], rows["cpu"])

"""The ``systolic_eval`` kernel's plain version and ``VLSIFlow`` against
``repro.soc`` (its XLA model and its Pallas kernel in interpret mode)."""
import pickle

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np

from repro.core import make_space as make_space_j
from repro.kernels.systolic_eval import ops as se_ops
from repro.soc import VLSIFlow as VLSIFlowJ
from repro.soc import get_workload, soc_metrics
from repro_torch.core import make_space
from repro_torch.kernels import systolic_eval as K1
from repro_torch.soc import VLSIFlow

#: float32 on both sides; the sums over the L layers run in another order,
#: so outputs agree to a few float32 ulps (measured <= 4e-7 relative)
RTOL = 2e-6


def _vals(seed, n):
    rng = np.random.default_rng(seed)
    space = make_space_j()
    idx = np.stack([rng.integers(0, f.t, n) for f in space.features], axis=1)
    return idx, space.values(idx).astype(np.float32)


@pytest.mark.parametrize("workload", ["resnet50", "mobilenet", "transformer"])
def test_plain_model_matches_xla_and_pallas(workload):
    _, vals = _vals(11, 256)
    layers = get_workload(workload).astype(np.float32)
    got = K1.soc_metrics(torch.from_numpy(vals), torch.from_numpy(layers))
    assert got.shape == (256, 3) and got.dtype == torch.float32
    got = got.numpy()
    want_xla = np.asarray(soc_metrics(vals, layers))
    want_pallas = np.asarray(se_ops.soc_metrics(jnp.asarray(vals),
                                                jnp.asarray(layers)))
    np.testing.assert_allclose(got, want_xla, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=0)
    assert np.isfinite(got).all() and (got > 0).all()


def test_wrapper_on_cpu_is_the_plain_version():
    _, vals = _vals(3, 7)
    layers = torch.as_tensor(get_workload("resnet50"), dtype=torch.float32)
    v = torch.from_numpy(vals)
    before = K1.launches
    assert torch.equal(K1.soc_metrics(v, layers), K1.soc_metrics_plain(v, layers))
    assert K1.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="vals"):
        K1.soc_metrics(v[:, :25], layers)
    with pytest.raises(TypeError):
        K1.soc_metrics(v.double(), layers)
    with pytest.raises(ValueError, match="unsupported device"):
        K1.soc_metrics(v.to("meta"), layers.to("meta"))


def test_flow_matches_reference_flow_and_counts():
    idx, _ = _vals(5, 40)
    flow = VLSIFlow(make_space(), "transformer", device="cpu")
    got = flow(idx)
    want = np.asarray(VLSIFlowJ(make_space_j(), "transformer")(idx))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    flow(idx[0])  # a single design row
    assert (flow.calls, flow.evaluated) == (2, 41)
    clone = pickle.loads(pickle.dumps(flow))
    assert "_layers_t" not in flow.__getstate__()
    np.testing.assert_array_equal(clone(idx), got)
    assert clone.device == torch.device("cpu")

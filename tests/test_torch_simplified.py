"""The simplified (SCALE-Sim-like) model, ``SimplifiedFlow``,
``area_breakdown`` and ``VLSIFlow`` over a layer table, against the live
JAX package on the CPU."""
import pickle

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np

from repro.soc import SimplifiedFlow as SimplifiedFlowJ
from repro.soc import area_breakdown as area_breakdown_j
from repro.soc import get_workload, simplified_metrics as simplified_j
from repro_torch.core import make_space
from repro_torch.kernels import systolic_eval as K1
from repro_torch.soc import (CONST, SimplifiedFlow, VLSIFlow, area_breakdown,
                             simplified_metrics)

#: float32 on both sides; the layer sums run in another order
RTOL_SIMPLIFIED = 1e-5
#: elementwise float32 products and powf (no sums over layers)
RTOL_AREA = 1e-6


def _vals(space, idx):
    return space.values(idx).astype(np.float32)


@pytest.mark.parametrize("workload", ["resnet50", "mobilenet", "transformer"])
def test_simplified_metrics_matches_reference(workload, space, small_pool):
    vals = _vals(space, small_pool)
    layers = get_workload(workload).astype(np.float32)
    got = simplified_metrics(torch.from_numpy(vals), torch.from_numpy(layers))
    assert got.shape == (len(vals), 3) and got.dtype == torch.float32
    want = np.asarray(simplified_j(jnp.asarray(vals), jnp.asarray(layers)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_SIMPLIFIED)


def test_simplified_flow_counts_and_pickles(space, small_pool):
    flow = SimplifiedFlow(make_space(), "resnet50", device="cpu")
    flow_j = SimplifiedFlowJ(space, "resnet50")
    before = K1.launches
    for rows in (small_pool[:5], small_pool[7], small_pool[10:30]):
        np.testing.assert_allclose(flow(rows), flow_j(rows),
                                   rtol=RTOL_SIMPLIFIED)
    assert (flow.calls, flow.evaluated) == (flow_j.calls, flow_j.evaluated) \
        == (3, 26)
    assert K1.launches == before
    clone = pickle.loads(pickle.dumps(flow))
    assert type(clone) is SimplifiedFlow and clone.calls == 3
    np.testing.assert_array_equal(clone(small_pool[:4]), flow(small_pool[:4]))
    # the idealized model is optimistic against the full one (Fig. 4(c))
    full = VLSIFlow(make_space(), "resnet50", device="cpu")(small_pool[:64])
    assert (flow(small_pool[:64])[:, 0] <= full[:, 0] * 1.001).all()


def test_area_breakdown_matches_reference(space, small_pool):
    vals = _vals(space, small_pool)
    got = area_breakdown(torch.from_numpy(vals))
    want = area_breakdown_j(jnp.asarray(vals))
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == (len(vals),)
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_AREA)


def test_area_breakdown_sums(small_pool):
    """The twin of ``tests/test_soc_model.py::test_area_breakdown_sums``:
    the components times the NoC overhead are the model's area."""
    space = make_space()
    vals = torch.as_tensor(space.values(small_pool[:8]), dtype=torch.float32)
    parts = area_breakdown(vals)
    total = sum(parts.values())
    m = K1.soc_metrics(vals, torch.as_tensor(get_workload("resnet50"),
                                             dtype=torch.float32)).numpy()
    assert CONST["noc_overhead"] == 1.08
    assert np.allclose(total * 1.08, m[:, 2], rtol=1e-4)


@pytest.mark.parametrize("workload", ["resnet50", "transformer"])
def test_vlsiflow_takes_a_layer_table(workload, small_pool):
    space = make_space()
    by_name = VLSIFlow(space, workload, device="cpu")
    by_table = VLSIFlow(space, get_workload(workload), device="cpu")
    np.testing.assert_array_equal(by_table.layers, by_name.layers)
    np.testing.assert_array_equal(by_table(small_pool[:16]),
                                  by_name(small_pool[:16]))
    clone = pickle.loads(pickle.dumps(by_table))
    np.testing.assert_array_equal(clone(small_pool[:3]),
                                  by_name(small_pool[:3]))

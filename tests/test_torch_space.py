"""The port's design space and workloads against ``repro``'s, exactly."""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.core import space as jspace
from repro.soc import workloads as jworkloads
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import space as tspace
from repro_torch.soc import workloads as tworkloads


def _idx(rng, space, n):
    return np.stack([rng.integers(0, f.t, n) for f in space.features], axis=1)


def test_table_i_is_identical():
    assert len(tspace.TABLE_I) == len(jspace.TABLE_I) == 26
    for a, b in zip(tspace.TABLE_I, jspace.TABLE_I):
        assert (a.name, a.values, a.group, a.categorical, a.t) == \
            (b.name, b.values, b.group, b.categorical, b.t)


def test_encode_and_values_are_equal():
    rng = np.random.default_rng(0)
    sj, st = jspace.make_space(), tspace.make_space()
    idx = _idx(rng, sj, 300)
    enc_j = np.asarray(sj.encode(jnp.asarray(idx)))
    enc_t = st.encode(torch.as_tensor(idx)).numpy()
    assert enc_t.dtype == np.float32
    np.testing.assert_array_equal(enc_t, enc_j)  # a table lookup: exact
    np.testing.assert_array_equal(st.values(idx), sj.values(idx))
    assert st.names() == sj.names()
    assert st.log10_size == pytest.approx(sj.log10_size, rel=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prune_and_apply_pins_are_equal(seed):
    rng = np.random.default_rng(seed)
    v = rng.random(26) * 0.2
    sj = jspace.make_space().prune(v, 0.07)
    st = tspace.make_space().prune(v, 0.07)
    assert st.pinned == sj.pinned and st.pinned
    idx = _idx(rng, sj, 50)
    want = np.asarray(sj.apply_pins(jnp.asarray(idx)))
    got = torch.as_tensor(idx)
    np.testing.assert_array_equal(st.apply_pins(got).numpy(), want)
    np.testing.assert_array_equal(got.numpy(), idx)  # the input is untouched
    assert st.log10_size == pytest.approx(sj.log10_size, rel=1e-12)
    # a second prune keeps the first pins (the reference's rule)
    v2 = rng.random(26) * 0.2
    assert tspace.make_space().prune(v, 0.07).prune(v2, 0.07).pinned == \
        jspace.make_space().prune(v, 0.07).prune(v2, 0.07).pinned


def test_sample_honors_ranges_and_pins():
    st = tspace.make_space().prune(np.r_[np.zeros(5), np.ones(21)], 0.5)
    idx = st.sample(torch.Generator().manual_seed(0), 500)
    assert idx.shape == (500, 26) and idx.dtype == torch.int64
    for i, f in enumerate(st.features):
        col = idx[:, i]
        assert int(col.min()) >= 0 and int(col.max()) < f.t
        if i in st.pinned:
            assert bool((col == st.pinned[i]).all())
    # the same generator seed gives the same pool
    again = st.sample(torch.Generator().manual_seed(0), 500)
    assert torch.equal(idx, again)


@pytest.mark.parametrize("name", ["resnet50", "mobilenet", "transformer"])
def test_workload_arrays_are_equal(name):
    got = tworkloads.get_workload(name)
    want = jworkloads.get_workload(name)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_lm_workloads_are_not_ported_yet():
    """An id that is neither a DNN nor an LM is refused with the known
    names (LM ids: ``test_lm_workload_tables_are_equal``)."""
    with pytest.raises(KeyError, match="mistral-nemo-12b"):
        tworkloads.get_workload("no-such-arch")


@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_workload_tables_are_equal(arch, mode):
    got = tworkloads.get_workload(f"{arch}:{mode}")
    want = jworkloads.get_workload(f"{arch}:{mode}")
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tworkloads.from_arch_config(get_config(arch, smoke=True), mode,
                                    seq=64, ctx=32),
        jworkloads.from_arch_config(jget_config(arch, smoke=True), mode,
                                    seq=64, ctx=32))

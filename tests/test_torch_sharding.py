"""The port's sharding layer against the live JAX package on the CPU: the
logical-axis resolver (``repro_torch.parallel.sharding``), the logical axes
of every parameter and cache leaf of every registry arch at its published
shapes (``param_axes``, ``cache_axes`` on an ``LM`` built on ``meta``), the
ZeRO-1 specs and the production meshes.

Every expectation is the reference's own output on the same inputs; the
reference's leaves come from ``repro.launch.specs.abstract_init`` /
``abstract_cache`` (``jax.eval_shape``: no memory either). The reference
stacks its scanned layers (a leading None axis); the port's blocks are one
module each, so a port leaf is held against the stacked leaf without its
leading entry.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import numpy as np
from jax.sharding import PartitionSpec as PJ

from repro.configs import ARCH_IDS
from repro.configs import get_config as get_config_j
from repro.launch.specs import abstract_cache, abstract_init
from repro.parallel.sharding import AxisRules as AxisRulesJ
from repro.parallel.sharding import DEFAULT_RULES as DEFAULT_RULES_J
from repro.parallel.sharding import _PRIORITY as PRIORITY_J
from repro.train.optimizer import zero1_spec as zero1_spec_j
from repro_torch.configs import get_config
from repro_torch.convert import _reference_leaves
from repro_torch.launch import make_mesh_named, make_production_mesh
from repro_torch.models import (LM, cache_axes, cache_leaves, init_cache,
                                param_axes)
from repro_torch.models.model import _slots, reference_slot
from repro_torch.parallel import (DEFAULT_RULES, AxisRules, Mesh,
                                  NamedSharding, P, axis_rules,
                                  named_sharding, resolve_spec, tree_specs)
from repro_torch.parallel.sharding import _PRIORITY
from repro_torch.train import tree_zero1_specs, zero1_spec

MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}
#: the decode cells' override (``repro.launch.specs.cell_rules``): weights
#: stay resident, no ZeRO/FSDP dim
OVERRIDES = {"default": None, "decode": {"embed_fsdp": ()}}

#: ZeRO-1 leaves where the reference's stacked leaf puts the data axes on
#: its layer dim, which the port's one-module-a-block leaf does not have:
#: (arch, mesh) -> {reference path: (stacked shape, reference spec, port
#: spec)}. The port keeps the tensor-parallel spec there (ROADMAP queue 3).
LAYER_DIM_ZERO1 = {
    ("mamba2-370m", "single_pod"): {
        "layers.b0.ssm.conv_w": ((48, 4, 2304), ("data", None, "model"),
                                 (None, "model")),
        "layers.b0.ssm.A_log": ((48, 32), ("data", "model"), ("model",)),
        "layers.b0.ssm.D": ((48, 32), ("data", "model"), ("model",)),
        "layers.b0.ssm.dt_bias": ((48, 32), ("data", "model"), ("model",)),
    },
}


def _rules(sizes, override=None):
    """The port's and the reference's rules at ``sizes`` (no devices)."""
    got, want = AxisRules(None, override), AxisRulesJ(None, override)
    got.axis_sizes = dict(sizes)
    want.axis_sizes = dict(sizes)
    return got, want


def _spec_j(rules, axes, shape) -> tuple:
    return tuple(rules.spec(axes, shape))


# (mesh sizes, override, axes, shape): the cases of
# tests/test_sharding_rules.py
RULE_CASES = {
    "heads_divisible_claims_model": (
        MESHES["single_pod"], None, ("batch", "seq", "heads", None),
        (256, 4096, 32, 128)),
    "heads_fallback_to_seq_parallel": (
        MESHES["single_pod"], None, ("batch", "seq", "heads", None),
        (256, 4096, 40, 128)),
    "kv_heads_replicated_when_non_divisible": (
        MESHES["single_pod"], None, ("batch", None, "kv_heads", None),
        (32, 4096, 8, 128)),
    "multi_pod_batch_axes": (
        MESHES["multi_pod"], None, ("batch", None), (256, 10)),
    "multi_pod_batch_one_long_context": (
        MESHES["multi_pod"], None, ("batch", "cache_seq", None),
        (1, 524288, 576)),
    "custom_rules_override": (
        MESHES["single_pod"], {"cache_seq": (("data", "model"),)},
        ("batch", "cache_seq", None), (1, 524288, 576)),
    "vocab_sharding": (MESHES["single_pod"], None, ("vocab", "embed_fsdp"),
                       (151936, 5120)),
    "vocab_fallback": (MESHES["single_pod"], None, ("vocab", "embed_fsdp"),
                       (51865, 384)),
    "no_axis_reuse_within_leaf": (MESHES["single_pod"], None,
                                  ("heads", "ff"), (32, 4096)),
    "no_mesh_means_replicated": ({}, None, ("batch", "heads"), (8, 32)),
}


def test_tables_are_the_references():
    assert DEFAULT_RULES == DEFAULT_RULES_J
    assert _PRIORITY == PRIORITY_J


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_cases_equal_reference(case):
    sizes, override, axes, shape = RULE_CASES[case]
    got, want = _rules(sizes, override)
    spec = got.spec(axes, shape)
    assert isinstance(spec, P)
    assert tuple(spec) == _spec_j(want, axes, shape)


NAMES = (None, "batch", "vocab", "heads", "kv_heads", "ff", "experts",
         "d_inner", "ssm_heads", "width", "conv_dim", "embed", "embed_fsdp",
         "seq", "cache_seq", "head_dim", "expert_cap", "other")
SIZES = (1, 2, 3, 4, 6, 8, 10, 12, 16, 24, 32, 40, 48, 64, 96, 128, 256, 512)
MESH_AXES = ("pod", "data", "model")


@pytest.mark.parametrize("seed", range(4))
def test_random_cases_equal_reference(seed):
    """1000 seeded (axes, shape, rule override, axis sizes) cases a seed."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        n = int(rng.integers(1, 6))
        axes = tuple(NAMES[i] for i in rng.integers(0, len(NAMES), n))
        shape = tuple(int(SIZES[i]) for i in rng.integers(0, len(SIZES), n))
        sizes = {a: int(rng.choice((1, 2, 4, 8, 16)))
                 for a in MESH_AXES if rng.random() < 0.7}
        override = None
        if rng.random() < 0.3:
            name = NAMES[1 + int(rng.integers(0, len(NAMES) - 1))]
            cands = [tuple(a for a in MESH_AXES if rng.random() < 0.5)
                     for _ in range(int(rng.integers(0, 3)))]
            override = {name: tuple(c for c in cands if c)}
        got, want = _rules(sizes, override)
        spec = got.spec(axes, shape)
        assert tuple(spec) == _spec_j(want, axes, shape), \
            (axes, shape, sizes, override)
        z = zero1_spec(spec, shape, got)
        assert tuple(z) == tuple(zero1_spec_j(PJ(*spec), shape, want))


def test_context_rules_sharding_and_tree_specs():
    """``axis_rules`` makes the thread's rules current (none outside);
    ``named_sharding`` is None without a mesh; ``tree_specs`` maps a
    nested tree."""
    mesh = Mesh(np.asarray(["cpu"] * 4, dtype=object).reshape(2, 2),
                ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 2}
    assert repr(P("data", ("pod", "data"))) == "P('data', ('pod', 'data'))"
    assert resolve_spec(("batch",), (8,)) == P()
    assert named_sharding(("batch",), (8,)) is None
    with axis_rules(mesh) as r:
        assert resolve_spec(("batch", "heads"), (8, 6)) == P("data", "model")
        ns = named_sharding(("batch", "heads"), (8, 6))
        assert ns == NamedSharding(mesh, P("data", "model"))
        assert r.sharding(("heads",), (3,)).spec == P()
        tree = {"a": ("batch", None), "b": [("heads",), {"c": (None,)}]}
        leaves = {"a": torch.empty(8, 3), "b": [torch.empty(4),
                                                 {"c": torch.empty(5)}]}
        assert tree_specs(tree, leaves) == {"a": P("data"),
                                           "b": [P("model"), {"c": P()}]}
    assert resolve_spec(("batch",), (8,)) == P()
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 2, ("a", "b"))


def _leaf(tree, path):
    for key in path.split("."):
        tree = tree[key]
    return tree


@pytest.fixture(scope="module")
def reference_params():
    """Each arch's reference shapes and axes (``abstract_init``)."""
    return {arch: abstract_init(get_config_j(arch)) for arch in ARCH_IDS}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_specs_and_zero1_equal_reference(arch, reference_params):
    """Every parameter of the published config: the port's axes are the
    reference's (its stacked leaf's without the leading None), and under
    each production mesh, with and without the decode override, the
    resolved spec and the ZeRO-1 spec are the reference's on the same
    unstacked shape. The stacked leaves whose ZeRO-1 choice is the layer
    dim are exactly ``LAYER_DIM_ZERO1``'s."""
    cfg = get_config(arch)
    shapes, axes = reference_params[arch]
    model = LM(cfg, "meta")
    got_axes = param_axes(cfg, model)
    leaves = _reference_leaves(cfg, model)
    assert sorted(got_axes) == sorted(n for n, *_ in leaves)
    assert all(w.device.type == "meta" for _, w, _, _ in leaves)
    layer_dim = {}
    for (mesh, sizes), (_, override) in itertools.product(
            MESHES.items(), OVERRIDES.items()):
        got_r, want_r = _rules(sizes, override)
        specs = tree_zero1_specs(got_axes, dict(model.named_parameters()),
                                 got_r)
        for name, w, path, j in leaves:
            want_axes, want_shape = _leaf(axes, path), _leaf(shapes,
                                                             path).shape
            cut = slice(1, None) if j is not None else slice(None)
            assert got_axes[name] == want_axes[cut], name
            assert tuple(w.shape) == tuple(want_shape[cut]), name
            spec = got_r.spec(got_axes[name], w.shape)
            assert tuple(spec) == _spec_j(want_r, want_axes, want_shape)[
                cut], (name, mesh, override)
            z = zero1_spec(spec, tuple(w.shape), got_r)
            assert specs[name] == z
            assert tuple(z) == tuple(zero1_spec_j(PJ(*spec), tuple(w.shape),
                                                  want_r)), (name, mesh)
            if j is not None and override is None:
                stacked = tuple(zero1_spec_j(want_r.spec(want_axes,
                                                         want_shape),
                                             tuple(want_shape), want_r))
                if stacked[:1] != (None,) and stacked[:1] != ():
                    layer_dim.setdefault((arch, mesh), {})[path] = (
                        tuple(want_shape), stacked, tuple(z))
                else:
                    assert stacked[1:] == tuple(z), (name, mesh)
    assert layer_dim == {k: v for k, v in LAYER_DIM_ZERO1.items()
                         if k[0] == arch}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_and_specs_equal_reference(arch):
    """Every leaf of ``init_cache`` (built on ``meta``): each stack's
    layers are the reference's cache leaves of those layers (``layers.b{j}``
    stacked, ``lead_{i}``, ``tail_{i}``), with one layer's axes and spec
    equal to theirs, at a decode batch and at batch 1 with a long cache."""
    cfg, cfg_j = get_config(arch), get_config_j(arch)
    ca = cache_axes(cfg)
    kinds = [s for s, _ in _slots(cfg)]
    for B, length in ((128, 4096), (1, 32768)):
        shapes, axes = abstract_cache(cfg_j, B, length)
        leaves = cache_leaves(init_cache(cfg, B, length, device="meta"))
        assert sorted(leaves) == sorted(ca)
        for name in ca:
            stack = name.split(".")[0] if "." in name else kinds[0]
            field = name.split(".")[-1]
            layers = [i for i, s in enumerate(kinds)
                      if s == stack or stack == "cross"]
            assert leaves[name].shape[0] == len(layers)
            assert ca[name][0] is None
            for layer in layers:
                path, g = reference_slot(cfg, layer)
                ref_axes = getattr(_leaf(axes, path)[stack], field)
                ref_shape = getattr(_leaf(shapes, path)[stack], field).shape
                cut = slice(1, None) if g is not None else slice(None)
                assert ca[name][1:] == ref_axes[cut], (name, path)
                assert tuple(leaves[name].shape[1:]) == tuple(
                    ref_shape[cut]), (name, path)
                for sizes in MESHES.values():
                    got_r, want_r = _rules(sizes)
                    spec = tuple(got_r.spec(ca[name], leaves[name].shape))
                    want = _spec_j(want_r, ref_axes, ref_shape)
                    assert spec[1:] == want[cut], (name, path, sizes)


def test_production_meshes(monkeypatch):
    """The reference's shapes and axis names, built from CUDA devices
    (``torch.device`` objects only: nothing touches a card); fewer devices
    raise, an unknown name is a KeyError."""
    with pytest.raises(KeyError):
        make_mesh_named("three_pods")
    with pytest.raises(RuntimeError, match="need 256 devices .* 14b.9"):
        make_mesh_named("single")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 511)
    with pytest.raises(RuntimeError, match="need 512 devices .* have 511"):
        make_production_mesh(multi_pod=True)
    for names, shape, axes in (
            (("single", "single_pod", "pod"), (16, 16), ("data", "model")),
            (("multi", "multi_pod", "2pod"), (2, 16, 16),
             ("pod", "data", "model"))):
        if len(shape) == 3:
            monkeypatch.setattr(torch.cuda, "device_count", lambda: 512)
        for name in names:
            mesh = make_mesh_named(name)
            assert mesh.devices.shape == shape and mesh.axis_names == axes
            assert mesh.devices.flat[-1] == torch.device(
                "cuda", int(np.prod(shape)) - 1)
            assert AxisRules(mesh).axis_sizes == dict(zip(axes, shape))

"""``repro_torch.launch.specs`` against the reference's
``repro.launch.specs`` on the CPU.

- ``CELL_PRESETS`` and ``cell_rules`` equal the reference's for every
  (arch, shape).
- ``input_specs``' shapes, dtypes and specs equal the reference's
  ``ShapeDtypeStruct``\\ s and their ``NamedSharding`` specs under both
  production meshes (the reference's mesh built from the one CPU device
  repeated: its specs need the mesh's axes and sizes, not its devices).
- In ``build_cell`` (over a fake process group of 512 ranks), each leaf's
  local shard has the shape the reference's resolver implies for it: the
  serving weights at the plain specs (prefill), the float32 masters and
  moments at the ZeRO-1 specs (train), the decode cache at its specs,
  for one arch of each family.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import numpy as np

from repro.configs import ARCH_IDS
from repro.configs import SHAPES as SHAPES_J
from repro.configs import get_config as get_config_j
from repro.launch.specs import CELL_PRESETS as CELL_PRESETS_J
from repro.launch.specs import cell_rules as cell_rules_j
from repro.launch.specs import input_specs as input_specs_j
from repro.parallel.sharding import AxisRules as AxisRulesJ
from repro.train.optimizer import zero1_spec as zero1_spec_j
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.specs import (CELL_PRESETS, build_cell, cell_rules,
                                      input_specs)
from repro_torch.models.model import cache_axes, cache_leaves, param_axes
from repro_torch.parallel import AxisRules

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
#: one arch of each family of the registry
FAMILIES = ("mistral-nemo-12b", "deepseek-v2-lite-16b", "mamba2-370m",
            "recurrentgemma-9b", "whisper-tiny", "pixtral-12b")


def _mesh_j(name):
    shape, axes = MESHES[name]
    devs = np.array([jax.devices()[0]] * int(np.prod(shape)))
    return jax.sharding.Mesh(devs.reshape(shape), axes)


def _rules(name, override):
    shape, axes = MESHES[name]
    r = AxisRules(None, override)
    r.axis_sizes = dict(zip(axes, shape))
    return r


def test_presets_and_cell_rules_equal_the_reference():
    assert CELL_PRESETS == CELL_PRESETS_J
    for arch in ARCH_IDS:
        for s in SHAPES:
            assert cell_rules(SHAPES[s], arch) == \
                cell_rules_j(SHAPES_J[s], arch), (arch, s)
    assert cell_rules(SHAPES["decode_32k"]) == \
        cell_rules_j(SHAPES_J["decode_32k"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_input_specs_equal_the_reference(mesh):
    mesh_j = _mesh_j(mesh)
    for arch in ARCH_IDS:
        for s in SHAPES:
            over = cell_rules(SHAPES[s], arch)
            want = input_specs_j(get_config_j(arch), SHAPES_J[s],
                                 AxisRulesJ(mesh_j, over))
            got = input_specs(get_config(arch), SHAPES[s],
                              _rules(mesh, over))
            assert list(got) == list(want), (arch, s)
            for k, w in want.items():
                g = got[k]
                assert g.shape == tuple(w.shape), (arch, s, k)
                assert str(g.dtype) == f"torch.{w.dtype}", (arch, s, k)
                ws = None if w.sharding is None else tuple(w.sharding.spec)
                assert (None if g.spec is None else tuple(g.spec)) == ws, \
                    (arch, s, k, g.spec, ws)


def _local(shape, spec, sizes):
    out = list(shape)
    for i, e in enumerate(tuple(spec)):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                out[i] //= sizes[a]
    return tuple(out)


@pytest.mark.parametrize("arch", FAMILIES)
def test_build_cell_local_shards_follow_the_reference_specs(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_mesh_named
    from repro_torch.launch.program_stats import fake_safe_dtensor
    from repro_torch.parallel import axis_rules

    shape, axes = MESHES["multi"]
    sizes = dict(zip(axes, shape))
    mesh = make_mesh_named("multi", fake=True)
    try:
        for s in ("prefill_32k", "train_4k", "decode_32k"):
            over = cell_rules(SHAPES[s], arch)
            rj = AxisRulesJ(None, over)
            rj.axis_sizes = dict(sizes)
            with axis_rules(mesh, over) as rules, fake_safe_dtensor(), \
                    FakeTensorMode(allow_non_fake_inputs=True):
                cell = build_cell(arch, s, rules)
                if s == "train_4k":
                    state = cell.args[0]
                    leaf_axes = param_axes(cell.cfg, cell.fn.model)
                    for tree in (state.params, state.m, state.v):
                        for k, t in tree.items():
                            spec = zero1_spec_j(
                                rj.spec(leaf_axes[k], t.shape),
                                tuple(t.shape), rj)
                            assert t.dtype == torch.float32
                            assert tuple(t.to_local().shape) == _local(
                                t.shape, spec, sizes), (s, k, spec)
                    continue
                model = cell.args[0]
                leaf_axes = param_axes(cell.cfg, model)
                leaves = dict(model.named_parameters())
                if s == "decode_32k":
                    leaf_axes = cache_axes(cell.cfg)
                    leaves = cache_leaves(cell.args[1])
                for k, t in leaves.items():
                    spec = rj.spec(leaf_axes[k], t.shape)
                    assert tuple(t.to_local().shape) == _local(
                        t.shape, spec, sizes), (s, k, spec)
    finally:
        torch.distributed.destroy_process_group()

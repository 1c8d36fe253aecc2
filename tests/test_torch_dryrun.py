"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

- The smoke twin of ``mistral-nemo-12b`` as a train, a prefill and a
  decode cell (at small shapes, batch 32) runs once over fake process
  groups of 256 and 512 ranks (the two production meshes) and records
  ``ok`` with the reference's record fields.
- Per-device dot flops of the dense (``mistral-nemo-12b``) and MoE + MLA
  (``deepseek-v2-lite-16b``) smoke train and prefill programs on a (2, 2)
  data x model mesh equal the reference's ``analyze_hlo`` of the same
  programs within 10 % (``tools/dryrun_flops.py``; the reference compiles
  in a subprocess with 4 host devices, as ``tests/test_pool_scaling.py``
  runs its mesh). Their collective bytes by kind part (DTensor's
  collectives are not XLA's) and are not bound here (``PERF.md`` §6).
- A leaf sharded over two mesh axes, ("pod", "data"), holds on each rank
  the rows the reference's ``NamedSharding`` gives that device.
"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import dryrun_flops  # noqa: E402

from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.launch.dryrun import run_cell  # noqa: E402

#: the reference's record fields the port fills (xla_*_raw and the
#: generated code size have no counterpart: program_stats' docstring)
FIELDS = ("dot_flops", "dot_bytes", "collective_bytes", "collective_counts",
          "collective_total", "argument_size_in_bytes",
          "output_size_in_bytes", "temp_size_in_bytes", "n_params",
          "n_active_params", "devices")
FLOP_CASES = tuple(dryrun_flops.CASES)


#: the cells' kinds at small shapes, which keep the runs short
SMOKE_SHAPES = {"train": ShapeSpec("train_small", 64, 32, "train"),
                "prefill": ShapeSpec("prefill_small", 128, 32, "prefill"),
                "decode": ShapeSpec("decode_small", 128, 32, "decode")}


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
def test_smoke_cells_record_ok_on_both_meshes(kind):
    for mesh, n in (("single", 256), ("multi", 512)):
        rec = run_cell("mistral-nemo-12b@smoke", SMOKE_SHAPES[kind], mesh)
        assert rec["status"] == "ok", rec
        assert rec["devices"] == n
        for f in FIELDS:
            assert f in rec, f
        assert rec["dot_flops"] > 0 and rec["argument_size_in_bytes"] > 0
        assert "xla_flops_raw" not in rec


@pytest.fixture(scope="module", autouse=True)
def _reference_proc():
    """The reference's compile, started with the module (it runs beside
    the smoke cells, in its own process)."""
    proc = dryrun_flops.start_reference(dryrun_flops.CASES,
                                        index_shape=[12, 3])
    yield proc
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def reference(_reference_proc):
    return dryrun_flops.reference_result(_reference_proc)


@pytest.mark.parametrize("case", FLOP_CASES)
def test_dot_flops_match_the_reference(reference, case):
    port = dryrun_flops.port_flops({case: dryrun_flops.CASES[case]})
    assert abs(port[case] / reference[case] - 1.0) <= 0.10, \
        (case, port[case], reference[case])


def test_multi_axis_leaf_slices_match_the_reference(reference):
    """Rank r of a (2, 2) mesh ("pod", "data") holds rows
    [3r, 3r + 3) of a [12, 3] leaf at P(("pod", "data"), None), the
    device at flat position r in the reference's mesh the same rows."""
    from repro_torch.launch.mesh import init_fake_process_group
    from repro_torch.parallel.sharding import (Mesh, P, axis_rules,
                                               distribute)
    import torch.distributed as dist

    whole = torch.arange(36.0).reshape(12, 3)
    mesh = Mesh(np.full((2, 2), "cpu", dtype=object), ("pod", "data"))
    got = []
    for rank in range(4):
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=4)
        try:
            with axis_rules(mesh) as r:
                t = distribute(whole, None, r, spec=P(("pod", "data")))
                rows = t.to_local()[:, 0] // 3
                got.append([int(rows[0]), int(rows[-1]) + 1])
        finally:
            dist.destroy_process_group()
    assert init_fake_process_group  # the dry run's own initializer exists
    assert got == reference["indices"], (got, reference["indices"])

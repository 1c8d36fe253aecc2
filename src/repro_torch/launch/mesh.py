"""Production meshes (``repro.launch.mesh``).

Functions, never module-level constants: importing this module touches no
device. Shapes and axis names are the reference's:

- single pod: (16, 16) = 256 devices, axes (data, model);
- multi pod: (2, 16, 16) = 512 devices, axes (pod, data, model).

``pod`` and ``data`` carry data parallelism (the batch shards over both),
``model`` tensor and expert parallelism; ``pod`` is the slow inter-pod hop
that gradient compression (``repro_torch.parallel.collectives``) targets.
The meshes are built from the process's CUDA devices as the port's
:class:`~repro_torch.parallel.sharding.Mesh`; with fewer devices they
raise. ``fake=True`` builds the same mesh over a fake process group of 256
or 512 ranks instead (``torch.distributed``'s ``fake`` backend, this
process rank 0; collectives return without moving anything), on CPU
devices: the sharded LM program's dry run (``launch.dryrun``), the
counterpart of the reference's 512 forced host devices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel.sharding import Mesh

__all__ = ["make_production_mesh", "make_mesh_named",
           "init_fake_process_group"]


def init_fake_process_group(n: int) -> None:
    """Make the default process group a fake one of ``n`` ranks (this
    process rank 0), unless one of that size is already there; another
    size raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is initialized; the mesh needs {n}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_production_mesh(*, multi_pod: bool = False,
                         fake: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if fake:
        init_fake_process_group(n)
        return Mesh(np.full(shape, "cpu", dtype=object), axes)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} devices for the production mesh, have {have} CUDA "
            "devices; fake=True builds it over a fake process group of "
            "that many ranks, the sharded LM program's dry run (ROADMAP "
            "item 14b.9)")
    devs = np.empty(n, dtype=object)
    for i in range(n):
        devs[i] = torch.device("cuda", i)
    return Mesh(devs.reshape(shape), axes)


def make_mesh_named(name: str, fake: bool = False) -> Mesh:
    if name in ("single", "single_pod", "pod"):
        return make_production_mesh(multi_pod=False, fake=fake)
    if name in ("multi", "multi_pod", "2pod"):
        return make_production_mesh(multi_pod=True, fake=fake)
    raise KeyError(name)
